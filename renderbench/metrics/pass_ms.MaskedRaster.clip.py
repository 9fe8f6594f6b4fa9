"""``pass_ms.MaskedRaster.clip``: ``readers.pass_ms``."""

from renderbench import readers

read = readers.pass_ms("MaskedRaster")
