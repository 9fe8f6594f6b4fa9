"""``pass_ms.MaskedRaster``: ``readers.pass_ms``."""

from renderbench import readers

read = readers.pass_ms("MaskedRaster")
