"""``pass_ms.MaterialResolve.clip``: ``readers.pass_ms``."""

from renderbench import readers

read = readers.pass_ms("MaterialResolve")
