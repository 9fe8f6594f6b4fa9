"""``pass_ms.MaterialResolve``: ``readers.pass_ms``."""

from renderbench import readers

read = readers.pass_ms("MaterialResolve")
