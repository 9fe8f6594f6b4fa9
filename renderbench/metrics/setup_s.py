"""``setup_s``: ``readers.setup_s``."""

from renderbench import readers

read = readers.setup_s
