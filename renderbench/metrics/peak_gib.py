"""``peak_gib``: ``readers.peak_gib``."""

from renderbench import readers

read = readers.peak_gib
