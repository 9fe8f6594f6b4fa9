"""``clip_frame_ms``: ``readers.frame_ms``."""

from renderbench import readers

read = readers.frame_ms
