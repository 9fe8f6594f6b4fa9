"""``frame_ms_p95``: ``readers.frame_ms_p95``."""

from renderbench import readers

read = readers.frame_ms_p95
