"""``renderer.call_host_ms``: ``readers.call_host_ms``."""

from renderbench import readers

read = readers.call_host_ms
