"""``renderer.call_host_ms.clip``: ``readers.call_host_ms``."""

from renderbench import readers

read = readers.call_host_ms
