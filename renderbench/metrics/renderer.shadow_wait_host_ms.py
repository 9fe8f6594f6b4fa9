"""``renderer.shadow_wait_host_ms``: ``spans.host_ms``."""

from renderbench import spans

read = spans.host_ms("Renderer.shadow.drop_read")
