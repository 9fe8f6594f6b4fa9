"""``present.u8_host_ms``: ``spans.host_ms``."""

from renderbench import spans

read = spans.host_ms("Renderer.present.u8")
