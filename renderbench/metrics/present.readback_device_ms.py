"""``present.readback_device_ms``: ``spans.device_ms_in``."""

from renderbench import spans

read = spans.device_ms_in("Renderer.present.readback")
