"""``program.pass_device_ms.MaterialResolve``: ``spans.replay_ms``, a replay's device ms read
under the profiler (``renderbench/spans.py``)."""

from renderbench import spans

read = spans.replay_ms("FrameProgram", "MaterialResolve")
