"""``program.pass_device_ms.AnisoTaps``: ``spans.replay_ms``, a replay's device ms read
under the profiler (``renderbench/spans.py``), summed over the material slots tapped."""

from renderbench import spans

read = spans.replay_ms("FrameProgram", "AnisoTaps")
