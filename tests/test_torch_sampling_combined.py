"""The three non-default sampling and storage settings together
(``lod_derivatives="forward"``, ``soa_vertex=False``,
``shadow_table_u16=False``) in the deferred frame over 2 carried 128x128
frames (the second culls against the first's HZB) and in one forward frame
(it carries nothing), against the reference's frames (Pallas, interpret
mode), at the bar of ``tests/test_torch_sampling_frame.py``."""

import pytest
from test_torch_sampling_frame import ALL_THREE, frame_case
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module


@pytest.mark.parametrize("frame", ["deferred", "forward"])
def test_all_three_settings_match_reference(frame):
    frame_case("rich", frame, frames=2 if frame == "deferred" else 1, **ALL_THREE)
