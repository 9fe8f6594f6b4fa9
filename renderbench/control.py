"""The control of the comparison that decides ``correct``: the
configuration's reference (``run.checked_reference``, which refuses a cell
it does not draw) put in the program's place with the scene's vertex
inputs (positions, normals, tangents, texture coordinates) rounded to
bfloat16 -- the step a later change would take to halve the vertex
stage's bytes -- against the float64 reference, over the frames a run carries from the initial state
(set-up's first frames and the carried run early in the window, drawn
from the seed as a run draws them) and the frame state at the carried
run.  Its readings must exceed the configuration's limits.

    python3 renderbench/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed: the readings and whether they pass.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from renderbench import check, scenegen  # noqa: E402
from renderbench.traffic import Traffic  # noqa: E402


def control_readings(bench: dict, workload: str, seed: int, device="cuda",
                     overrides: dict | None = None) -> dict:
    """The control's readings against the reference on ``workload``'s
    configuration and traffic for ``seed``, and the verdict under the
    configuration's limits."""
    from renderbench import run

    _cell, config, spec = run.cell_files(bench, workload, overrides)
    reference = run.checked_reference(config, spec)
    chk = spec["check"]
    with tempfile.TemporaryDirectory(prefix="renderbench-control-") as tmp:
        scene_json = scenegen.write_scene(Path(tmp) / "scene", seed=seed, **config["scene"])
        traffic = Traffic(spec, scene_json, seed)
    carry, _fractions = traffic.draw_checks()
    carry_at = spec["warmup_frames"] + carry
    due = sorted(set(range(chk["start_frames"]))
                 | set(range(carry_at, carry_at + chk["run_frames"])))
    content = scenegen.scene_content(seed=seed, **config["scene"])
    sides = {}
    for label, bf16 in (("reference", False), ("control", True)):
        ref = reference.ReferenceScene(content, config["render_settings"],
                                       config.get("renderer_config", {}), device,
                                       bf16_vertices=bf16)
        n_models = ref.scene.n_models
        state, out, at = ref.initial_state(), {}, None
        for k in range(carry_at + chk["run_frames"]):
            if k == carry_at:
                at = state
            out[k], state = ref.frame(k, traffic.view(k), state, traffic.settings(k),
                                      traffic.visible(k, n_models), traffic.settings_changed(k))
        sides[label] = ({k: out[k] for k in due}, at)
        del ref, state
    values = check.readings([(sides["control"][0][k], sides["reference"][0][k]) for k in due],
                            n_models)
    values.update(check.state_readings(sides["control"][1], sides["reference"][1]))
    correct, shown = check.verdict(values, config["check"], len(due), len(due))
    return {"seed": seed, "readings": values, "passes": correct, "check": shown}


def main(argv=None) -> int:
    from renderbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = run.load_bench()
    for seed in args.seeds:
        try:
            res = control_readings(bench, args.workload, seed)
        except run.Refused as e:
            print(e, file=sys.stderr)
            return 4
        print(json.dumps({"workload": args.workload, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
