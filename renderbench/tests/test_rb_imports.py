"""What the benchmark's processes load: run.py's modules, the metric
readers and the reference bring no JAX and no module of the JAX package;
the reference brings no module of the port either.  Top-level names are
compared whole (``unclerenderer_tpu_torch`` is not ``unclerenderer_tpu``)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "unclerenderer_tpu"}


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax():
    names = _top_level(
        "import sys; sys.path.insert(0, '.')\n"
        "from renderbench import run, control\n"
        "import unclerenderer_tpu_torch.render.renderer, unclerenderer_tpu_torch.render.program\n"
        "import unclerenderer_tpu_torch.core.config, unclerenderer_tpu_torch.ops.raster_kernels\n"
        "from renderbench.reference import frames\n"
        "bench = run.load_bench()\n"
        "for m in bench['per_layer'] + bench['end_to_end']:\n"
        "    run.metric_module(m['name'])\n")
    assert "unclerenderer_tpu_torch" in names and "renderbench" in names
    assert not names & JAX


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(
        "import sys; sys.path.insert(0, '.')\n"
        "from renderbench.reference import frames\n"
        "from renderbench import check, scenegen, traffic, roofline, trace, timeline\n")
    assert "renderbench" in names
    assert not names & (JAX | {"unclerenderer_tpu_torch"})


def test_the_run_checks_its_modules_by_whole_names():
    from renderbench import run

    before = dict(sys.modules)
    try:
        sys.modules["unclerenderer_tpu_torchx"] = sys
        assert "unclerenderer_tpu" not in run.forbidden_modules()
        sys.modules["jaxlib.xla_client"] = sys
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        sys.modules.clear()
        sys.modules.update(before)
