"""The benchmark of ``unclerenderer_tpu_torch``: one cell of
``BENCHMARK.json``, one run.

    python3 renderbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run writes the seed's scene into a temporary directory (under
``$TMPDIR``), builds the port's ``Renderer`` on the card from it with the
scene cache off, warms up (the first frame op by op, the second captures
the frame program), then runs the cell's traffic for ``--seconds`` and
prints one JSON line: ``correct``, ``attempted`` (frames presented),
``failed`` (frames with a drop counter set or a colour not finite),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; its last key,
``check``, gives each number compared with the reference beside its
limit, and the same lines close standard error.

Everything a cell is made of is found by name: the configuration in
``configs/<config>.json``, the traffic in ``traffic/<traffic>.json`` (read
by ``traffic.py``), each metric, end to end or per layer, in
``metrics/<name>.py``, whose ``read(ctx)`` returns a number or None (then
the metric is left out; ``readers.py`` holds the arithmetic), and the
reference in ``reference/<name>.py``, the name a configuration gives
under ``"reference"`` (default ``frames``).  A metric module may name
program functions in ``CALLS``; the traced run records their calls in the
profiled op-by-op frames for it.

A run whose configuration or traffic asks for a setting the reference does
not draw (its ``DRAWS``) is refused before anything is written or built:
one line on standard error names the key and the value, and the command
exits 4.

``correct`` compares frames the timed path presented with the reference,
an independent float64 renderer of the generator's scene data
(``check.py``): the reference carries its own frame state from
the first frame through set-up to a position early in the window (its
frames and the program's frame state there compared), and renders runs
from positions spread over the whole window from the program's frame
state captured just before them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from renderbench import check, scenegen, trace  # noqa: E402
from renderbench.traffic import Traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "unclerenderer_tpu")
PROFILED_STEPS_FRAMES = 20  # frames of the traced window through the cell's own entry
EAGER_FRAMES = 3  # op-by-op frames profiled for the per-pass and kernel readings
STATE_FIELDS = ("taa_history", "taa_valid", "exposure_ev", "exposure_valid")
CACHE = ROOT / ".renderbench-cache"  # scenes and scene cache of cells that keep them


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str, overrides: dict | None = None
               ) -> tuple[dict, dict, dict]:
    """(the cell, its configuration, its traffic), each found by name;
    ``overrides`` (tests) replaces values of the configuration's ``scene``
    and ``render_settings``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    for key in ("scene", "render_settings"):
        config[key].update({k: v for k, v in (overrides or {}).items() if k in config[key]})
    return cell, config, traffic


class Refused(ValueError):
    """A cell asks for a setting its reference does not draw."""


def reference_module(config: dict, directory: Path = HERE / "reference"):
    """The reference that ``config`` names (``"reference"``, default
    ``"frames"``): ``<directory>/<name>.py``, loaded from its file as a
    module of ``renderbench.reference``; it exports ``ReferenceScene`` and
    ``DRAWS``."""
    name = config.get("reference", "frames")
    path = directory / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config['name']!r} names the reference "
                                f"{name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"renderbench.reference.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up while it loads
    spec.loader.exec_module(mod)
    return mod


def _same(value, default) -> bool:
    """A JSON value against the program's default (a JSON list is a tuple)."""
    return (tuple(value) if isinstance(value, list) else value) == default


def refusal(config: dict, traffic: dict, draws: dict) -> str | None:
    """Why the reference's ``draws`` cannot judge the cell of ``config`` and
    ``traffic``: the first key of the configuration's ``render_settings``
    or ``renderer_config``, or of a value of the traffic's
    ``settings_cycle``, set to a value that ``draws`` does not allow for
    it, or, where ``draws`` does not name it, to another value than the
    program's default; None where it can."""
    from unclerenderer_tpu_torch.core.config import RendererConfig
    from unclerenderer_tpu_torch.render.params import RenderSettings

    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    settings = defaults(RenderSettings)
    places = [("render_settings", config.get("render_settings", {}), settings),
              ("renderer_config", config.get("renderer_config", {}), defaults(RendererConfig))]
    places += [("settings_cycle", v, settings)
               for v in (traffic.get("settings_cycle") or {}).get("values", [])]
    for place, values, default in places:
        for key, value in values.items():
            allowed = draws[place].get(key)
            if allowed is not None and allowed(value):
                continue
            if allowed is None and key in default and _same(value, default[key]):
                continue
            return (f"renderbench: the reference {config.get('reference', 'frames')!r} does "
                    f"not draw {place} {key}={json.dumps(value)}")
    return None


def checked_reference(config: dict, traffic: dict):
    """The configuration's reference module, or ``Refused`` where it cannot
    judge the cell."""
    ref = reference_module(config)
    why = refusal(config, traffic, ref.DRAWS)
    if why:
        raise Refused(why)
    return ref


def metric_module(name: str):
    """``metrics/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"renderbench_metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, key: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [e for e in bench[key] if workload in e.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bad_frames(renderer, traffic: Traffic, device) -> torch.Tensor:
    """The step's frames with a drop counter set or a colour not finite, as
    a device count (read once, after the window)."""
    if traffic.mode == "present":
        out = renderer._last_out
        stats = torch.stack([v.reshape(()).to(torch.int64) for v in out["raster_stats"].values()])
        bad = (stats != 0).any() | ~torch.isfinite(out["color"]).all()
        return bad.to(torch.int64) + int(renderer._shadow_overflow > 0)
    drops = renderer._chain_drop_counters
    stats = torch.stack([v.reshape(()).to(torch.int64) for v in drops.values()])
    return (stats != 0).any().to(torch.int64) * traffic.clip


class Recorder:
    """The traced window's readings, taken from the benchmark's side of
    each call into the program: host ms and CUDA-event device ms of each
    ``render_frame`` (or ``render_frames``) call, and device ms of each
    ``ShadowProgram.run``."""

    def __init__(self, renderer, traffic: Traffic, device):
        from unclerenderer_tpu_torch.render import program

        self.renderer, self.device, self.program = renderer, device, program
        self.calls, self.maps = [], []  # (host s, start event, end event, frames)
        self.entry = "render_frame" if traffic.mode == "present" else "render_frames"
        self.frames = traffic.clip
        self._orig_entry = getattr(renderer, self.entry)
        self._orig_map = program.ShadowProgram.run

    def _events(self):
        """A pair of timing events on the card; none on the CPU, which
        times no device."""
        if self.device.type != "cuda":
            return _NoEvent(), _NoEvent()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        rec, entry, run_map = self, self._orig_entry, self._orig_map

        def timed_entry(*args, **kwargs):
            a, b = rec._events()
            t = time.perf_counter()
            a.record()
            out = entry(*args, **kwargs)
            b.record()
            rec.calls.append((time.perf_counter() - t, a, b, rec.frames))
            return out

        def timed_map(prog_self):
            a, b = rec._events()
            a.record()
            out = run_map(prog_self)
            b.record()
            rec.maps.append((a, b))
            return out

        setattr(self.renderer, self.entry, timed_entry)
        self.program.ShadowProgram.run = timed_map
        return self

    def __exit__(self, *exc):
        delattr(self.renderer, self.entry)
        self.program.ShadowProgram.run = self._orig_map

    def readings(self) -> dict:
        _sync(self.device)
        timed = self.device.type == "cuda"
        return {
            "call_host_ms": [h * 1e3 / f for h, _a, _b, f in self.calls],
            "frame_device_ms": [a.elapsed_time(b) / f for _h, a, b, f in self.calls] if timed
            else [],
            "map_device_ms": [a.elapsed_time(b) for a, b in self.maps] if timed else [],
        }


class _NoEvent:
    def record(self) -> None:
        pass


def _profile(fn, tmp: Path, name: str, device) -> list:
    """Run ``fn`` under ``torch.profiler`` inside a ``name`` range; the
    trace's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(name):
            fn()
        _sync(device)
    path = tmp / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = trace.load(path)
    path.unlink()
    return events


def traced_phases(renderer, traffic: Traffic, n: int, device, tmp: Path, modules: dict,
                  window: dict) -> tuple[dict, int, dict, dict]:
    """After the window: ``PROFILED_STEPS_FRAMES`` frames through the cell's
    entry, profiled (busy union, idle gaps, top operations), then
    ``EAGER_FRAMES`` op-by-op frames, profiled with the calls that the
    metric modules name recorded.  Returns (ctx, next frame, device
    extras, breakdown)."""
    from unclerenderer_tpu_torch.render import program

    # CUPTI kept alive across the two traces: on the card's machine a trace
    # after another one's teardown may record none of its device rows
    os.environ["TEARDOWN_CUPTI"] = "0"
    steps = max(PROFILED_STEPS_FRAMES // traffic.clip, 1)
    start = n

    def run_steps():
        nonlocal n
        for _ in range(steps):
            n += len(traffic.step(renderer, n))

    events = _profile(run_steps, tmp, "renderbench.window", device)
    rows = trace.device_rows(events)
    marks = [e for e in events if e.get("name") == "renderbench.window" and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    rows = [r for r in rows if r[1] > t0 and r[0] < t1]
    busy = trace.busy_union([(max(a, t0), min(b, t1), nm) for a, b, nm in rows])
    gaps = sorted(trace.idle_gaps(rows, t0, t1), key=lambda g: -g[1])[:10]
    tid = marks[0].get("tid")
    breakdown = {"device_ops": trace.top_ops(rows),
                 "idle_gaps": [[trace.host_label(events, s + d / 2, tid), d / 1e6]
                               for s, d in gaps]}
    frames_ctx = {"events": events, "rows": rows, "busy_us": busy, "span_us": t1 - t0,
                  "frames": n - start}

    # the op-by-op frames, with the named calls recorded
    calls = {}
    originals = []
    for mod in modules.values():
        for label, (mod_path, fn_name) in getattr(mod, "CALLS", {}).items():
            owner = importlib.import_module(mod_path)
            fn = getattr(owner, fn_name)
            calls.setdefault(label, [])

            def recorder(*args, _fn=fn, _label=label, **kwargs):
                calls[_label].append((args, kwargs))
                return _fn(*args, **kwargs)

            originals.append((owner, fn_name, fn))
            setattr(owner, fn_name, recorder)
    first_eager = n

    def run_eager():
        nonlocal n
        with program.eager():
            for _ in range(EAGER_FRAMES):
                traffic.apply(renderer, n)
                renderer.render_frame()
                n += 1

    try:
        eager_events = _profile(run_eager, tmp, "renderbench.eager", device)
    finally:
        for owner, fn_name, fn in originals:
            setattr(owner, fn_name, fn)
    ctx = {"window": window, "frames": frames_ctx,
           "eager": {"events": eager_events, "frames": n - first_eager, "calls": calls}}
    extras = {"busy_s": busy / 1e6, "window_s": (t1 - t0) / 1e6}
    return ctx, n, extras, breakdown


def compare_with_reference(content: dict, config: dict, traffic: Traffic, kept: dict,
                           plan: dict, device) -> tuple[bool, dict, dict]:
    """The configuration's reference's frames at every kept position:
    carried from the initial state through ``plan["carry"]`` frames (the
    program's state snapshot at the last of them compared too), and each
    sampled run from its snapshot (``plan["runs"]``: (first frame, count,
    snapshot)).  Returns (correct, the held readings beside their limits,
    every reading)."""
    ref = checked_reference(config, traffic.spec).ReferenceScene(
        content, config["render_settings"], config.get("renderer_config", {}), device)
    n_models = ref.scene.n_models
    pairs, due, state_pair = [], 0, None

    def render(k, state):
        return ref.frame(k, traffic.view(k), state, traffic.settings(k),
                         traffic.visible(k, n_models), traffic.settings_changed(k))

    state = ref.initial_state()
    carry_to, carry_due, snap = plan["carry"]
    for k in range(carry_to):
        if k == plan["carry_at"] and snap is not None:
            state_pair = (ref.state_from_program(snap), state)
        img, state = render(k, state)
        if k in carry_due:
            due += 1
            if k in kept:
                pairs.append((kept[k], img))
    for first, count, snap in plan["runs"]:
        state = ref.state_from_program(snap)
        for k in range(first, first + count):
            due += 1
            img, state = render(k, state)
            if k in kept:
                pairs.append((kept[k], img))
    values = check.readings(pairs, n_models)
    if state_pair is not None:
        values.update(check.state_readings(*state_pair))
    return (*check.verdict(values, config["check"], due, len(pairs)), values)


def _scene(config: dict, spec: dict, seed: int, tmp: Path) -> Path:
    """Write the seed's scene: into ``tmp`` with the scene cache off, or,
    where the traffic keeps the scene cache, into a fixed directory of the
    checkout (once) with the cache beside it."""
    if not spec.get("scene_cache"):
        os.environ["UNCLERENDERER_SCENE_CACHE"] = ""
        return scenegen.write_scene(tmp / "scene", seed=seed, **config["scene"])
    os.environ["UNCLERENDERER_SCENE_CACHE"] = str(CACHE / "scenecache")
    root = CACHE / f"scene-{config['name']}-{seed}"
    path = root / "Scenes" / "scene.json"
    if not path.exists():
        scenegen.write_scene(root, seed=seed, **config["scene"])
    return path


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace_on: bool,
             device="cuda", overrides: dict | None = None, t0: float = T0) -> dict:
    """One run of ``workload``: the result line's object (``overrides``:
    ``cell_files``)."""
    device = torch.device(device)
    _cell, config, spec = cell_files(bench, workload, overrides)
    checked_reference(config, spec)
    key = "per_layer" if trace_on else "end_to_end"
    modules = {m["name"]: metric_module(m["name"]) for m in cell_metrics(bench, key, workload)}
    chk = spec["check"]
    with tempfile.TemporaryDirectory(prefix="renderbench-") as tmp_name:
        tmp = Path(tmp_name)
        t_write = time.perf_counter()
        scene_json = _scene(config, spec, seed, tmp)
        from unclerenderer_tpu_torch.core.config import RendererConfig
        from unclerenderer_tpu_torch.render.params import RenderSettings
        from unclerenderer_tpu_torch.render.renderer import Renderer

        t_init = time.perf_counter()
        renderer = Renderer(scene_json, settings=RenderSettings(**config["render_settings"]),
                            config=RendererConfig(**config.get("renderer_config", {})),
                            device=device)
        traffic = Traffic(spec, scene_json, seed)
        carry, fractions = traffic.draw_checks()
        carry_at = spec["warmup_frames"] + carry
        run_frames = chk["run_frames"]
        carry_due = set(range(chk["start_frames"])) | set(range(carry_at, carry_at + run_frames))
        due = set(carry_due)
        kept, snaps, runs = {}, {}, []

        def take(n, frames):
            for i, img in enumerate(frames):
                if n + i in due:
                    kept[n + i] = img if img.dtype == np.uint8 else check.to_u8(img)

        def snapshot():
            return {f: getattr(renderer.frame_state, f).clone() for f in STATE_FIELDS}

        t_warm = time.perf_counter()
        n = 0
        bad = torch.zeros((), dtype=torch.int64, device=device)
        while n < spec["warmup_frames"]:
            frames = traffic.step(renderer, n)
            bad += _bad_frames(renderer, traffic, device)
            take(n, frames)
            n += len(frames)
        _sync(device)
        setup_s = time.perf_counter() - t0
        print(f"renderbench: setup {setup_s:.2f} s: before the scene {t_write - t0:.2f}, scene "
              f"files {t_init - t_write:.2f}, Renderer {t_warm - t_init:.2f} "
              f"{renderer.setup_phase_s}, warm-up frames {time.perf_counter() - t_warm:.2f}",
              file=sys.stderr)

        recorder = Recorder(renderer, traffic, device) if trace_on else None
        presents, counts = [], []
        attempted = 0
        with recorder or contextlib.nullcontext():
            t_start = time.perf_counter()
            while True:
                if n == carry_at:
                    snaps[n] = snapshot()
                elif fractions and n > carry_at and \
                        time.perf_counter() - t_start >= fractions[0] * seconds:
                    fractions.pop(0)
                    runs.append((n, run_frames, snapshot()))
                    due.update(range(n, n + run_frames))
                frames = traffic.step(renderer, n)
                presents.append(time.perf_counter())
                counts.append(len(frames))
                bad += _bad_frames(renderer, traffic, device)
                take(n, frames)
                n += len(frames)
                attempted += len(frames)
                if presents[-1] - t_start >= seconds and n >= carry_at + run_frames:
                    break
        failed = int(bad)
        # a sampled run is due as far as the window rendered it
        runs = [(s, min(c, n - s), sn) for s, c, sn in runs]
        peak = (torch.cuda.max_memory_reserved(device) if device.type == "cuda"
                else 0)
        metrics, extras, breakdown = {}, {}, None
        if trace_on:
            window = recorder.readings()
            ctx, n, extras, breakdown = traced_phases(renderer, traffic, n, device, tmp,
                                                      modules, window)
        else:
            ctx = {"timeline": {"t_start": t_start, "presents": presents, "frames": counts},
                   "peak_bytes": peak, "setup_s": setup_s}
        for name, mod in modules.items():
            entry = next(m for m in bench[key] if m["name"] == name)
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": entry["unit"]}
        del renderer
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        content = scenegen.scene_content(seed=seed, **config["scene"])
        plan = {"carry": (carry_at + run_frames, carry_due, snaps.get(carry_at)),
                "carry_at": carry_at, "runs": runs}
        correct, shown, values = compare_with_reference(content, config, traffic, kept, plan,
                                                        device)
        print(f"renderbench: reference {time.perf_counter() - t_ref:.2f} s over "
              f"{carry_at + run_frames + sum(c for _s, c, _sn in runs)} frames; "
              f"readings {values}", file=sys.stderr)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **extras}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = values
    result["check"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell, config, traffic = cell_files(bench, args.workload)
    try:
        checked_reference(config, traffic)
    except Refused as e:
        print(e, file=sys.stderr)
        return 4
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"renderbench: needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"renderbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
