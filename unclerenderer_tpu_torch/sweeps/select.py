"""The frame's two select kernels: K4 (``csrc/shadow_select9.cu``, the PCF
3x3 fetch) and K8 (``csrc/mat_select.cu``, the packed material decode) at
the inputs that one 1920x1080 frame gives them: K4 from a frame of the
default path (2,073,600 receivers, 4096^2 shadow map), K8 from a frame of
the packed path (2,073,600 pixels of the u8 packed atlas).

Variants, each first held bit-equal to the plain version:

* ``shipped``   -- the kernel wrapper (``ops/shadow.py select9``,
  ``ops/texture.py mat_select``);
* K8 ``T threads a pixel, P pixels a thread, shfl / L1`` -- T in 1, 2, 4
  threads share a pixel's 16 channels; its row index and 7 parameters
  loaded by its lanes in turn and shuffled (shfl), or by every lane (L1);
* K4 ``R receivers a thread, 32-bit / 64-bit`` -- R in 1, 2, 4; a run of 3
  lanes from two aligned 32-bit loads, or one aligned 64-bit load and a
  32-bit one where the run crosses it;
* ``..., streaming`` -- the read-once loads and the output stores marked
  evict-first (``__ldcs`` / ``__stcs``), leaving L2 to the atlas or table.

Besides, K4's output layout together with the PCF tail that reads it
(``ops/shadow.py _pcf_tail``, captured from the same frame): the shipped
(N, 9) rows, whose 9 columns the tail reads with a 36-byte stride, against
(9, N) planes written by a sweep-only kernel (``PLANES``; not shipped: the
reference's ``_select9_fetch`` returns (N, 9)); eager device time from
CUDA events over 20 calls, since the tail cannot be captured in a graph.

The alternatives are template instances of the shipped sources, exported
through C entries appended to them (``VARIANTS``); both sources build
at once through ``_cuda.build_source``.  Device time per call: CUDA graphs
of 10 calls, median of three rounds taken in turns.  ``--ptxas`` first
prints what ``nvcc -Xptxas -v`` says of every instance (registers, spills).
Run from the repository root on a CUDA machine::

    python3 -m unclerenderer_tpu_torch.sweeps.select [--ptxas] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import statistics
import tempfile
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import shadow as shadow_mod
from ..ops import texture as tex_mod
from ..timing import cuda_ms, graph_ms, nvidia_smi
from .raster import ptxas

WIDTH, HEIGHT, SHADOW = 1920, 1080, 4096
ROUNDS, REPS = 3, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory

# a C entry of one template instance, appended to the shipped source
ENTRY_TEXT = {
    "mat_select": """
extern "C" int {entry}(const void* atlas, const int* rows_idx, const float* params, float* out,
                       long long n, int dtype, void* stream) {{
  return launch<U8, {tpp}, {ppt}, {shfl}, {cs}>(atlas, rows_idx, params, out, n,
                                                static_cast<cudaStream_t>(stream));
}}
""",
    "shadow_select9": """
extern "C" int {entry}(const uint16_t* table, const int* row, const int* base, float* out, int n,
                       int lanes, int bw, void* stream) {{
  return launch<{r}, {u64}, {cs}>(table, row, base, out, n, lanes, bw,
                                  static_cast<cudaStream_t>(stream));
}}
""",
}


# a sweep-only K4 that writes (9, N) planes, one receiver a thread (appended
# to the shipped source: it reuses run3)
PLANES = """
namespace {
template <int kBw>
__global__ void __launch_bounds__(kThreads)
select9_planes_kernel(const uint16_t* __restrict__ table, const int* __restrict__ row,
                      const int* __restrict__ base, float* __restrict__ out, int n, int lanes) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t e = static_cast<int64_t>(__ldcs(row + i)) * lanes + __ldcs(base + i);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const uint64_t v = run3<true>(table, e + dy * (kBw + 2));
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      __stcs(out + static_cast<int64_t>(3 * dy + dx) * n + i,
             __uint2float_rn(static_cast<uint32_t>(v >> (16 * dx)) & 0xffffu));
  }
}
}  // namespace

extern "C" int sweep_select9_planes(const uint16_t* table, const int* row, const int* base,
                                    float* out, int n, int lanes, int bw, void* stream) {
  if (bw < 4 || bw > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    auto kernel = bw == 4   ? select9_planes_kernel<4>
                  : bw == 5 ? select9_planes_kernel<5>
                  : bw == 6 ? select9_planes_kernel<6>
                  : bw == 7 ? select9_planes_kernel<7>
                            : select9_planes_kernel<8>;
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, row, base, out, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def _plural(n, word):
    return f"{n} {word}{'s' * (n > 1)}"


def _mat_variant(t, p, s, cs=False):
    label = (f"{_plural(t, 'thread')} a pixel, {_plural(p, 'pixel')} a thread, "
             f"{'shfl' if s else 'L1'}{', streaming' * cs}")
    return label, dict(tpp=t, ppt=p, shfl=str(s).lower(), cs=str(cs).lower())


def _select9_variant(r, u, cs=False):
    label = f"{_plural(r, 'receiver')} a thread, {64 if u else 32}-bit{', streaming' * cs}"
    return label, dict(r=r, u64=str(u).lower(), cs=str(cs).lower())


# kernel -> variant -> the template arguments of its instance (shipped: K8
# 2 threads a pixel, 1 pixel a thread, shfl; K4 2 receivers a thread,
# 64-bit, streaming)
VARIANTS = {
    "mat_select": dict(
        [_mat_variant(t, p, s) for t in (1, 2, 4) for p in (1, 2, 4)
         for s in ((False, True) if t > 1 else (False,))]
        + [_mat_variant(t, p, s, cs=True)
           for t, p, s in ((1, 1, False), (2, 1, True), (2, 1, False), (2, 2, False),
                           (4, 1, True))]),
    "shadow_select9": dict(
        [_select9_variant(r, u) for r in (1, 2, 4) for u in (False, True)]
        + [_select9_variant(r, u, cs=True) for r, u in ((1, False), (2, False), (4, False),
                                                        (2, True))]),
}


def entry_name(kernel: str, label: str) -> str:
    return "sweep_" + "".join(ch if ch.isalnum() else "_" for ch in f"{kernel} {label}")


def variant_sources() -> dict:
    """Library name -> source text: each kernel's shipped source with the C
    entry of every variant appended."""
    out = {}
    for name, variants in VARIANTS.items():
        text = (_cuda.CSRC / f"{name}.cu").read_text()
        for label, targs in variants.items():
            text += ENTRY_TEXT[name].format(entry=entry_name(name, label), **targs)
        out[f"sweep_{name}"] = text + (PLANES if name == "shadow_select9" else "")
    return out


def _bound(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def entries(sources: dict) -> dict:
    """(kernel, variant) -> C function: every source built at once (one nvcc
    each) and bound."""
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda kv: _cuda.build_source(*kv), sources.items())))
    libs = {name: ctypes.PyDLL(str(path)) for name, path in paths.items()}
    fns = {}
    for name, variants in VARIANTS.items():
        for label in variants:
            fns[(name, label)] = _bound(getattr(libs[f"sweep_{name}"], entry_name(name, label)),
                                        _cuda.SIGNATURES[name])
    planes = _bound(libs["sweep_shadow_select9"].sweep_select9_planes,
                    _cuda.SIGNATURES["shadow_select9"])
    return fns, planes


def layouts(planes_fn, args, tail):
    """K4's output layout with the PCF tail that reads it: (rows, planes)
    -> a function of no arguments giving the frame's shadow factors."""
    table, row, base, deltas = args
    shape, rest = tail[1].shape, tail[1:]
    n = row.shape[0]
    bw = shadow_mod._PCF_BW[tuple(deltas)]

    def rows_layout():
        nb = shadow_mod.select9(*args).reshape(shape + (9,))
        return shadow_mod._pcf_tail([nb[..., k] for k in range(9)], *rest)

    def planes():
        out = torch.empty((9, n), dtype=torch.float32, device=table.device)
        err = planes_fn(table.data_ptr(), row.data_ptr(), base.data_ptr(), out.data_ptr(), n,
                        table.shape[1], bw, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"select9 planes: cudaError {err}")
        return out

    def planes_layout():
        nb9 = planes()
        return shadow_mod._pcf_tail([nb9[k].reshape(shape) for k in range(9)], *rest)

    return {"(N, 9) rows + tail": rows_layout, "(9, N) planes + tail": planes_layout,
            "(N, 9) rows": lambda: shadow_mod.select9(*args), "(9, N) planes": planes}


def entry_call(fn, name: str, args):
    """One launch of C entry ``fn`` (kernel ``name``) on a captured call's
    normalised arguments; returns the output like the wrapper."""
    stream = torch.cuda.current_stream().cuda_stream
    if name == "mat_select":
        atlas, rows, params7 = args
        n = rows.shape[0]
        out = torch.empty((n, 16), dtype=torch.float32, device=atlas.device)
        err = fn(atlas.data_ptr(), rows.data_ptr(), params7.data_ptr(), out.data_ptr(), n, 0,
                 stream)  # dtype u8
    else:
        table, row, base, deltas = args
        n, lanes = row.shape[0], table.shape[1]
        out = torch.empty((n, 9), dtype=torch.float32, device=table.device)
        head = (table.data_ptr(), row.data_ptr(), base.data_ptr())
        err = fn(*head, out.data_ptr(), n, lanes, shadow_mod._PCF_BW[tuple(deltas)], stream)
    if err:
        raise RuntimeError(f"{name}: cudaError {err}")
    return out


def _distinct(idx) -> int:
    return int(torch.unique(idx.reshape(-1)).numel())


def work_select9(table, row, base, deltas):
    """(bytes, operations) of one K4 call: each distinct texel read once, row
    and base, the (N, 9) f32 output written once."""
    d = torch.as_tensor(deltas, device=table.device)
    texels = _distinct(row.long()[:, None] * table.shape[1] + base.long()[:, None] + d[None, :])
    return (texels * table.element_size() + row.shape[0] * (row.element_size() + base.element_size())
            + row.shape[0] * 9 * 4), 0


def work_mat_select(atlas, rows, params7):
    """(bytes, operations) of one K8 call: the 8 lane groups of each distinct
    row read once, rows_idx and params7, the (N, C) f32 output."""
    n, c = rows.shape[0], atlas.shape[-1] // 16
    return (_distinct(rows) * 8 * c * atlas.element_size() + n * rows.element_size()
            + params7.numel() * params7.element_size() + n * c * 4), 0


# kernel -> (wrapper module, attribute, plain version, work)
KERNELS = {
    "shadow_select9": (shadow_mod, "select9", shadow_mod.select9_ref, work_select9),
    "mat_select": (tex_mod, "mat_select", tex_mod.mat_select_ref, work_mat_select),
}


def frame_calls(dev) -> dict:
    """Kernel -> the arguments of its call in one 1920x1080 frame: K4 in a
    default-path frame, K8 in a packed-path frame (the packed u8 atlas,
    ``mat_select_kernel`` on, the plain tap after T1's footprint: T2 takes
    no K8); "pcf_tail" -> those of the PCF tail after K4."""
    from ..render import common
    from ..render.deferred import deferred_frame
    from ..render.params import FrameState, RenderSettings
    from ..render.testing import synthetic_device_scene, synthetic_frame_params

    settings = RenderSettings(width=WIDTH, height=HEIGHT, shadow_map_size=SHADOW,
                              has_masked_models=False, combined_material=True)
    calls = {}
    for name, packed in (("shadow_select9", False), ("mat_select", True)):
        module, attr = KERNELS[name][:2]
        scene, data = synthetic_device_scene(340, sphere_res=(32, 24), ground=True,
                                             rich_materials=True, atlas_u8=True,
                                             packed_trilinear=packed, device=dev)
        frame_settings = (dataclasses.replace(settings, material_packed_trilinear=True,
                                              mat_select_kernel=True) if packed else settings)
        params = synthetic_frame_params(data, WIDTH, HEIGHT, device=dev)
        recorded = [(name, module, attr)] + ([] if packed else [("pcf_tail", shadow_mod,
                                                                   "_pcf_tail")])
        origs = {key: getattr(mod, at) for key, mod, at in recorded}
        seen = {key: [] for key in origs}

        def recorder(key):
            def rec(*a):
                seen[key].append(a)
                return origs[key](*a)
            return rec

        for key, mod, at in recorded:
            setattr(mod, at, recorder(key))
        engage = common.tap_kernels_engage
        common.tap_kernels_engage = lambda *a: False
        try:
            deferred_frame(scene, params, FrameState.initial(WIDTH, HEIGHT, dev), frame_settings)
            torch.cuda.synchronize()
        finally:
            common.tap_kernels_engage = engage
            for key, mod, at in recorded:
                setattr(mod, at, origs[key])
        calls.update({key: args[0] for key, args in seen.items()})
        del scene
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v first")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("select sweep: needs a CUDA card")
    smi = nvidia_smi()
    result = {"device": smi, "ptxas": {}, "calls": []}
    sources = variant_sources()
    if args.ptxas:
        with tempfile.TemporaryDirectory() as tmp:
            for label, text in sources.items():
                src = Path(tmp) / f"{label}.cu"
                src.write_text(text)
                result["ptxas"][label] = ptxas(label, src)
    fns, planes_fn = entries(sources)
    _cuda.library()
    dev = torch.device("cuda", 0)
    calls = frame_calls(dev)
    tail = calls.pop("pcf_tail")
    for name, a in calls.items():
        module, attr, ref, work = KERNELS[name]
        wrapper = getattr(module, attr)
        if name == "mat_select":
            norm = (a[0], a[1].to(torch.int32).contiguous(), a[2].contiguous())
        else:
            norm = (a[0], a[1].to(torch.int32).contiguous(), a[2].to(torch.int32).contiguous(),
                    a[3])
        want = ref(*a)
        variants = {"shipped": lambda a=a, wrapper=wrapper: wrapper(*a)}
        for (kernel, label), fn in fns.items():
            if kernel == name:
                variants[label] = lambda fn=fn: entry_call(fn, name, norm)
        for label, fn in variants.items():
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{label} {name} != plain at the frame's call")
        times = {}
        for r in range(ROUNDS):
            order = list(variants.items())
            for label, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(label, []).append(graph_ms(fn, REPS))
        moved, _ = work(*a)
        row = {"kernel": name, "shapes": [list(x.shape) for x in a if isinstance(x, torch.Tensor)],
               "bytes": moved, "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
               "ms": {v: statistics.median(ts) for v, ts in times.items()}, "ms_rounds": times}
        result["calls"].append(row)
        ranked = sorted(row["ms"].items(), key=lambda kv: kv[1])
        print(f"[{name}] shapes {row['shapes']}, bound {row['bound_ms']:.4f} ms ({moved} B)")
        print(f"[{name}] graph ms per call, fastest first: "
              + ", ".join(f"{v} {ms:.4f}" for v, ms in ranked) + f" (bit-equal to plain; {smi})")
        if name != "shadow_select9":
            continue
        # the output layout, with the PCF tail that reads it
        fns_layout = layouts(planes_fn, a, tail)
        if not (torch.equal(fns_layout["(9, N) planes"](), want.t())
                and torch.equal(fns_layout["(9, N) planes + tail"](),
                                fns_layout["(N, 9) rows + tail"]())):
            raise RuntimeError("select9 planes != the (N, 9) rows transposed, or their tails differ")
        # eager: the tail copies Python scalars to the card, which a CUDA
        # graph's capture refuses
        times = {}
        for r in range(ROUNDS):
            order = list(fns_layout.items())
            for label, fn in (order if r % 2 == 0 else order[::-1]):
                times.setdefault(label, []).append(cuda_ms(fn, reps=2 * REPS))
        result["layouts"] = {"eager_ms": {v: statistics.median(ts) for v, ts in times.items()},
                             "eager_ms_rounds": times}
        print("[shadow_select9 layout] eager ms (CUDA events over 20 calls): " + ", ".join(
            f"{v} {statistics.median(ts):.4f}" for v, ts in times.items())
            + f" (planes equal to the rows transposed, tails bit-equal; {smi})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
