"""The present's u8 conversion (``unclerenderer_tpu_torch/ops/present.py``)
on the CPU: the kernel's plain version, which the wrapper takes for a CPU
tensor, byte-equal to the reference's numpy formula
(``unclerenderer_tpu/render/renderer.py:779``) on random colours, on every
exact half of a level and its float32 neighbours, and on the special
values; NaN to 0, as numpy's cast gives on x86-64.  The kernel itself is
held to both on the card (``tests/test_torch_cuda.py -k present``)."""

import numpy as np
import pytest
import torch

from unclerenderer_tpu_torch.ops.present import present_u8, to_u8_host
from test_torch_threads import one_torch_thread  # noqa: F401 -- one torch thread a module


def numpy_u8(x: np.ndarray) -> np.ndarray:
    """The reference's conversion, written out here (not imported)."""
    with np.errstate(invalid="ignore", over="ignore"):  # NaN's cast, the largest floats
        return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def _halves() -> np.ndarray:
    """(k + 0.5) / 255 for every level k in 0..254 as float32, with its two
    float32 neighbours on each side."""
    x = ((np.arange(255) + 0.5) / 255).astype(np.float32)
    out = [x]
    for toward in (np.float32(np.inf), np.float32(-np.inf)):
        y = x
        for _ in range(2):
            y = np.nextafter(y, toward)
            out.append(y)
    return np.concatenate(out)


def _colours(case: str) -> np.ndarray:
    if case == "random":
        return np.random.default_rng(22).uniform(-0.5, 1.5, (48, 64, 3)).astype(np.float32)
    if case == "halves":
        return _halves()
    if case == "specials":
        big = np.finfo(np.float32).max
        return np.array([0.0, -0.0, 1.0, np.inf, -np.inf, big, -big, 1e-45, -1e-45,
                         np.nextafter(np.float32(1), np.float32(2))], np.float32)
    return np.array([np.nan, -np.nan, 0.5, np.nan], np.float32)  # "nan"


@pytest.mark.parametrize("case", ["random", "halves", "specials", "nan"])
def test_present_u8_plain_version_equals_numpys_formula(case):
    x = _colours(case)
    got = present_u8(torch.from_numpy(x)).numpy()
    want = numpy_u8(x)
    assert got.dtype == np.uint8 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    if case != "nan":
        with np.errstate(over="ignore"):
            np.testing.assert_array_equal(to_u8_host(x), want)
    else:  # numpy's cast of NaN on this host, and the plain version's
        assert (want[np.isnan(x)] == 0).all() and (got[np.isnan(x)] == 0).all()


def test_present_u8_rounds_exact_halves_to_even():
    """The halves case decides ties: some of its products are exact halves,
    rounded to the even level."""
    x = _halves()
    prod = x * np.float32(255.0)
    ties = x[prod == np.floor(prod) + 0.5]
    assert ties.size > 0
    got = present_u8(torch.from_numpy(ties)).numpy()
    assert (got % 2 == 0).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16, torch.uint8])
def test_present_u8_refuses_a_colour_not_float32(dtype):
    with pytest.raises(TypeError, match="float32"):
        present_u8(torch.zeros((4, 4, 3), dtype=dtype))


def test_present_u8_writes_out_on_the_cpu():
    x = torch.from_numpy(_colours("random"))
    out = torch.empty(x.shape, dtype=torch.uint8)
    assert present_u8(x, out=out) is out
    np.testing.assert_array_equal(out.numpy(), numpy_u8(x.numpy()))
