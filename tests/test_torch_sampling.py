"""The port's samplers and tap math against the JAX package's.

Given identical coordinates the integer taps must match exactly (truncation
toward zero, floor-mod wrap, clamp); weights and sampled values agree to
float32 rounding of the same expressions. Coordinates are those of
tests/test_remap_golden.py::TestSamplerParity, plus the non-finite and
out-of-int32-range values a fisheye fold ring can give.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_lens_reproject_tpu.ops import sampling as JS
from image_lens_reproject_tpu.ops.pallas import taps as JT
from image_lens_reproject_torch.ops import sampling as TS

F = np.float32
INTERPS = ["nearest", "bilinear", "bicubic"]
# Same expressions, same order, float32 both sides: equal up to the last
# bit or two that XLA's CPU code generation may round differently.
VALUE_ATOL = 1e-6

NONFINITE = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0**31, -(2.0**31), -0.0], dtype=F)


def _coords():
    rng = np.random.default_rng(42)
    sx = rng.uniform(-6, 29, size=(200,)).astype(F)
    sy = rng.uniform(-6, 25, size=(200,)).astype(F)
    sx = np.concatenate([sx, np.arange(-3, 26, dtype=F), np.arange(-3, 26, dtype=F) + F(0.5)])
    sy = np.concatenate([sy, np.arange(-3, 26, dtype=F), np.arange(-3, 26, dtype=F) + F(0.25)])
    return sx, sy


def _src():
    return np.random.default_rng(42).uniform(0, 1, size=(19, 23, 3)).astype(F)


def test_trunc_saturates_and_maps_nan_to_zero():
    """What the JAX CPU path's ``trunc(v).astype(int32)`` gives, pinned:
    toward zero, saturated to the int32 range, NaN -> 0. CUDA's
    ``__float2int_rz`` in kernel B1 gives the same."""
    want = np.asarray(JS._trunc_i32(jnp, jnp.asarray(NONFINITE)))
    np.testing.assert_array_equal(
        want, np.array([2**31 - 1, -(2**31), 0, 2**31 - 1, -(2**31), 2**31 - 1, -(2**31), 0])
    )
    got = TS._trunc_i32(torch.from_numpy(NONFINITE))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("wrap", [False, True])
def test_taps_match_exactly(interp, wrap):
    sx, sy = _coords()
    sx = np.concatenate([sx, NONFINITE])
    sy = np.concatenate([sy, NONFINITE[::-1]])
    jx = JT.x_taps(jnp.asarray(sx), 23, interp, wrap)
    jy = JT.y_taps(jnp.asarray(sy), 19, interp)
    tx = TS.x_taps(torch.from_numpy(sx), 23, interp, wrap)
    ty = TS.y_taps(torch.from_numpy(sy), 19, interp)
    for got, want in ((tx, jx), (ty, jy)):
        assert len(got.idx) == len(want.idx)
        for g, w in zip(got.idx, want.idx):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got.weights, want.weights):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=VALUE_ATOL)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("wrap", [False, True])
def test_sampled_values(interp, wrap):
    src = _src()
    sx, sy = _coords()
    want = np.asarray(JS.sample(jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy), interp, wrap))
    got = TS.sample(torch.from_numpy(src), torch.from_numpy(sx), torch.from_numpy(sy), interp, wrap)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VALUE_ATOL)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("wrap", [False, True])
def test_sampled_values_at_nonfinite_coords(interp, wrap):
    src = _src()
    sx = np.concatenate([NONFINITE, NONFINITE, np.full(8, 5.5, F)])
    sy = np.concatenate([NONFINITE, np.full(8, 5.5, F), NONFINITE])
    want = np.asarray(JS.sample(jnp.asarray(src), jnp.asarray(sx), jnp.asarray(sy), interp, wrap))
    got = TS.sample(torch.from_numpy(src), torch.from_numpy(sx), torch.from_numpy(sy), interp, wrap)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VALUE_ATOL)


def test_batch_shares_one_coordinate_field():
    src = np.stack([_src(), _src()[::-1].copy()])
    sx, sy = _coords()
    got = TS.sample(torch.from_numpy(src), torch.from_numpy(sx), torch.from_numpy(sy), "bicubic", True)
    for b in range(2):
        single = TS.sample(torch.from_numpy(src[b]), torch.from_numpy(sx), torch.from_numpy(sy), "bicubic", True)
        assert torch.equal(got[b], single)


def test_wrap_modulo():
    # sx = 7.75 bilinear: lx = 7, ux = trunc(8.75) = 8 -> wraps to 0.
    src = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8, 1)
    got = TS.sample(src, torch.tensor(7.75), torch.tensor(1.0), "bilinear", True)
    assert float(got[0]) == pytest.approx(0.25 * float(src[1, 7, 0]) + 0.75 * float(src[1, 0, 0]))


def test_unknown_interpolation():
    with pytest.raises(ValueError, match="not supported"):
        TS.sample(torch.zeros(2, 2, 1), torch.zeros(1), torch.zeros(1), "lanczos", False)
