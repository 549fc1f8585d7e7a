"""The port's plain path (ops/remap.py, ops/color.py) against the JAX package's.

Inputs come from a numpy seed and go through ``ops/remap.py::remap_image``
and ``ops/color.py::post_process`` of both packages. Bounds: the BASELINE
parity budget, max abs < 1e-3, and p999 < 1e-4; the two differ only where
a last-ulp libm difference moves a tap.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_lens_reproject_tpu.models import lens as JL
from image_lens_reproject_tpu.models.rotation import rotation_matrix_degrees
from image_lens_reproject_tpu.ops import color as JC
from image_lens_reproject_tpu.ops import remap as JR
from image_lens_reproject_torch.models import lens as TL
from image_lens_reproject_torch.ops import color as TC
from image_lens_reproject_torch.ops import remap as TR

F = np.float32

PAIRS = {
    "equirect-rect": (JL.full_equirectangular(), JL.Rectilinear(35.0, 36.0, 20.25)),
    "partial-rect": (JL.Equirectangular(-2.0, 1.5, -1.2, 1.0), JL.Rectilinear(20.0, 36.0, 24.0)),
    "equidistant-rect": (JL.FisheyeEquidistant(math.pi, 36.0, 36.0), JL.Rectilinear(35.0, 36.0, 24.0)),
    "equisolid-equirect": (JL.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0), JL.full_equirectangular()),
}


def _bounds(got, want):
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.max() < 1e-3
    assert np.quantile(err, 0.999) < 1e-4


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("c", [3, 4, 5])
@pytest.mark.parametrize("n_samples", [1, 2])
def test_remap_image_and_post_process(pair, c, n_samples):
    in_ref, out_ref = PAIRS[pair]
    src = np.random.default_rng(c + 10 * n_samples).uniform(0, 2, (32, 64, c)).astype(F)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    kw = dict(out_h=24, out_w=40, interp="bicubic", n_samples=n_samples)
    want = JR.remap_jit(jnp.asarray(src), jnp.asarray(rot), in_lens=in_ref, out_lens=out_ref, **kw)
    want = np.asarray(JC.post_process(want, 2.0, 4.0))
    got = TR.remap_image(
        torch.from_numpy(src), rot, in_lens=TL.from_reference(in_ref),
        out_lens=TL.from_reference(out_ref), **kw,
    )
    got = TC.post_process(got, 2.0, 4.0).numpy()
    _bounds(got, want)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_other_interpolations_without_rotation(interp):
    in_ref, out_ref = PAIRS["equirect-rect"]
    src = np.random.default_rng(7).uniform(0, 2, (32, 64, 3)).astype(F)
    kw = dict(out_h=24, out_w=40, interp=interp, n_samples=1)
    want = np.asarray(JR.remap_jit(jnp.asarray(src), None, in_lens=in_ref, out_lens=out_ref, **kw))
    got = TR.remap_image(torch.from_numpy(src), None, in_lens=TL.from_reference(in_ref),
                         out_lens=TL.from_reference(out_ref), **kw).numpy()
    err = np.abs(got - want)
    # Nearest and bilinear are not continuous in a knife-edge tap the way
    # bicubic is: bound the share of pixels off, as the JAX kernel tests do.
    assert np.quantile(err, 0.999) < 1e-4
    assert (err.max(axis=-1) > 1e-3).mean() < 1e-3


def test_remap_batch_equals_each_image():
    in_ref, out_ref = PAIRS["equirect-rect"]
    batch = np.random.default_rng(1).uniform(0, 2, (3, 32, 64, 3)).astype(F)
    kw = dict(in_lens=TL.from_reference(in_ref), out_lens=TL.from_reference(out_ref),
              out_h=24, out_w=40, interp="bicubic", n_samples=2)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    got = TR.remap_batch(torch.from_numpy(batch), rot, **kw)
    for b in range(3):
        assert torch.equal(got[b], TR.remap_image(torch.from_numpy(batch[b]), rot, **kw))
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        TR.remap_image(torch.from_numpy(batch), rot, **kw)


def test_supersample_offsets_equal():
    for n in (1, 2, 3, 4):
        assert TR.supersample_offsets(n) == [float(o) for o in JR.supersample_offsets(n)]


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
def test_post_process_touches_first_three_channels(c):
    img = np.random.default_rng(c).uniform(0, 8, (6, 7, c)).astype(F)
    want = np.asarray(JC.post_process(jnp.asarray(img), 2.0 ** 0.5, 4.0))
    got = TC.post_process(torch.from_numpy(img), 2.0 ** 0.5, 4.0).numpy()
    # Same float32 expression in the same order on both sides.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[..., 3:], img[..., 3:])


def test_tonemap_guard():
    assert not TC.needed(1.0, 1.0)
    assert TC.needed(2.0, 1.0) and TC.needed(1.0, 4.0)
