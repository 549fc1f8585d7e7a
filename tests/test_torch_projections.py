"""The port's projection math against the JAX package's jnp versions.

Same formulas in the same order, so the fields agree to the last few ulps
of each library's libm (XLA's and PyTorch's sin/atan/asin differ there).
The reference's quirks are pinned: the equirect seam's signed zero, the
non-unit equirect ray, ``+cos(theta)`` on the fisheye forward maps and the
center-pixel guards.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_lens_reproject_tpu.models import lens as JL
from image_lens_reproject_tpu.models import projections as JP
from image_lens_reproject_tpu.models.rotation import rotation_matrix_degrees
from image_lens_reproject_tpu.ops import remap as JR
from image_lens_reproject_torch.models import lens as TL
from image_lens_reproject_torch.models import projections as TP
from image_lens_reproject_torch.ops import remap as TR

F = np.float32
W, H = 96.0, 64.0

LENSES = [
    JL.Rectilinear(35.0, 36.0, 20.25),
    JL.FisheyeEquidistant(math.pi, 36.0, 36.0),
    JL.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0),
    JL.FisheyeStereographic(12.0, 3.0, 36.0, 24.0),
    JL.full_equirectangular(),
    JL.Equirectangular(-2.0, 1.5, -1.2, 1.0),
]
IDS = [type(s).__name__ + str(i) for i, s in enumerate(LENSES)]

# Rays are of unit scale: a few float32 ulps of 1.
RAY_ATOL = 1e-6
# Source coordinates are pixels of a 96-px image (ulp(48) = 3.8e-6): a few
# ulps there, from last-ulp differences of atan/asin/sin between libms.
PIXEL_ATOL = 5e-5


def _pixel_grid():
    cx = (np.arange(int(W), dtype=F) + F(0.5)) - F(W * 0.5)
    cy = (np.arange(int(H), dtype=F) + F(0.5)) - F(H * 0.5)
    cx, cy = np.meshgrid(cx, cy)
    # The exact center pixel exercises the fisheye center guards.
    return np.append(cx.ravel(), F(0.0)), np.append(cy.ravel(), F(0.0))


def _rays(seed=0, n=4000):
    v = np.random.default_rng(seed).normal(size=(3, n)).astype(F)
    v[2] = -np.abs(v[2]) - F(0.1)
    return v


@pytest.mark.parametrize("ref", LENSES, ids=IDS)
def test_pixel_to_ray(ref):
    cx, cy = _pixel_grid()
    want = JP.target_to_vec(ref, W, H, jnp.asarray(cx), jnp.asarray(cy))
    got = TP.target_to_vec(TL.from_reference(ref), W, H, torch.from_numpy(cx), torch.from_numpy(cy))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=RAY_ATOL)
        assert np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("ref", LENSES, ids=IDS)
def test_ray_to_pixel(ref):
    v = _rays()
    want = JP.vec_to_source(ref, W, H, *map(jnp.asarray, v))
    got = TP.vec_to_source(TL.from_reference(ref), W, H, *map(torch.from_numpy, v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=PIXEL_ATOL)


def test_fisheye_forward_z_is_plus_cos_theta():
    # As tests/test_projections.py pins it: 10 px off center of a 1920-px
    # image is a ray of theta = 0.016 rad, and z is +cos(theta), not -.
    lens = TL.FisheyeEquidistant(math.pi, 36.0, 36.0)
    _, _, z = TP.equidistant_to_vec(lens, 1920.0, 1080.0, torch.tensor([10.0]), torch.tensor([0.0]))
    assert float(z) > 0.99


def test_equirect_forward_ray_is_not_unit():
    lens = TL.full_equirectangular()
    x, y, z = TP.equirectangular_to_vec(lens, W, H, torch.tensor([10.0]), torch.tensor([20.0]))
    assert abs(float(x * x + y * y + z * z) - 1.0) > 1e-3


@pytest.mark.parametrize("x", [0.0, -0.0])
def test_equirect_seam_keeps_signed_zero(x):
    # A ray straight behind the camera (x = +-0, z = +1): -atan2(-x, -z)
    # is +pi for x = +0.0 and -pi for x = -0.0, i.e. the right or the left
    # edge of the panorama. Both packages must take the same branch.
    lens = JL.full_equirectangular()
    xs = np.array([x, x, x], dtype=F)
    ys = np.array([0.0, 0.3, -0.2], dtype=F)
    zs = np.array([1.0, 1.0, 2.0], dtype=F)
    want = JP.vec_to_equirectangular(lens, W, H, *map(jnp.asarray, (xs, ys, zs)))
    got = TP.vec_to_equirectangular(TL.from_reference(lens), W, H, *map(torch.from_numpy, (xs, ys, zs)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    edge = W * 0.5 if math.copysign(1.0, x) > 0 else -W * 0.5
    np.testing.assert_array_equal(got[0].numpy(), np.full(3, edge, dtype=F))


@pytest.mark.parametrize(
    "in_ref,out_ref",
    [
        (LENSES[1], LENSES[0]),
        (LENSES[4], LENSES[0]),
        (LENSES[0], LENSES[4]),
        (LENSES[2], LENSES[4]),
        (LENSES[0], LENSES[2]),
        (LENSES[4], LENSES[1]),
        (LENSES[5], LENSES[3]),
    ],
    ids=lambda s: type(s).__name__,
)
def test_source_coords(in_ref, out_ref):
    """The coordinate fields of tests/test_remap_golden.py::TestCoordinateField."""
    out_h, out_w, in_h, in_w = 36, 64, 48, 96
    cx = (np.arange(out_w, dtype=F) + F(0.5)) - F(out_w * 0.5)
    cy = (np.arange(out_h, dtype=F) + F(0.5)) - F(out_h * 0.5)
    rot = rotation_matrix_degrees(10.0, -5.0, 3.0)
    want = JR.source_coords(
        in_ref, out_ref, in_h, in_w, jnp.asarray(cx[None, :]), jnp.asarray(cy[:, None]),
        jnp.asarray(rot), out_h, out_w,
    )
    got = TR.source_coords(
        TL.from_reference(in_ref), TL.from_reference(out_ref), in_h, in_w,
        torch.from_numpy(cx[None, :]), torch.from_numpy(cy[:, None]),
        torch.from_numpy(rot), out_h, out_w,
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g.numpy()), finite)
        # Inverse maps that divide by -z blow up near z = 0, where a ulp of
        # the ray moves the coordinate by many ulps of its own (one pixel of
        # this field lands 17700 px out): compare relative to it there.
        np.testing.assert_allclose(g.numpy()[finite], w[finite], rtol=1e-4, atol=PIXEL_ATOL)
