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


# Row bands (row_offset / row_count): the unit of the mesh's rows axis. The
# last band runs past out_h = 24, as the last band of a padded mesh does.
BANDS = {"middle": (8, 8), "past-out_h": (16, 16)}


@pytest.mark.parametrize("band", sorted(BANDS))
@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_row_band_matches_jax(pair, interp, band):
    """A band of remap_image and of B1's plain version (remap_tonemap_plain,
    with the tonemap) against the JAX package's remap_image band."""
    from image_lens_reproject_torch.ops.cuda import remap_kernel as B1

    in_ref, out_ref = PAIRS[pair]
    row_offset, row_count = BANDS[band]
    src = np.random.default_rng(3).uniform(0, 2, (32, 64, 3)).astype(F)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    kw = dict(out_h=24, out_w=64, interp=interp, n_samples=1)
    want = JR.remap_image(jnp.asarray(src), jnp.asarray(rot), in_lens=in_ref, out_lens=out_ref,
                          row_offset=row_offset, row_count=row_count, **kw)
    tkw = dict(in_lens=TL.from_reference(in_ref), out_lens=TL.from_reference(out_ref),
               row_offset=row_offset, row_count=row_count, **kw)
    got = TR.remap_image(torch.from_numpy(src), rot, **tkw).numpy()
    _bounds(got, np.asarray(want))
    toned = B1.remap_tonemap_plain(torch.from_numpy(src)[None], rot, exposure=2.0, reinhard=4.0,
                                   **tkw)[0].numpy()
    _bounds(toned, np.asarray(JC.post_process(want, 2.0, 4.0)))


@pytest.mark.parametrize("n_samples", [1, 2])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_row_bands_concatenate_to_the_frame(pair, n_samples):
    """The port's bands of 8 rows, the last one past out_h = 20 and cut,
    equal its full frame bit for bit."""
    in_ref, out_ref = PAIRS[pair]
    src = torch.from_numpy(np.random.default_rng(4).uniform(0, 2, (2, 32, 64, 3)).astype(F))
    kw = dict(in_lens=TL.from_reference(in_ref), out_lens=TL.from_reference(out_ref),
              out_h=20, out_w=64, interp="bicubic", n_samples=n_samples)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    full = TR.remap_batch(src, rot, **kw)
    bands = [TR.remap_batch(src, rot, row_offset=r0, row_count=8, **kw) for r0 in (0, 8, 16)]
    assert [b.shape[1] for b in bands] == [8, 8, 8]
    assert torch.equal(torch.cat(bands, dim=1)[:, :20], full)


@pytest.mark.parametrize("row_offset,row_count", [(-1, 4), (0, 0)])
def test_row_band_arguments_are_checked(row_offset, row_count):
    in_ref, out_ref = PAIRS["equirect-rect"]
    src = torch.zeros((8, 16, 3))
    with pytest.raises(ValueError, match="bad band"):
        TR.remap_image(src, None, in_lens=TL.from_reference(in_ref),
                       out_lens=TL.from_reference(out_ref), out_h=4, out_w=4,
                       row_offset=row_offset, row_count=row_count)


# The headline's lenses and rows (equirect -> rectilinear 35 mm on a
# 36 x 20.25 mm sensor, 2160 rows), 32 columns wide and from a 96 x 192
# source, so that the plain path runs it in seconds; its bands of the
# mesh's rows axis: rows 540-1079 (4 bands of 540) and the 7-band cut's
# 309-row bands, the last running to row 2163, past out_h.
HEADLINE_ROWS = dict(in_lens=TL.full_equirectangular(), out_lens=TL.Rectilinear(35.0, 36.0, 20.25),
                     out_h=2160, out_w=32, interp="bicubic", n_samples=1)
HEADLINE_BANDS = [(540, 540), (309, 309), (1854, 309)]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("band", HEADLINE_BANDS, ids=lambda b: f"rows{b[0]}+{b[1]}")
def test_subtiles_of_a_band_equal_the_band(band, batch):
    """Every sub-tile of a band, computed at the band's rows
    (``row_offset``) and scattered into a band-high output, equals
    remap_batch's band bit for bit."""
    row0, count = band
    src = torch.from_numpy(np.random.default_rng(batch).uniform(0, 2, (batch, 96, 192, 3))
                           .astype(F))
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    want = TR.remap_batch(src, rot, row_offset=row0, row_count=count, **HEADLINE_ROWS)
    n_ty = -(-count // TR.TILE_H)
    tiles = torch.stack([torch.arange(n_ty), torch.zeros(n_ty, dtype=torch.int64)], dim=1)
    rows, _ = TR.subtile_pixels(tiles, row0)
    assert int(rows.min()) == row0 and int(rows.max()) == row0 + n_ty * 8 - 1
    values = TR.remap_subtiles(src, rot, tiles, row_offset=row0, **HEADLINE_ROWS)
    out = torch.full((batch, count, 32, 3), math.nan)
    TR.scatter_subtiles(out, values, tiles)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.equal(out.nan_to_num(7.0), want.nan_to_num(7.0))
