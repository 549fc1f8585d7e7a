"""Kernel B2's wrapper (ops/cuda/rescue_kernel.py) against the JAX package's K2 and K3.

K2 is the JAX package's pass-2 rescue and K3 its pass-2b split rescue: two
compact Pallas launches that recompute listed 8 x 128 sub-tiles, each from
its own source window (K3: one window for each 8 x 64 half). Their lists
are built as the JAX package's own tests build them
(``make_prepass(with_rescue=True[, split_pieces=2])`` and ``remap_pallas``
with ``rescue_cap`` / ``split_cap``, in interpret mode), and on exactly
those sub-tiles the port's plain version must give K2's and K3's pixels.
On the CPU B2's wrapper runs its plain version because the tensor lies on
the CPU; the tests that launch B2 carry the ``gpu`` marker.

The JAX package is imported inside the tests that compare with it, so that
the ``gpu`` tests of this file also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_rescue.py``.
"""

import math

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import plan as P
from image_lens_reproject_torch.ops import remap_fused
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

F = np.float32
EQUISOLID = L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)
EQUIRECT = L.full_equirectangular()


def _reference(spec):
    from image_lens_reproject_tpu.models import lens as JL

    cls = getattr(JL, type(spec).__name__)
    return cls(**{k: getattr(spec, k) for k in spec.__dataclass_fields__})


def _smooth(h, w, c, seed):
    """The smooth test image of tests/test_pallas_kernel.py."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=F), np.linspace(0, 1, w, dtype=F),
                         indexing="ij")
    return np.stack(
        [0.5 + 0.45 * np.sin(4 * a * xx + 3 * b * yy + p) for a, b, p in rng.uniform(0.5, 2, (c, 3))],
        -1,
    ).astype(F)


def _entries(tiles, whole, halves, split):
    """The port's list entries for JAX-chosen (sub-tile row, column) pairs."""
    t = torch.as_tensor(tiles, dtype=torch.int64).reshape(-1, 2)
    fields = halves[t[:, 0], t[:, 1]].reshape(-1, 8) if split else whole[t[:, 0], t[:, 1]]
    return torch.cat([t, fields], dim=1).to(torch.int32).contiguous()


def _plain_subtiles(src, rot, entries, split, kw):
    """B2's plain version over ``entries`` into a NaN-filled output."""
    out = torch.full((1, kw["out_h"], kw["out_w"], src.shape[-1]), float("nan"))
    misses = B2.new_misses("cpu")
    B2.remap_windows(torch.from_numpy(src)[None], rot, out, entries, split=split, misses=misses,
                     window_floats=1, **kw)
    assert int(misses) == 0
    return out[0].numpy()


def _mask(tiles, out_h, out_w):
    m = np.zeros((out_h, out_w), bool)
    for ty, tx in tiles:
        m[ty * 8:ty * 8 + 8, tx * 128:tx * 128 + 128] = True
    return m


def _bounds(err, p999):
    assert np.quantile(err, 0.999) < p999
    assert (err.max(axis=-1) > 1e-3).mean() < 1e-3


@pytest.fixture
def interpret_k1():
    from image_lens_reproject_tpu.ops.pallas import remap_kernel as RK

    RK.set_interpret(True)
    yield RK
    RK.set_interpret(False)


def test_plain_version_matches_k2_rescued_subtiles(interpret_k1):
    """The case of tests/test_pallas_kernel.py::test_rescue_pass_exact_and_capped:
    rectilinear 96x96 -> equisolid 32x128, bilinear, its annulus giving
    rescuable sub-tiles; K2 recomputes two of them (rescue_cap=2)."""
    import jax.numpy as jnp
    from image_lens_reproject_tpu.ops import remap_fused as JF

    RK = interpret_k1
    src = _smooth(96, 96, 3, seed=14)
    inl = L.Rectilinear(50.0, 36.0, 36.0)
    jkw = dict(in_lens=_reference(inl), out_lens=_reference(EQUISOLID), out_h=32, out_w=128,
               interp="bilinear", n_samples=1, tile_rows=8, n_groups=3, rb=40, scan_unroll=8)
    scalars, bad, rescue = JF.make_plan(None, in_h=96, in_w=96, channels=3, with_rescue=True,
                                        **jkw)
    taken = np.asarray(jnp.logical_and(bad, rescue[3] > 0))  # (n_ty, 1, n_tx)
    # rescue_cap=2: K2 takes the first two in row-major order, as the JAX
    # test pins.
    tiles = [(ty, tx) for ty, _, tx in np.argwhere(taken)][:2]
    assert len(tiles) == 2
    want = np.asarray(JF.remap_tonemap_planned(
        jnp.asarray(src), None, scalars, bad, rescue, rescue_cap=2, **jkw))

    kw = dict(in_lens=inl, out_lens=EQUISOLID, out_h=32, out_w=128, interp="bilinear",
              n_samples=1)
    whole, halves = P.windows(None, in_h=96, in_w=96, device="cpu", **kw)
    got = _plain_subtiles(src, None, _entries(tiles, whole, halves, False), False, kw)
    m = _mask(tiles, 32, 128)
    assert not np.isnan(got[m]).any() and np.isnan(got[~m]).all()
    # The bounds of tests/test_torch_remap_kernel.py::_bounds.
    _bounds(np.abs(got[m] - want[m]), 1e-4)


@pytest.fixture
def split_band():
    """The configuration of tests/test_split_rescue.py, cut to its first
    24-row tile band (which holds both K2- and K3-rescued sub-tiles):
    equisolid 1024x1024 -> full equirect 1024x2048, rotation (30, 10, 5),
    bilinear, tiling 24:3:40:32:256, rescue budgets (8, 6)."""
    import jax.numpy as jnp
    from image_lens_reproject_tpu.ops.pallas import remap_kernel as RK

    RK.set_interpret(True)
    try:
        rot = rotation_matrix_degrees(30.0, 10.0, 5.0)
        tiling = dict(tile_rows=24, n_groups=3, rb=40, scan_unroll=32, cb=256)
        jkw = dict(in_lens=_reference(EQUISOLID), out_lens=_reference(EQUIRECT), out_h=1024,
                   out_w=2048, interp="bilinear", row0=0, band_rows=24, **tiling)
        pre = RK.make_prepass(rot, with_rescue=True, rescue_budgets=(8, 6), split_pieces=2,
                              in_h=1024, in_w=1024, channels=3, **jkw)
        _, bad, rescue, split = pre
        bad = np.asarray(bad)
        taken = np.asarray(rescue[3] > 0) & bad
        split_ok = np.asarray(jnp.all(split[3] > 0, axis=3)) & bad & ~taken
        src = np.random.default_rng(7).uniform(size=(1024, 1024, 3)).astype(F)
        out = np.asarray(RK.remap_pallas(
            jnp.asarray(src), rot, prepass=pre, rescue_budgets=(8, 6),
            rescue_cap=RK._ceil_to(max(int(taken.sum()), 1), 8),
            split_cap=RK._ceil_to(max(int(split_ok.sum()), 1), 8), **jkw))
    finally:
        RK.set_interpret(False)

    def tiles(mask):  # (ty, h, tx) of 24-row tiles -> 8-row sub-tile (row, column)
        return [(ty * 3 + h, tx) for ty, h, tx in np.argwhere(mask)]

    return rot, src, out, tiles(taken), tiles(split_ok)


def test_plain_version_matches_jax_rescue_band(split_band):
    """K2's and K3's sub-tiles of one band (one test, so that the expensive
    JAX band runs once however the tests are spread over workers)."""
    rot, src, want, taken, split_tiles = split_band
    kw = dict(in_lens=EQUISOLID, out_lens=EQUIRECT, out_h=1024, out_w=2048, interp="bilinear",
              n_samples=1)
    whole, halves = P.windows(rot, in_h=1024, in_w=1024, device="cpu", **kw)
    for tiles, split in ((taken, False), (split_tiles, True)):
        assert len(tiles) > 0
        got = _plain_subtiles(src, rot, _entries(tiles, whole, halves, split), split, kw)[:24]
        m = _mask(tiles, 24, 2048)
        # p999 2e-4: the bound tests/test_split_rescue.py holds this
        # polar-arc band to; K1-K3 compute their inverse trig with
        # polynomials that drift ~1e-4 p999 here from libm, with or without
        # the rescue launches.
        _bounds(np.abs(got[m] - want[m]), 2e-4)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("kernel B2 is CUDA only and this machine has no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def launches():
    saved = (B1.LAUNCHES, B1.LIST_LAUNCHES, B2.LAUNCHES, B2.SPLIT_LAUNCHES)
    B1.LAUNCHES = B1.LIST_LAUNCHES = B2.LAUNCHES = B2.SPLIT_LAUNCHES = 0
    yield
    B1.LAUNCHES, B1.LIST_LAUNCHES, B2.LAUNCHES, B2.SPLIT_LAUNCHES = saved


# cfg2 where some sub-tiles take each list at half the default budget.
CARD_CASES = {
    "cfg2-split": (EQUISOLID, EQUIRECT, 256, 256, 3, 256, 512, "bilinear", (30.0, 10.0, 5.0),
                   48 * 1024),
    "seam-bicubic": (EQUIRECT, L.Rectilinear(35.0, 36.0, 20.25), 192, 384, 3, 216, 384,
                     "bicubic", (180.0, 5.0, 0.0), P.WINDOW_BUDGET_BYTES),
    "cfg4-rgbz": (L.Rectilinear(50.0, 36.0, 36.0), EQUISOLID, 256, 256, 4, 256, 256,
                  "bilinear", None, 16 * 1024),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_matches_plain_version_on_card(cuda, launches, name):
    in_lens, out_lens, in_h, in_w, c, out_h, out_w, interp, rot, budget = CARD_CASES[name]
    rot = None if rot is None else rotation_matrix_degrees(*rot)
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w, interp=interp,
              n_samples=1, exposure=2.0, reinhard=4.0)
    src = torch.from_numpy(
        np.random.default_rng(3).uniform(0, 2, (2, in_h, in_w, c)).astype(F)).to(cuda)
    plan = P.make_plan(rot, in_h=in_h, in_w=in_w, channels=c, split=True, device=cuda,
                       budget_bytes=budget, **{k: kw[k] for k in
                                               ("in_lens", "out_lens", "out_h", "out_w",
                                                "interp", "n_samples")})
    for entries, split, floats in ((plan.rescue, False, plan.rescue_floats),
                                   (plan.split, True, plan.split_floats)):
        if not len(entries):
            continue
        got = torch.full((2, out_h, out_w, c), float("nan"), device=cuda)
        want = got.clone()
        misses = B2.new_misses(cuda)
        B2.remap_windows(src, rot, got, entries, split=split, misses=misses,
                         window_floats=floats, **kw)
        B2.remap_windows_plain(src, rot, want, entries, split=split,
                               misses=B2.new_misses(cuda), **kw)
        torch.cuda.synchronize()
        assert int(misses) == 0
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    # The whole planned path equals B1's full frame bit for bit.
    misses = B2.new_misses(cuda)
    planned = remap_fused.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw)
    frame = B1.remap_tonemap(src, rot, **kw)
    torch.cuda.synchronize()
    assert int(misses) == 0
    assert torch.equal(planned.nan_to_num(7.0), frame.nan_to_num(7.0))
    assert torch.equal(torch.isnan(planned), torch.isnan(frame))
    assert B2.LAUNCHES == 2 and B1.LIST_LAUNCHES == int(len(plan.direct) > 0)
    assert B2.SPLIT_LAUNCHES == 2 * int(len(plan.split) > 0)


@pytest.mark.gpu
def test_out_of_window_reads_are_counted_on_card(cuda, launches):
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    kw = dict(in_lens=EQUIRECT, out_lens=L.Rectilinear(35.0, 36.0, 20.25), out_h=64, out_w=256,
              interp="bicubic", n_samples=1)
    src = torch.rand(1, 96, 192, 3, device=cuda)
    plan = P.make_plan(rot, in_h=96, in_w=192, channels=3, device=cuda, **kw)
    bad = plan.rescue[:1].clone()
    bad[0, 5] = 1
    got, want = B2.new_misses(cuda), B2.new_misses(cuda)
    out = torch.zeros(1, 64, 256, 3, device=cuda)
    B2.remap_windows(src, rot, out, bad, split=False, misses=got, window_floats=plan.rescue_floats,
                     **kw)
    B2.remap_windows_plain(src, rot, out.clone(), bad, split=False, misses=want, **kw)
    torch.cuda.synchronize()
    assert int(got) > 0 and int(got) == int(want)
