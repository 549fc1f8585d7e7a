"""The port's ``parallel/`` (mesh, sharded step) against the JAX package's.

On the CPU the port's mesh names the CPU device once for each position,
the counterpart of the 8 virtual CPU devices that ``tests/conftest.py``
gives JAX; the JAX step runs its XLA path there. Inputs come from a numpy
seed. Bounds against JAX: the BASELINE parity budget, max abs < 1e-3 and
p999 < 1e-4. Against the port's own single-device path: bit for bit, at
widths that are multiples of 32 (the CPU's vector loops then have no
scalar tails, whose libm differs in the last bit).

The JAX package is imported inside the tests that compare with it, so that
the ``gpu`` tests of this file also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_parallel.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import remap_fused
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2
from image_lens_reproject_torch.ops.cuda.build import COUNTS
from image_lens_reproject_torch.parallel import batch as pbatch
from image_lens_reproject_torch.parallel import mesh as pmesh

F = np.float32
CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def smooth_batch(b, h, w, c, seed=0):
    """The smooth batch of tests/test_sharding.py."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=F), np.linspace(0, 1, w, dtype=F), indexing="ij"
    )
    out = np.empty((b, h, w, c), dtype=F)
    for i in range(b):
        for j in range(c):
            a, bb, p = rng.uniform(0.5, 2.0, size=3)
            out[i, :, :, j] = 0.5 + 0.45 * np.sin(a * 4 * xx + bb * 3 * yy + p + i)
    return out


def _bounds(got, want):
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.max() < 1e-3
    assert np.quantile(err, 0.999) < 1e-4


def _jax_lens(lens):
    """The JAX package's lens equal to the port's ``lens``."""
    from image_lens_reproject_tpu.models import lens as JL

    return getattr(JL, type(lens).__name__)(**dataclasses.asdict(lens))


def _jax_step(src, rot, mesh_shape, in_lens, out_lens, **kw):
    """JAX's sharded_remap_step on the 8-device virtual CPU mesh."""
    import jax.numpy as jnp

    from image_lens_reproject_tpu.parallel import batch as jbatch
    from image_lens_reproject_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh(batch=mesh_shape[0], rows=mesh_shape[1])
    out = jbatch.sharded_remap_step(
        jbatch.shard_batch(jnp.asarray(src), mesh), None if rot is None else jnp.asarray(rot),
        mesh=mesh, in_lens=_jax_lens(in_lens), out_lens=_jax_lens(out_lens), **kw)
    return np.asarray(out)


def _port_step(src, rot, mesh_shape, in_lens, out_lens, **kw):
    mesh = pmesh.make_mesh([CPU] * (mesh_shape[0] * mesh_shape[1]), *mesh_shape)
    sharded = pbatch.shard_batch(torch.from_numpy(src), mesh)
    out = pbatch.sharded_remap_step(sharded, rot, mesh=mesh, in_lens=in_lens,
                                    out_lens=out_lens, **kw)
    return out.assemble().numpy()


EQUIRECT = L.full_equirectangular()
RECT = L.Rectilinear(35.0, 36.0, 27.0)

# The cases of tests/test_sharding.py: (mesh, batch shape, lenses, rotation, step options).
STEP_CASES = {
    **{f"mesh{b}x{r}": ((b, r), (b, 32, 64, 3), EQUIRECT, RECT, (15.0, -4.0, 2.0),
                        dict(out_h=24, out_w=48, interp="bilinear", n_samples=1))
       for b, r in MESHES},
    "nondivisible-out_h": ((2, 4), (2, 32, 64, 3), EQUIRECT, RECT, (10.0, 3.0, -2.0),
                           dict(out_h=30, out_w=48, interp="bilinear", n_samples=1)),
    "bicubic-wrap-tonemap": ((2, 4), (2, 40, 80, 4), EQUIRECT, RECT, None,
                             dict(out_h=32, out_w=32, interp="bicubic", n_samples=2,
                                  exposure=2.0, reinhard=4.0)),
    "tall-equisolid": ((2, 4), (2, 64, 64, 3), L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0),
                       EQUIRECT, (30.0, 10.0, 5.0),
                       dict(out_h=32, out_w=128, interp="bilinear", n_samples=1)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_step_matches_jax(case):
    mesh_shape, shape, in_lens, out_lens, angles, kw = STEP_CASES[case]
    src = smooth_batch(*shape, seed=sum(shape)) * (2.0 if shape[3] == 4 else 1.0)
    rot = None if angles is None else rotation_matrix_degrees(*angles)
    got = _port_step(src, rot, mesh_shape, in_lens, out_lens, **kw)
    want = _jax_step(src, rot, mesh_shape, in_lens, out_lens, **kw)
    assert got.shape == (shape[0], kw["out_h"], kw["out_w"], shape[3])
    _bounds(got, want)


@pytest.mark.parametrize("mesh_shape", MESHES + [(1, 3), (2, 3)])
def test_sharded_step_equals_the_single_device_path(mesh_shape):
    """Bit for bit: each band is computed by the same operations as the
    frame's rows. 3 rows: out_h = 20 pads to 21, and the source's 32 rows
    split only after padding to 33, which the step cuts back to in_h."""
    b, r = mesh_shape
    src = torch.from_numpy(np.random.default_rng(b + 10 * r).uniform(0, 2, (b, 32, 64, 3))
                           .astype(F))
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=20, out_w=64, interp="bicubic",
              n_samples=1, exposure=2.0, reinhard=4.0)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    want = remap_fused.remap_tonemap_batch(src, rot, **kw)
    padded = src
    if 32 % r:
        padded = torch.cat([src, src[:, -1:].expand(-1, (-32) % r, -1, -1)], dim=1)
    mesh = pmesh.make_mesh([CPU] * (b * r), b, r)
    out = pbatch.sharded_remap_step(pbatch.shard_batch(padded, mesh), rot, mesh=mesh, in_h=32,
                                    **kw)
    assert out.shape == (b, 20, 64, 3)
    for pos, idx in out.slices.items():
        assert torch.equal(out.shards[pos], want[idx])
    assert torch.equal(out.assemble(), want)


# --- the planned path inside each band (band_plans) -------------------------

EQUISOLID = L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)


def test_step_with_band_plans_matches_jax_rescue():
    """The configuration of tests/test_sharding.py's
    test_sharded_banded_kernel_with_rescue: rect 50 mm 64 x 64 ->
    equisolid 32 x 128, bilinear, mesh (1, 2). JAX runs K1 with the pass-2
    rescue (K2) inside each band, in interpret mode, its cap from
    size_rescue_cap; the port runs each band's plan. The BASELINE budget."""
    import jax.numpy as jnp

    from image_lens_reproject_tpu.ops.pallas import remap_kernel as RK
    from image_lens_reproject_tpu.parallel import batch as jbatch
    from image_lens_reproject_tpu.parallel import mesh as jmesh

    rect = L.Rectilinear(50.0, 36.0, 36.0)
    src = smooth_batch(1, 64, 64, 3, seed=7)
    kw = dict(out_h=32, out_w=128, interp="bilinear", n_samples=1)
    jkw = dict(kw, tile_rows=8, n_groups=2, rb=40, scan_unroll=8)
    import jax

    jm = jmesh.make_mesh(devices=jax.devices()[:2], batch=1, rows=2)
    cap = jbatch.size_rescue_cap(jm, in_lens=_jax_lens(rect), out_lens=_jax_lens(EQUISOLID),
                                 in_h=64, in_w=64, rotation=None, channels=3, **jkw)
    assert cap > 0, "JAX's rescue runs inside the bands"
    RK.set_interpret(True)
    try:
        want = np.asarray(jbatch.sharded_remap_step(
            jbatch.shard_batch(jnp.asarray(src), jm), None, mesh=jm,
            in_lens=_jax_lens(rect), out_lens=_jax_lens(EQUISOLID), rescue_cap=cap, **jkw))
    finally:
        RK.set_interpret(False)
    mesh = pmesh.make_mesh([CPU] * 2, 1, 2)
    plans = pbatch.band_plans(mesh, in_lens=rect, out_lens=EQUISOLID, in_h=64, in_w=64,
                              channels=3, rotation=None, **kw)
    assert [plans[(0, j)].band for j in (0, 1)] == [(0, 16), (16, 16)]
    assert all(len(p.split) == 0 for p in plans.values())
    misses = {pos: B2.new_misses(CPU) for pos in plans}
    got = pbatch.sharded_remap_step(pbatch.shard_batch(torch.from_numpy(src), mesh), None,
                                    mesh=mesh, in_lens=rect, out_lens=EQUISOLID, plans=plans,
                                    misses=misses, **kw).assemble().numpy()
    assert sum(int(m) for m in misses.values()) == 0
    _bounds(got, want)


@pytest.fixture
def midway_budget(monkeypatch):
    """Band plans whose window budget lies midway between the smallest and
    the largest window of the whole frame, so that the planned path's two
    lists get sub-tiles; records the first row of each plan made."""
    from image_lens_reproject_torch.ops import plan as P

    made = []

    def make_plan(rotation, **kw):
        made.append(kw["row_offset"])
        frame = {k: v for k, v in kw.items()
                 if k not in ("channels", "split", "row_offset", "row_count")}
        whole, _ = P.windows(rotation, **frame)
        floats = whole[..., 1] * whole[..., 3] * kw["channels"]
        budget = 4 * int(floats.min() + floats.max()) // 2
        return real(rotation, budget_bytes=budget, **kw)

    real = P.make_plan
    monkeypatch.setattr(P, "make_plan", make_plan)
    return made


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (1, 3), (2, 3)])
def test_step_with_plans_equals_the_step_without(midway_budget, mesh_shape):
    """Bit for bit: each position's planned band (B2 and B1 list mode's
    plain versions from the band's plan) gives B1 band mode's pixels, and
    one plan serves every position of a band on one device."""
    b, r = mesh_shape
    src = torch.from_numpy(np.random.default_rng(b + 10 * r).uniform(0, 2, (2 * b, 64, 128, 3))
                           .astype(F))
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    kw = dict(in_lens=EQUIRECT, out_lens=L.Rectilinear(35.0, 36.0, 36.0 * 44 / 256), out_h=44,
              out_w=256, interp="bicubic", n_samples=1, exposure=2.0, reinhard=4.0)
    padded = src
    if 64 % r:
        padded = torch.cat([src, src[:, -1:].expand(-1, (-64) % r, -1, -1)], dim=1)
    mesh = pmesh.make_mesh([CPU] * (b * r), b, r)
    plans = pbatch.band_plans(mesh, in_h=64, in_w=128, channels=3, rotation=rot,
                              **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w",
                                                    "interp", "n_samples")})
    band = -(-44 // r)
    assert midway_budget == [j * band for j in range(r)], "one plan a band on one device"
    assert {pos: p.band for pos, p in plans.items()} == {
        (i, j): (j * band, band) for i in range(b) for j in range(r)}
    sizes = [p.sizes() for p in plans.values()]
    assert all(s["split"] == 0 for s in sizes)
    assert sum(s["rescue"] for s in sizes) > 0 and sum(s["direct"] for s in sizes) > 0
    sharded = pbatch.shard_batch(padded, mesh)
    want = pbatch.sharded_remap_step(sharded, rot, mesh=mesh, in_h=64, **kw)
    misses = {pos: B2.new_misses(CPU) for pos in plans}
    got = pbatch.sharded_remap_step(sharded, rot, mesh=mesh, in_h=64, plans=plans, misses=misses,
                                    **kw)
    assert sum(int(m) for m in misses.values()) == 0
    for pos in want.shards:
        assert torch.equal(torch.isnan(got.shards[pos]), torch.isnan(want.shards[pos]))
        assert torch.equal(got.shards[pos].nan_to_num(7.0), want.shards[pos].nan_to_num(7.0))


def test_band_plans_one_for_each_band_and_device():
    """Positions of one band on one device share a plan; on another device
    the band has a plan of its own, on that device; a step refuses a plan
    of another band, and plans without counters."""
    devices = [torch.device("cpu", k) for k in (0, 1, 0, 1)]
    mesh = pmesh.make_mesh(devices, 2, 2)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, in_h=32, in_w=64, channels=3, out_h=24, out_w=128,
              interp="bilinear", rotation=None)
    plans = pbatch.band_plans(mesh, **kw)
    assert plans[(0, 0)] is plans[(1, 0)] and plans[(0, 1)] is plans[(1, 1)]
    assert plans[(0, 0)].band == (0, 12) and plans[(0, 1)].band == (12, 12)
    mesh = pmesh.make_mesh([torch.device("cpu", k) for k in range(4)], 2, 2)
    plans = pbatch.band_plans(mesh, **kw)
    assert len({id(p) for p in plans.values()}) == 4
    swapped = {(i, j): plans[(i, 1 - j)] for i, j in plans}
    sharded = pbatch.shard_batch(torch.zeros(2, 32, 64, 3), mesh)
    step = dict(mesh=mesh, **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w",
                                                 "interp")})
    misses = {pos: B2.new_misses(CPU) for pos in plans}
    with pytest.raises(ValueError, match="plan for rows"):
        pbatch.sharded_remap_step(sharded, None, plans=swapped, misses=misses, **step)
    with pytest.raises(ValueError, match="together"):
        pbatch.sharded_remap_step(sharded, None, plans=plans, **step)


SPLITS = [(None, None), (4, None), (None, 2), (2, 4), (8, 1), (1, 8)]


@pytest.mark.parametrize("batch,rows", SPLITS)
def test_make_mesh_matches_jax(batch, rows):
    import jax

    from image_lens_reproject_tpu.parallel import mesh as jmesh

    want = jmesh.make_mesh(batch=batch, rows=rows)
    devices = [torch.device("cpu", i) for i in range(8)]
    got = pmesh.make_mesh(devices, batch=batch, rows=rows)
    assert got.shape == dict(want.shape)
    assert [[d.index for d in row] for row in got.devices] == [
        [jax.devices().index(d) for d in row] for row in want.devices.tolist()]


@pytest.mark.parametrize("batch,rows", [(3, 3), (3, None), (None, 3), (16, 1)])
def test_make_mesh_errors_match_jax(batch, rows):
    from image_lens_reproject_tpu.parallel import mesh as jmesh

    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(batch=batch, rows=rows)
    with pytest.raises(ValueError) as got:
        pmesh.make_mesh([CPU] * 8, batch=batch, rows=rows)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
@pytest.mark.parametrize("helper", ["input", "output"])
def test_slices_match_jax_shardings(helper, mesh_shape):
    """Each position's slices are the index JAX's sharding gives its device."""
    import jax

    from image_lens_reproject_tpu.parallel import mesh as jmesh

    shape = (8, 32, 64, 3)
    jm = jmesh.make_mesh(batch=mesh_shape[0], rows=mesh_shape[1])
    sharding = jmesh.input_sharding(jm) if helper == "input" else jmesh.output_sharding(jm)
    want = sharding.devices_indices_map(shape)
    pm = pmesh.make_mesh([torch.device("cpu", i) for i in range(8)], *mesh_shape)
    got = (pmesh.input_slices if helper == "input" else pmesh.output_slices)(pm, shape)
    for (i, j), idx in got.items():
        jidx = want[jm.devices[i, j]]
        assert [(s.start, s.stop) for s in idx] == [
            (s.start or 0, s.stop or n) for s, n in zip(jidx[:2], shape)]
        assert all(s == slice(None) for s in jidx[2:])
    assert jax.device_count() == 8


def test_output_slices_cut_at_out_h():
    """ceil(5 / 4) = 2-row bands: the third is cut to one row, the fourth empty."""
    mesh = pmesh.make_mesh([CPU] * 4, 1, 4)
    rows = [idx[1] for _, idx in sorted(pmesh.output_slices(mesh, (1, 5, 8, 3)).items())]
    assert [(s.start, s.stop) for s in rows] == [(0, 2), (2, 4), (4, 5), (5, 5)]


@pytest.mark.parametrize("n,m", [(0, 4), (3, 4), (8, 4), (9, 1), (30, 8)])
def test_pad_to_multiple_matches_jax(n, m):
    from image_lens_reproject_tpu.parallel import mesh as jmesh

    assert pmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def test_shard_then_assemble_is_the_batch():
    src = torch.from_numpy(np.random.default_rng(5).uniform(0, 2, (4, 16, 8, 3)).astype(F))
    mesh = pmesh.make_mesh([CPU] * 8, 2, 4)
    sharded = pbatch.shard_batch(src, mesh)
    assert {tuple(t.shape) for t in sharded.shards.values()} == {(2, 4, 8, 3)}
    assert all(t.is_contiguous() for t in sharded.shards.values())
    assert torch.equal(sharded.assemble(), src)


def test_shard_and_step_check_their_arguments():
    src = torch.zeros((3, 16, 8, 3))
    mesh = pmesh.make_mesh([CPU] * 4, 2, 2)
    with pytest.raises(ValueError, match="does not split"):
        pbatch.shard_batch(src, mesh)
    sharded = pbatch.shard_batch(src[:2], mesh)
    with pytest.raises(ValueError, match="another mesh"):
        pbatch.sharded_remap_step(sharded, None, mesh=pmesh.make_mesh([CPU] * 4, 4, 1),
                                  in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4)


def test_visible_devices():
    assert pmesh.visible_devices("cpu") == [CPU]
    with pytest.raises(ValueError):
        pmesh.visible_devices("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.visible_devices()
    else:
        assert len(pmesh.visible_devices()) == torch.cuda.device_count()


def test_mesh_shape_and_positions():
    mesh = pmesh.make_mesh([torch.device("cpu", i) for i in range(6)], batch=3)
    assert mesh.shape == {pmesh.BATCH_AXIS: 3, pmesh.ROWS_AXIS: 2}
    assert mesh.positions() == mesh.local_positions() == [(i, j) for i in range(3)
                                                          for j in range(2)]
    assert mesh.devices[2][1] == torch.device("cpu", 5)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA only and this machine has no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 1), (1, 4), (1, 3)])
def test_sharded_step_on_card_equals_the_frame(cuda, mesh_shape):
    """The step on a mesh that names cuda:0 at every position equals B1's
    frame bit for bit, through B1's band mode where the mesh has rows."""
    b, r = mesh_shape
    src = torch.from_numpy(np.random.default_rng(7).uniform(0, 2, (4, 48, 96, 3)).astype(F))
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=50, out_w=72, interp="bicubic",
              n_samples=1, exposure=2.0, reinhard=4.0)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    want = B1.remap_tonemap(src.to(cuda), rot, **kw).cpu()
    mesh = pmesh.make_mesh([cuda] * (b * r), b, r)
    before = COUNTS["b1.band"]
    out = pbatch.sharded_remap_step(pbatch.shard_batch(src, mesh), rot, mesh=mesh, **kw)
    got = out.assemble()
    assert COUNTS["b1.band"] - before == (0 if r == 1 else b * r)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (1, 3)])
def test_step_with_band_plans_on_card_equals_the_frame(cuda, mesh_shape):
    """With band plans on a mesh naming cuda:0 at every position: B2's band
    mode and B1 list mode's fill each band, equal to B1's frame bit for
    bit, the misses of every position summed to 0."""
    b, r = mesh_shape
    src = torch.from_numpy(np.random.default_rng(9).uniform(0, 2, (2 * b, 252, 256, 3))
                           .astype(F))
    rot = rotation_matrix_degrees(30.0, 10.0, 5.0)
    kw = dict(in_lens=EQUISOLID, out_lens=EQUIRECT, out_h=100, out_w=512, interp="bilinear",
              n_samples=1)
    want = B1.remap_tonemap(src.to(cuda), rot, **kw).cpu()
    mesh = pmesh.make_mesh([cuda] * (b * r), b, r)
    plans = pbatch.band_plans(mesh, in_h=252, in_w=256, channels=3, rotation=rot, **kw)
    assert len({id(p) for p in plans.values()}) == r
    misses = {pos: B2.new_misses(cuda) for pos in plans}
    before = COUNTS["b2.band"], COUNTS["b1.list_band"], COUNTS["b2.split"]
    got = pbatch.sharded_remap_step(pbatch.shard_batch(src, mesh), rot, mesh=mesh, plans=plans,
                                    misses=misses, **kw).assemble()
    assert sum(int(m.item()) for m in misses.values()) == 0
    assert COUNTS["b2.split"] == before[2]
    if r > 1:
        assert COUNTS["b2.band"] > before[0]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
