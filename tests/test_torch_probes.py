"""The probe kernels' wrappers (image_lens_reproject_torch/probes/) against the JAX probes K4-K8.

K4-K8 are the Pallas kernels of the JAX package's hardware probes:
``bench/dma_probe.py`` (K4 ``build``, K5 ``build_db``),
``bench/gather_cost_probe.py`` (K6), ``bench/roll_probe.py`` (K7) and
``bench/ww2_probe.py`` (K8, two kernels). Each runs here as the probe runs
with ``--interpret``: on the CPU, in interpret mode. The probe files are
loaded by path and left as they are. K4, K5 and K7 come from ``build(True)``
/ ``build_db(True, 4)``. K6 and K8 build their kernels inside ``main()``, so
``pallas_call`` is wrapped (forced into interpret mode) while ``main()``
runs, and each kernel's inputs and output are captured.

On the CPU each wrapper runs its plain version because the tensor lies on
the CPU, and on the same inputs it must give the JAX kernel's output. The
tests that launch the kernels carry the ``gpu`` marker; they import no JAX,
so that ``python -m pytest --noconftest -m gpu tests/test_torch_probes.py``
runs them where JAX is not installed.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from image_lens_reproject_torch import probes
from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import plan as P
from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts
from image_lens_reproject_torch.probes import dma_probe as DP
from image_lens_reproject_torch.probes import gather_cost_probe as GC
from image_lens_reproject_torch.probes import roll_probe as RP
from image_lens_reproject_torch.probes import ww2_probe as WW

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


def _bench(name):
    """``bench/<name>.py``, loaded by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"bench_probe_{name}", ROOT / "bench" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool(name):
    """``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(mod, **attrs):
    """Runs ``mod.main()`` with ``attrs`` set on the module and every
    ``pallas_call`` forced into interpret mode; returns ``main``'s result
    and, per ``pallas_call`` in order, the first call's (inputs, output)."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    calls = []

    def interpreted(kernel, **kw):
        f = real(kernel, **dict(kw, interpret=True))
        record = []
        calls.append(record)

        def call(*args):
            out = f(*args)
            if not record:
                record.append(([np.array(a) for a in args], np.array(out)))
            return out

        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpreted)
        for name, value in attrs.items():
            mp.setattr(mod, name, value)
        rc = mod.main()
    return rc, [record[0] for record in calls]


# --- K4, K5: windows at dynamic offsets ------------------------------------

EDGE_OFFS = DP.EDGE_OFFS


@pytest.fixture(scope="module")
def dma_jax():
    import jax.numpy as jnp

    mod = _bench("dma_probe")
    copy, scan = mod.build(True), mod.build_db(True, DP.N_STEPS)

    def run(fn, src, offs):
        return np.asarray(fn(jnp.asarray(src), jnp.asarray(offs)))

    return lambda src, offs: run(copy, src, offs), lambda src, offs: run(scan, src, offs)


@pytest.mark.parametrize("table", ["probe", "edges"])
def test_window_copy_matches_k4(dma_jax, table):
    """The probe's 64 tiles, and starts past every edge (moved into the
    source as the interpret mode moves them): bit for bit."""
    _, src, offs, _ = DP.check_inputs()
    offs = offs if table == "probe" else EDGE_OFFS
    got = DP.window_copy(T(src), T(offs)).numpy()
    np.testing.assert_array_equal(got, dma_jax[0](src, offs))
    assert COUNTS["probes.window_copy"] == 0


@pytest.mark.parametrize("table", ["probe", "edges"])
def test_window_scan_db_matches_k5(dma_jax, table):
    """The 4-step double-buffered scan: the same sums in the same order."""
    _, src, _, offs_db = DP.check_inputs()
    offs = offs_db if table == "probe" else EDGE_OFFS
    got = DP.window_scan_db(T(src), T(offs), DP.N_STEPS).numpy()
    np.testing.assert_array_equal(got, dma_jax[1](src, offs))
    assert COUNTS["probes.window_scan_db"] == 0


# --- K7: a dynamic roll per tile --------------------------------------------


@pytest.mark.parametrize("shifts", ["probe", "wide"])
def test_lane_roll_matches_k7(shifts):
    import jax.numpy as jnp

    _, x, sh = RP.check_inputs()
    if shifts == "wide":  # shifts up to and past the tile's width
        sh = np.array([0, 255, 256, 300, 128] * 6 + [1, 2], np.int32)
    want = np.asarray(_bench("roll_probe").build(True)(jnp.asarray(x), jnp.asarray(sh[None])))
    np.testing.assert_array_equal(RP.lane_roll(T(x), T(sh)).numpy(), want)
    assert COUNTS["probes.lane_roll"] == 0


def _k7(h, w):
    """K7 (``bench/roll_probe.py``'s ``build(True)``) for (h, w) tiles: the
    module's tile shape set before it builds, the file left as it is."""
    mod = _bench("roll_probe")
    mod.H, mod.W = h, w
    return mod.build(True)


def _np_roll(x, sh):
    return np.stack([np.roll(x[i], -int(sh[i]), axis=1) for i in range(x.shape[0])])


@pytest.mark.parametrize("w", RP.EDGE_W)
@pytest.mark.parametrize("h", RP.EDGE_H)
def test_lane_roll_matches_k7_on_edge_shapes(h, w):
    """Widths that are and are not multiples of 4, rows that do and do not
    fill a unit; shifts from 0 to 2w (K7 takes no negative shift, its
    source warns that they miscompile on hardware): the wrapper on the CPU
    and the plain version give K7's output bit for bit."""
    import jax.numpy as jnp

    sh = np.array([0, 1, w - 1, w, w + 1, 2 * w], np.int32)
    x = np.random.default_rng(h * 1000 + w).random((sh.size, h, w), np.float32)
    want = np.asarray(_k7(h, w)(jnp.asarray(x), jnp.asarray(sh[None])))
    np.testing.assert_array_equal(want, _np_roll(x, sh))
    np.testing.assert_array_equal(RP.lane_roll(T(x), T(sh)).numpy(), want)
    np.testing.assert_array_equal(RP.lane_roll_plain(T(x), T(sh)).numpy(), want)
    assert COUNTS["probes.lane_roll"] == 0


@pytest.mark.parametrize("w", RP.EDGE_W)
@pytest.mark.parametrize("h", RP.EDGE_H)
def test_lane_roll_matches_np_roll_on_every_shift(h, w):
    """Every kind of ``edge_shifts``: negative, 0, w - 1, w, past w and the
    int32 extremes, one tile a shift and all in one call, against
    ``np.roll``."""
    x, sh = RP.edge_inputs(len(RP.edge_shifts(w)) + 3, h, w, "cpu", seed=w)
    assert sh.numpy()[:len(RP.edge_shifts(w))].tolist() == RP.edge_shifts(w)
    np.testing.assert_array_equal(RP.lane_roll(x, sh).numpy(), _np_roll(x.numpy(), sh.numpy()))
    for i in range(x.shape[0]):
        np.testing.assert_array_equal(RP.lane_roll(x[i:i + 1], sh[i:i + 1]).numpy(),
                                      _np_roll(x[i:i + 1].numpy(), sh[i:i + 1].numpy()))
    assert COUNTS["probes.lane_roll"] == 0


@pytest.mark.parametrize("n, h, w, x_off, out_off, vec, units", [
    (2048, 80, 256, 0, 0, True, 2048 * 20 * 2),  # the probe: 40,960 units, float4s
    (32, 80, 256, 0, 0, True, 32 * 20 * 2),
    (1, 1, 4, 0, 0, True, 1),  # one float4: one unit
    (2048, 81, 256, 0, 0, True, 2048 * 21 * 2),  # the last unit of 4 rows holds 1
    (1, 7, 250, 0, 0, False, 2 * 8),  # w % 4 != 0: floats, 2 x 8 units
    (2048, 80, 257, 0, 0, False, 2048 * 20 * 9),  # 257 floats: 9 units across
    (3, 80, 256, 4, 0, False, 3 * 20 * 8),  # x off a 16-byte boundary
    (3, 80, 256, 0, 8, False, 3 * 20 * 8),  # out off a 16-byte boundary
    (5, 3, 3, 0, 0, False, 5),
])
def test_lane_roll_launch_plan(n, h, w, x_off, out_off, vec, units):
    """The host's choice: the float4 instance only for whole float4s a row
    on 16-byte boundaries; the units of 4 rows x 32 elements the kernel
    gives a warp each."""
    assert RP.vector_instance(w, 1024 + x_off, 4096 + out_off) == vec
    assert RP.units(n, h, w, vec) == units


@pytest.mark.parametrize("n, h, w, refused", [
    (1, 1, 2**30, None),  # the widest row: a source column below 2 w < 2**31
    (1, 1, 2**30 + 1, "wider"),
    (1, 4, 2**30 + 4, "wider"),  # float4s would fit, the float instance would not
    (2**31 - 1, 1, 1, None),  # 2**31 - 1 units
    (2**31, 1, 1, "units"),
    (2**20, 4100, 1, None),  # 1.07e9 units, 17 GB: taken, a warp a unit
    (2**20, 8192, 1, "units"),  # 2**31 units
    (1, 2**31, 1, "units"),
])
def test_lane_roll_refuses_what_32_bits_cannot_index(n, h, w, refused):
    """The wrapper's limits at the real 2**31 and 2**30, without a tensor."""
    why = RP.refusal(n, h, w)
    assert why is None if refused is None else refused in why


def test_lane_roll_takes_views_off_16_byte_boundaries():
    """A contiguous view 4 bytes past a boundary gets the float instance on
    the card, and the same answer."""
    _, x, sh = RP.check_inputs()
    moved = _shifted(T(x))
    assert moved.data_ptr() % 16 == 4 and not RP.vector_instance(256, moved.data_ptr(), 0)
    np.testing.assert_array_equal(RP.lane_roll(moved, T(sh)).numpy(), _np_roll(x, sh))
    assert COUNTS["probes.lane_roll"] == 0


def test_lane_roll_refuses_more_units_than_32_bits_count(monkeypatch):
    _, x, sh = RP.check_inputs()
    monkeypatch.setattr(RP, "INT32_LIMIT", RP.units(*x.shape, False))
    with pytest.raises(ValueError, match="units"):
        RP.lane_roll(T(x), T(sh))
    monkeypatch.setattr(RP, "INT32_LIMIT", RP.units(*x.shape, False) + 1)
    RP.lane_roll(T(x), T(sh))


def test_lane_roll_refuses_widths_past_its_limit(monkeypatch):
    _, x, sh = RP.check_inputs()
    monkeypatch.setattr(RP, "WIDTH_LIMIT", x.shape[2] - 1)
    with pytest.raises(ValueError, match="wider"):
        RP.lane_roll(T(x), T(sh))
    monkeypatch.setattr(RP, "WIDTH_LIMIT", x.shape[2])
    RP.lane_roll(T(x), T(sh))


def test_lane_roll_edge_cases_cover_every_shape_and_shift():
    """chip_smoke.py's and the card tests' edge calls: n = 1 once for each
    shift kind, n = 2048 once, on every (h, w)."""
    shapes = {}
    for x, sh in RP.edge_cases("cpu"):
        shapes.setdefault(tuple(x.shape), []).extend(sh.tolist())
    assert len(shapes) == len(RP.EDGE_N) * len(RP.EDGE_H) * len(RP.EDGE_W)
    for (n, h, w), kinds in shapes.items():
        if n == 1:
            assert kinds == RP.edge_shifts(w)
        else:
            assert n == RP.BIG_TILES and kinds[:len(RP.edge_shifts(w))] == RP.edge_shifts(w)


# --- K8: the windowed tap gather, both JAX kernels ---------------------------


@pytest.fixture(scope="module")
def ww2_cases():
    """K8's ten captured calls (the six two-step cases, then the four drift
    cases), in the probe's order; ~35 s of interpret mode, once a worker."""
    rc, calls = _capture(_bench("ww2_probe"), INTERPRET=True)
    assert rc == 0 and len(calls) == len(WW.CASES)
    return calls


@pytest.mark.parametrize("case", range(len(WW.CASES)), ids=[c[0] for c in WW.CASES])
def test_window_gather_matches_k8(ww2_cases, case):
    """One function serves both JAX kernels. 1e-5 abs, the probe's own limit:
    the JAX kernels sum the taps in other orders (m outer in the two-step
    kernel; by drift-selected columns in the other)."""
    (win, y0, x0, wx, wy), want = ww2_cases[case]
    channels = want.shape[0]
    # The probe's inputs, drawn again from its seed, are the ones captured.
    name, _, inputs = list(WW.cases())[case]
    assert name == WW.CASES[case][0]
    for a, b in zip(inputs, (win, y0, x0, wx, wy)):
        np.testing.assert_array_equal(a, b)
    got = WW.window_gather(T(win), T(y0), T(x0), T(wx), T(wy), channels).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= WW.TOLERANCE
    assert COUNTS["probes.window_gather"] == 0


# --- K6: per-op-class chains ------------------------------------------------

K6_SMALL, K6_BIG = 2, 4


@pytest.fixture(scope="module")
def k6_calls():
    """K6's ten captured calls: each op class at 2 and at 4 trips."""
    rc, calls = _capture(_bench("gather_cost_probe"), SMALL=K6_SMALL, BIG=K6_BIG, REPS=1)
    assert rc == 0 and len(calls) == 2 * len(GC.OPS)
    return calls


@pytest.mark.parametrize("iters", [K6_SMALL, K6_BIG])
@pytest.mark.parametrize("op", GC.OPS)
def test_op_cost_matches_k6(k6_calls, op, iters):
    """select, the roll and both gathers exactly. fma to 1e-6 relative:
    XLA's CPU backend contracts ``v * 1.000001 + 0.5`` into one fused
    multiply-add, rounded once, where the port rounds the multiply and the
    add apart (as the card's plain version and the kernel, built with
    -fmad=false, do); a chain rounded once per step reproduces the JAX
    output bit for bit here, and 64 steps move it by a few ulps."""
    (x, idx), want = k6_calls[2 * GC.OPS.index(op) + (iters == K6_BIG)]
    x0, idx0 = GC.check_inputs()
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(idx, idx0)
    got = GC.op_cost(T(x0), T(idx0), op, iters)[0].numpy()
    if op == "fma":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    assert COUNTS["probes.op_cost"] == 0


def test_op_cost_fma_rounds_twice():
    """The plain fma chain is a multiply and an add, each rounded to float32."""
    x, idx = GC.check_inputs()
    chains = [x[0] + np.float32(c) for c in range(GC.CHAINS)]
    for c in range(GC.CHAINS):
        for _ in range(GC.UNROLL):
            chains[c] = chains[c] * np.float32(1.000001) + np.float32(0.5)
    want = ((chains[0] + chains[1]) + chains[2]) + chains[3]
    got = GC.op_cost(T(x), T(idx), "fma", 1)[0].numpy()
    np.testing.assert_array_equal(got, want)



# --- K6's layouts on the card, transcribed in numpy --------------------------

WARP = 32


def _roll_through_shuffles(v):
    """One op of ``op_cost<lane_roll>`` on ``v`` (rows, 128), as the kernel
    does it: lane l of the chain's warp holds columns l, l + 32, l + 64 and
    l + 96 (``reg[l, r, m]`` = column 32 m + l); lane 31 sends its previous
    column register (``reg[l, r, m - 1]``), every other lane ``reg[l, r, m]``;
    each lane takes what lane (l - 1) mod 32 sent."""
    rows = v.shape[0]
    reg = v.reshape(rows, 128 // WARP, WARP).transpose(2, 0, 1)
    lanes = np.arange(WARP)
    send = np.where((lanes == WARP - 1)[:, None, None], np.roll(reg, 1, axis=2), reg)
    return send[(lanes - 1) % WARP].transpose(1, 2, 0).reshape(rows, 128)


def _sublane_gather_through_shared(v, k):
    """One op of ``op_cost<sublane_gather>`` on ``v`` (chains, 8, 128), with
    the int32 keys ``k`` (8, 128), as the kernel does it: thread j stores its
    column at word ``(c * 8 + r) * 128 + j`` of shared memory, then loads row
    ``k & 7`` back for each row. Returns the values and the bank (word mod
    32) of every load, (chains, 8, 128)."""
    chains = v.shape[0]
    shared = np.empty(chains * 8 * 128, dtype=v.dtype)
    c, r, j = np.meshgrid(np.arange(chains), np.arange(8), np.arange(128), indexing="ij")
    shared[(c * 8 + r) * 128 + j] = v
    word = (c * 8 + (k[None] & 7)) * 128 + j
    return shared[word], word % 32


ROLL_TILES = {
    "probe": lambda rng: GC.check_inputs()[0][0],
    "random": lambda rng: rng.uniform(-1, 1, (8, 128)).astype(np.float32),
    "column ids": lambda rng: np.arange(8 * 128, dtype=np.float32).reshape(8, 128),
}


@pytest.mark.parametrize("steps", [1, 129])
@pytest.mark.parametrize("tile", list(ROLL_TILES))
def test_lane_roll_layout_rolls_by_one_lane(tile, steps):
    """The kernel's warp-a-chain layout, one shuffle an element and lane
    31's previous register, rolls every row by one lane, as ``torch.roll``
    (the plain version) does, step after step."""
    v = ROLL_TILES[tile](np.random.default_rng(17))
    got, want = v, T(v)
    for _ in range(steps):
        got = _roll_through_shuffles(got)
        want = torch.roll(want, 1, dims=-1)
    np.testing.assert_array_equal(got, want.numpy())


SUBLANE_KEYS = {
    "probe": lambda rng: GC.check_inputs()[1][0],
    "random": lambda rng: rng.integers(-200, 200, (8, 128)).astype(np.int32),
    "int32 extremes": lambda rng: rng.choice(
        np.array([-2**31, -9, -8, -1, 0, 7, 8, 2**31 - 1], dtype=np.int32), (8, 128)),
}


@pytest.mark.parametrize("keys", list(SUBLANE_KEYS))
def test_sublane_gather_through_shared_memory(keys):
    """The kernel's store-then-load of each column through shared memory
    gathers ``v[k mod 8]`` in every row, as the plain version's
    ``torch.gather`` does, op after op; and each warp's 32 loads of a row
    hit 32 distinct banks, whatever the keys."""
    rng = np.random.default_rng(19)
    k = SUBLANE_KEYS[keys](rng)
    v = rng.uniform(0, 1, (GC.CHAINS, 8, 128)).astype(np.float32)
    want = T(v)
    index = torch.remainder(T(k), 8).long().expand(want.shape)
    for _ in range(3):
        v, banks = _sublane_gather_through_shared(v, k)
        want = torch.gather(want, 1, index)
        np.testing.assert_array_equal(v, want.numpy())
        warps = banks.reshape(GC.CHAINS, 8, 128 // WARP, WARP)
        assert (np.sort(warps, axis=-1) == np.arange(WARP)).all()


def test_trip_loop_census():
    """tools/b1_breakdown.py counts op_cost's trip loop, the longest backward
    branch's body, by class and by opcode, whichever way the branch names
    its target."""
    tool = _tool("b1_breakdown")
    listing = """        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0010*/                   MOV R5, 0x3f800000 ;
.L_x_0:
        /*0020*/                   STS [R3], R2 ;
        /*0030*/                   LDS R4, [R6+0x200] ;
        /*0040*/               @P0 FSEL R2, R4, R5, P1 ;
        /*0050*/                   SHFL.IDX PT, R7, R4, R8, 0x1f ;
        /*0060*/               @P2 BRA `(.L_x_0) ;
        /*0070*/                   ISETP.NE.AND P0, PT, R9, RZ, PT ;
        /*0080*/                   BRA.U !UP0, 0x70 ;
        /*0090*/                   EXIT ;""".splitlines()
    body = tool.trip_loop(listing)
    assert len(body) == 5 and "STS" in body[0] and "BRA" in body[-1]
    counts = tool.class_counts(body, tool.K6_OPCODES)
    assert counts == {"store": 1, "op STS": 1, "load": 1, "op LDS": 1, "select": 1,
                      "op FSEL": 1, "shuffle": 1, "op SHFL": 1, "branch": 1, "total": 5}
    assert tool.op_class("_ZN12_GLOBAL__N_17op_costILi3EEEvPKfPKiiPf") == "sublane_gather"
    assert tool.ptxas_smem("ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
                           "ptxas info    : Used 40 registers, used 1 barriers, 16384 bytes "
                           "smem, 380 bytes cmem[0]") == {"k": 16384}


# --- the entry points with --device cpu -------------------------------------

ENTRY_LINES = {
    DP: ("simple DMA window: max err 0.00e+00 OK", "double-buffered scan: max err 0.00e+00 OK",
         probes.NOT_MEASURED),
    RP: ("dynamic lane roll: max err 0.00e+00 OK", probes.NOT_MEASURED),
    GC: ('{"op": "lane_gather", "max_err": 0.0, "ok": true}', probes.NOT_MEASURED,
         "RESULT: PASS"),
    WW: ('{"name": "DRIFT bilinear C4 g2", "max_err": 0.0, "ok": true}', "RESULT: PASS"),
}


@pytest.mark.parametrize("mod", list(ENTRY_LINES), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_point_on_cpu(mod, capsys):
    """``--device cpu``: the probe's checks through the plain versions, no time."""
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    for line in ENTRY_LINES[mod]:
        assert line in out
    assert not any("ns/" in line or "ns_per" in line for line in out)


def test_entry_point_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        RP.main([])


def test_entry_point_fails_on_a_wrong_result(monkeypatch, capsys):
    monkeypatch.setattr(RP, "lane_roll_plain", lambda x, s: x)
    assert RP.main(["--device", "cpu"]) == 1
    assert "FAIL" in capsys.readouterr().out


# --- the wrappers' checks ----------------------------------------------------


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    _, src, offs, _ = DP.check_inputs()
    with pytest.raises(TypeError, match="float32"):
        DP.window_copy(T(src).double(), T(offs))
    with pytest.raises(TypeError, match="int32"):
        DP.window_copy(T(src), T(offs).long())
    with pytest.raises(ValueError, match="at least"):
        DP.window_copy(T(src)[:8], T(offs))
    with pytest.raises(ValueError, match="contiguous"):
        DP.window_copy(T(src)[:, ::2], T(offs))
    with pytest.raises(ValueError, match="n_steps"):
        DP.window_scan_db(T(src), T(offs), 0)
    _, x, sh = RP.check_inputs()
    with pytest.raises(ValueError, match="shifts"):
        RP.lane_roll(T(x), T(sh[:-1]))
    x6, idx6 = GC.check_inputs()
    with pytest.raises(ValueError, match="op"):
        GC.op_cost(T(x6), T(idx6), "lane_shuffle", 1)
    with pytest.raises(ValueError, match=r"\(n, 8, 128\)"):
        GC.op_cost(T(x6)[:, :4], T(idx6)[:, :4], "fma", 1)
    _, channels, inputs = next(WW.cases())
    win, y0, x0, wx, wy = (T(a) for a in inputs)
    with pytest.raises(ValueError, match="taps"):
        WW.window_gather(win, y0, x0, torch.cat([wx, wx]), torch.cat([wy, wy]), channels)
    with pytest.raises(ValueError, match="taps"):
        WW.window_gather(win, y0, x0, wx[:3].contiguous(), wy[:3].contiguous(), channels)
    with pytest.raises(ValueError, match="shared memory"):
        WW.window_gather(torch.zeros(4, 8, 8192), y0, x0, wx, wy, channels)
    with pytest.raises(ValueError, match="y0/x0"):
        WW.window_gather(win, y0[:, :4].contiguous(), x0, wx, wy, channels)


def _shifted(t):
    """``t``'s values in a contiguous view that starts 4 bytes past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def test_the_gather_launcher_picks_its_path_from_the_shapes():
    """window_gather stages every window with 16-byte cp.async from the
    16-byte boundary below it, so its shared memory is the window's size
    and up to 3 floats more, whatever the base; the edge cases hold a
    window size and a base off 16-byte boundaries. The plain versions answer
    the same on every layout (window_scan_db's kernel reads every source
    the same way)."""
    _, src, offs, _ = DP.check_inputs()
    src = T(src)
    moved = DP.edge_source(src, "unaligned base")
    assert moved.data_ptr() % 16 == 4
    assert DP.edge_source(src, "odd width").shape[1] % 4 == 1
    np.testing.assert_array_equal(DP.window_scan_db(moved, T(offs), 7).numpy(),
                                  DP.window_scan_db(src, T(offs), 7).numpy())
    assert COUNTS["probes.window_scan_db"] == 0
    assert WW.staged_bytes(8, 128) == 4 * 1028
    assert WW.staged_bytes(5, 127) == 4 * 640
    assert WW.staged_bytes(8, 7000) == 224016
    assert WW.staged_bytes(8, 7000) <= WW.MAX_SHARED_BYTES < WW.staged_bytes(8, 7400)
    rng = np.random.default_rng(0)
    layouts = {label: WW.edge_inputs(rng, label, 2, "cpu")[0] for label in WW.EDGE_CASES}
    assert layouts["5 x 127 windows"][0].numel() % 4 and layouts["unaligned base"].data_ptr() % 16
    _, channels, inputs = next(WW.cases())
    inputs = [T(a) for a in inputs]
    want = WW.window_gather(*inputs, channels)
    np.testing.assert_array_equal(WW.window_gather(_shifted(inputs[0]), *inputs[1:], channels),
                                  want)
    assert COUNTS["probes.window_gather"] == 0


def test_wrappers_raise_on_layouts_the_kernels_do_not_take():
    """window_gather loads 4 pixels' origins and weights with one 16-byte
    load, and indexes in 32 bits; window_scan_db needs a step."""
    _, channels, inputs = next(WW.cases())
    win, y0, x0, wx, wy = (T(a) for a in inputs)
    for i, what in ((1, "y0"), (2, "x0"), (3, "wx"), (4, "wy")):
        args = [win, y0, x0, wx, wy]
        args[i] = _shifted(args[i])
        with pytest.raises(ValueError, match=f"{what} must start on a 16-byte boundary"):
            WW.window_gather(*args, channels)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        WW.window_gather(win, y0, x0, wx, wy, 2**30)
    with pytest.raises(ValueError, match="shared memory"):
        WW.window_gather(torch.zeros(4, 8, 7400), y0, x0, wx, wy, channels)
    _, src, offs, _ = DP.check_inputs()
    for steps in (0, -3):
        with pytest.raises(ValueError, match="n_steps"):
            DP.window_scan_db(T(src), T(offs), steps)
    assert COUNTS["probes.window_gather"] == 0 and COUNTS["probes.window_scan_db"] == 0


def test_probe_library_sources_exist():
    for name in probes.SOURCES:
        assert (ROOT / "image_lens_reproject_torch" / "csrc" / name).is_file()
    assert set(probes._SIGNATURES) == {
        "ilr_window_copy", "ilr_window_scan_db", "ilr_lane_roll", "ilr_op_cost",
        "ilr_window_gather"}


def test_tma_repro_runs_each_mode_of_its_source():
    """tools/tma_repro.py runs every mode that tools/tma_repro.cu launches,
    each in a process of its own, and needs a card."""
    tool = _tool("tma_repro")
    text = (ROOT / "tools" / "tma_repro.cu").read_text()
    launched = re.findall(r"case (\d+):", text)
    assert launched == [m for m in tool.MODES if m.isdigit()] == [str(m) for m in range(8)]
    assert {case[0] for case in tool.CASES} == set(tool.MODES)
    # Mode 1 copies whole rows with 16-byte bulk copies: only at a column on a 16-byte boundary.
    assert all(col % 4 == 0 for mode, _, _, col in tool.CASES if mode == "1")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            tool.main([])


# --- chip_smoke.py's bounds --------------------------------------------------


def test_bound_counts():
    """The byte and instruction counts behind the kernels line's ``bound_ms``."""
    # B1 at the headline's output if its taps read 200000 texels: 3 channels each.
    n_bytes, n_instr = chip_smoke.remap_counts(200_000, 3, 2160 * 3840, "bicubic")
    assert n_bytes == 4 * 3 * (200_000 + 2160 * 3840) == 101_932_800
    assert n_instr == 2 * 2160 * 3840 * 3 * 16
    ms, by = chip_smoke.bound(n_bytes, n_instr)
    assert by == "bytes" and ms == pytest.approx(101_932_800 / 3.35e12 * 1e3)
    # A list of sub-tiles: its int32 entries too.
    assert chip_smoke.remap_counts(10, 3, 1024, "nearest", extra_bytes=4 * 6) == (
        4 * 3 * (10 + 1024) + 24, 2 * 1024 * 3)
    # K4 / K5 at 2048 tiles whose windows cover 500 source values.
    assert chip_smoke.window_counts(500, 2048) == (4 * (500 + 4096 + 2048 * 2048), 2048 * 2048)
    assert chip_smoke.window_counts(500, 2048, 4)[1] == 4 * 2048 * 2048
    # K8 at 8100 sub-tiles, bicubic, C = 3, 1000 window values read a sub-tile.
    n_bytes, n_instr = chip_smoke.gather_counts(8100 * 1000, 8100, 4, 3)
    assert n_bytes == 4 * 8100 * (1000 + 1024 * (2 + 8 + 3))
    assert n_instr == 3 * 3 * 8100 * 1024 * 16
    assert chip_smoke.bound(n_bytes, n_instr)[1] == "bytes"
    # K6, each class at the unit it is meant to saturate: fma 2 instructions an
    # element an op (-fmad=false), select 1, sublane_gather its 7-select tree;
    # lane_roll one 4-byte lane exchange (a shuffle), lane_gather's arbitrary
    # permutation a 4-byte store and a 4-byte load of shared memory.
    elems = 528 * 1024
    ops = elems * 256 * 4 * 16
    extra = elems * (4 + 256 * 4 + 3)  # chain starts, trip folds, final sums
    assert chip_smoke.op_cost_counts("fma", 528, 256) == (12 * elems, extra + 2 * ops, 0)
    assert chip_smoke.op_cost_counts("select", 528, 256)[1:] == (extra + ops, 0)
    assert chip_smoke.op_cost_counts("sublane_gather", 528, 256)[1:] == (extra + 7 * ops, 0)
    assert chip_smoke.op_cost_counts("lane_gather", 528, 256) == (12 * elems, extra, 8 * ops)
    assert chip_smoke.op_cost_counts("lane_roll", 528, 256) == (12 * elems, extra, 4 * ops)
    assert chip_smoke.bound(*chip_smoke.op_cost_counts("fma", 528, 256))[1] == "operations"
    ms, by = chip_smoke.bound(*chip_smoke.op_cost_counts("lane_roll", 528, 256))
    assert by == "operations" and ms == pytest.approx(4 * ops / chip_smoke.SMEM_BYTES_PER_S * 1e3)
    # The instruction rate: an fma tile-op (2048 instructions) on each of 132 SMs
    # takes 16 clocks of 128 lanes at 1.98 GHz, 8.08 ns.
    assert 2 * 1024 * 132 / chip_smoke.FP32_INSTR_PER_S * 1e9 == pytest.approx(8.07, abs=0.01)
    # Shared memory: a lane tile-op (8 KB through 32 banks of 4 bytes) on each
    # of 132 SMs takes 64 clocks, 32.3 ns.
    assert 8192 * 132 / chip_smoke.SMEM_BYTES_PER_S * 1e9 == pytest.approx(32.3, abs=0.05)


def _identity(h, w):
    lens = L.Rectilinear(35.0, 36.0, 36.0 * h / w)
    return dict(in_lens=lens, out_lens=lens, out_h=h, out_w=w, interp="nearest")


def test_remap_footprint_counts_each_texel_once():
    """The identity remap, nearest: one texel a pixel, none twice; a listed
    sub-tile past the frame's edges counts only its pixels inside it."""
    cpu = torch.device("cpu")
    kw = _identity(12, 200)
    assert chip_smoke.remap_footprint((12, 200), None, kw, cpu) == (12 * 200, 12 * 200)
    tiles = torch.tensor([[0, 0, 5, 5, 5, 5], [1, 1, 5, 5, 5, 5]], dtype=torch.int32)
    assert chip_smoke.remap_footprint((12, 200), None, kw, cpu, tiles) == (
        1024 + 4 * 72, 1024 + 4 * 72)


def test_remap_footprint_of_the_lists_is_the_frames():
    """The headline's lenses at a small size: the sub-tiles' footprints
    unite to the frame's, each lies within its plan window, and the view
    reads only part of the panorama."""
    cpu = torch.device("cpu")
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    kw = dict(in_lens=L.full_equirectangular(), out_lens=L.Rectilinear(35.0, 36.0, 20.25),
              out_h=16, out_w=256, interp="bicubic")
    texels, pixels = chip_smoke.remap_footprint((48, 96), rot, kw, cpu)
    assert pixels == 16 * 256 and 0 < texels < 48 * 96 // 2
    tiles = torch.tensor([[ty, tx] for ty in range(2) for tx in range(2)], dtype=torch.int32)
    assert chip_smoke.remap_footprint((48, 96), rot, kw, cpu, tiles) == (texels, pixels)
    whole, _ = P.windows(rot, in_h=48, in_w=96, device="cpu", **kw)
    parts = []
    for ty, tx in tiles.tolist():
        part, n = chip_smoke.remap_footprint((48, 96), rot, kw, cpu, torch.tensor([[ty, tx]]))
        assert n == 1024 and part <= int(whole[ty, tx, 1] * whole[ty, tx, 3])
        parts.append(part)
    assert max(parts) <= texels <= sum(parts)


def test_window_and_gather_texels():
    """The source values the probe kernels' inputs need, each counted once."""
    ids = torch.arange(DP.H * DP.W).view(DP.H, DP.W)
    offs = torch.tensor([[0, 0], [0, 0], [8, 64]], dtype=torch.int32)
    # Two equal windows, and a third overlapping them by 8 x 64.
    assert chip_smoke.distinct(ids.numel(), [DP.windows(ids, offs, 0)]) == 2 * 2048 - 8 * 64
    # One tile's 4-step scan: 4 windows on disjoint columns.
    assert chip_smoke.distinct(ids.numel(), (DP.windows(ids, offs[:1], s) for s in range(4))) == \
        4 * 2048
    # window_gather with every origin at (0, 0), 2 taps, 3 channels: 2 rows x 6 columns.
    zero = torch.zeros(5, 8, 128, dtype=torch.int32)
    assert chip_smoke.gather_texels(8, 128, zero, zero, 2, 3) == 5 * 2 * 6
    # Origins past the window are clamped into it, as the kernel clamps them.
    assert chip_smoke.gather_texels(8, 128, zero - 9, zero + 99, 2, 3) == 5 * 1 * 1


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the probe kernels are CUDA only and this machine has no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def launches():
    """The launch counts (``build.COUNTS``) set to 0 for the test and
    restored after it."""
    saved = COUNTS.copy()
    reset_counts()
    yield
    reset_counts()
    COUNTS.update(saved)


def _same(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.gpu
def test_window_kernels_match_plain_on_card(cuda, launches):
    rng, src, offs, offs_db = DP.check_inputs()
    src = T(src).to(cuda)
    for table in (offs, offs_db, EDGE_OFFS, DP.timing_table(rng)):
        table = T(table).to(cuda)
        _same(DP.window_copy(src, table), DP.window_copy_plain(src, table))
        _same(DP.window_scan_db(src, table, DP.N_STEPS),
              DP.window_scan_db_plain(src, table, DP.N_STEPS))
        _same(DP.window_scan_db(src, table, 1), DP.window_scan_db_plain(src, table, 1))
    assert COUNTS["probes.window_copy"] == 4 and COUNTS["probes.window_scan_db"] == 8


@pytest.mark.gpu
def test_lane_roll_matches_plain_on_card(cuda, launches):
    rng, x, sh = RP.check_inputs()
    _same(RP.lane_roll(T(x).to(cuda), T(sh).to(cuda)),
          RP.lane_roll_plain(T(x).to(cuda), T(sh).to(cuda)))
    x = torch.rand(5, 13, 300, device=cuda)  # rows past a block's 8, columns past its 256
    sh = torch.tensor([0, -1, 299, 300, 1001], dtype=torch.int32, device=cuda)
    _same(RP.lane_roll(x, sh), RP.lane_roll_plain(x, sh))
    assert COUNTS["probes.lane_roll"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("h", RP.EDGE_H)
def test_lane_roll_edge_shapes_match_plain_on_card(cuda, launches, h):
    """Every width of ``RP.EDGE_W`` at n = 1 (each shift kind) and 2048,
    both instances; and the float instance on a view off a 16-byte
    boundary."""
    calls = 0
    for x, sh in RP.edge_cases(cuda):
        if x.shape[1] == h:
            _same(RP.lane_roll(x, sh), RP.lane_roll_plain(x, sh))
            calls += 1
    x, sh = RP.edge_inputs(5, h, 256, cuda)
    moved = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    moved.copy_(x)
    _same(RP.lane_roll(moved, sh), RP.lane_roll_plain(x, sh))
    assert COUNTS["probes.lane_roll"] == calls + 1


@pytest.mark.gpu
def test_window_gather_matches_plain_on_card(cuda, launches):
    for _, channels, inputs in WW.cases():
        inputs = [T(a).to(cuda) for a in inputs]
        _same(WW.window_gather(*inputs, channels), WW.window_gather_plain(*inputs, channels))
    # Taps past the window on every side are clamped alike, both tap counts.
    rng = np.random.default_rng(3)
    for taps in WW.TAPS:
        win = torch.rand(6, 16, 256, device=cuda)
        y0 = T(rng.integers(-3, 19, (6, 8, 128)).astype(np.int32)).to(cuda)
        x0 = T(rng.integers(-3, 90, (6, 8, 128)).astype(np.int32)).to(cuda)
        wx, wy = (torch.rand(taps, 6, 8, 128, device=cuda) for _ in range(2))
        _same(WW.window_gather(win, y0, x0, wx, wy, 3), WW.window_gather_plain(win, y0, x0, wx, wy, 3))
    assert COUNTS["probes.window_gather"] == len(WW.CASES) + 2


@pytest.mark.gpu
@pytest.mark.parametrize("op", GC.OPS)
def test_op_cost_matches_plain_on_card(cuda, launches, op):
    x, idx = GC.check_inputs()
    rng = np.random.default_rng(4)
    x = np.concatenate([x, rng.uniform(0, 1, (3, 8, 128)).astype(np.float32)])
    idx = np.concatenate([idx, rng.integers(-200, 200, (3, 8, 128)).astype(np.int32)])
    x, idx = T(x).to(cuda), T(idx).to(cuda)
    for iters in (0, 1, 7):
        _same(GC.op_cost(x, idx, op, iters), GC.op_cost_plain(x, idx, op, iters))
    assert COUNTS["probes.op_cost"] == 3


@pytest.mark.gpu
def test_wrong_device_mix_raises_on_card(cuda, launches):
    _, src, offs, _ = DP.check_inputs()
    with pytest.raises(ValueError, match="expected cuda"):
        DP.window_copy(T(src).to(cuda), T(offs))
    assert COUNTS["probes.window_copy"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("layout", DP.EDGE_SOURCES)
def test_window_scan_db_layouts_match_plain_on_card(cuda, launches, layout):
    """Sources of aligned base and width, odd width and unaligned base, at
    each of ``DP.EDGE_STEPS`` on the probe's tables, the edge table and the
    timing table."""
    rng, src, offs, offs_db = DP.check_inputs()
    src = DP.edge_source(T(src).to(cuda), layout)
    assert (src.data_ptr() % 16 == 0 and src.shape[1] % 4 == 0) == (layout == "aligned")
    for table in (offs, offs_db, EDGE_OFFS, DP.timing_table(rng)):
        table = T(table).to(cuda)
        for steps in DP.EDGE_STEPS:
            _same(DP.window_scan_db(src, table, steps), DP.window_scan_db_plain(src, table, steps))
    assert COUNTS["probes.window_scan_db"] == 4 * len(DP.EDGE_STEPS)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["8100 row-invariant", "8100 drift", *WW.EDGE_CASES])
def test_window_gather_paths_match_plain_on_card(cuda, launches, case):
    """The timed shape with both kinds of x0, and ``WW.EDGE_CASES``: a
    sub-tile count that is no multiple of the SMs, and windows whose size
    or base is not a multiple of 16 bytes, both tap counts."""
    rng = np.random.default_rng(5)
    for taps in WW.TAPS:
        if case.startswith("8100"):
            inputs = [T(a).to(cuda) for a in WW.case_inputs(rng, 8100, 1, taps, 3,
                                                            drift=case.endswith("drift"))]
        else:
            inputs = WW.edge_inputs(rng, case, taps, cuda)
        _same(WW.window_gather(*inputs, 3), WW.window_gather_plain(*inputs, 3))
    assert COUNTS["probes.window_gather"] == 2
