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
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from image_lens_reproject_torch import probes
from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import plan as P
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

EDGE_OFFS = np.array([[500, 1000], [-8, -3], [0, 0], [496, 896], [8, 1020], [-600, 2000]],
                     np.int32)


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
    assert DP.LAUNCHES == 0


@pytest.mark.parametrize("table", ["probe", "edges"])
def test_window_scan_db_matches_k5(dma_jax, table):
    """The 4-step double-buffered scan: the same sums in the same order."""
    _, src, _, offs_db = DP.check_inputs()
    offs = offs_db if table == "probe" else EDGE_OFFS
    got = DP.window_scan_db(T(src), T(offs), DP.N_STEPS).numpy()
    np.testing.assert_array_equal(got, dma_jax[1](src, offs))
    assert DP.DB_LAUNCHES == 0


# --- K7: a dynamic roll per tile --------------------------------------------


@pytest.mark.parametrize("shifts", ["probe", "wide"])
def test_lane_roll_matches_k7(shifts):
    import jax.numpy as jnp

    _, x, sh = RP.check_inputs()
    if shifts == "wide":  # shifts up to and past the tile's width
        sh = np.array([0, 255, 256, 300, 128] * 6 + [1, 2], np.int32)
    want = np.asarray(_bench("roll_probe").build(True)(jnp.asarray(x), jnp.asarray(sh[None])))
    np.testing.assert_array_equal(RP.lane_roll(T(x), T(sh)).numpy(), want)
    assert RP.LAUNCHES == 0


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
    assert WW.LAUNCHES == 0


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
    assert GC.LAUNCHES == 0


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


def test_probe_library_sources_exist():
    for name in probes.SOURCES:
        assert (ROOT / "image_lens_reproject_torch" / "csrc" / name).is_file()
    assert set(probes._SIGNATURES) == {
        "ilr_window_copy", "ilr_window_scan_db", "ilr_lane_roll", "ilr_op_cost",
        "ilr_window_gather"}


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
    # K6: fma 2 instructions an element an op (-fmad=false), every other class 1.
    elems = 528 * 1024
    assert chip_smoke.op_cost_counts("fma", 528, 256) == (
        12 * elems, elems * (4 + 256 * 4 * (16 * 2 + 1) + 3))
    assert chip_smoke.op_cost_counts("lane_gather", 528, 256)[1] == elems * (4 + 256 * 4 * 17 + 3)
    assert chip_smoke.bound(*chip_smoke.op_cost_counts("fma", 528, 256))[1] == "operations"
    # The instruction rate: an fma tile-op (2048 instructions) on each of 132 SMs
    # takes 16 clocks of 128 lanes at 1.98 GHz, 8.08 ns.
    assert 2 * 1024 * 132 / chip_smoke.FP32_INSTR_PER_S * 1e9 == pytest.approx(8.07, abs=0.01)


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
    counters = ((DP, "LAUNCHES"), (DP, "DB_LAUNCHES"), (RP, "LAUNCHES"), (GC, "LAUNCHES"),
                (WW, "LAUNCHES"))
    saved = [getattr(m, a) for m, a in counters]
    for m, a in counters:
        setattr(m, a, 0)
    yield
    for (m, a), v in zip(counters, saved):
        setattr(m, a, v)


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
    assert DP.LAUNCHES == 4 and DP.DB_LAUNCHES == 8


@pytest.mark.gpu
def test_lane_roll_matches_plain_on_card(cuda, launches):
    rng, x, sh = RP.check_inputs()
    _same(RP.lane_roll(T(x).to(cuda), T(sh).to(cuda)),
          RP.lane_roll_plain(T(x).to(cuda), T(sh).to(cuda)))
    x = torch.rand(5, 13, 300, device=cuda)  # rows past a block's 8, columns past its 256
    sh = torch.tensor([0, -1, 299, 300, 1001], dtype=torch.int32, device=cuda)
    _same(RP.lane_roll(x, sh), RP.lane_roll_plain(x, sh))
    assert RP.LAUNCHES == 2


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
    assert WW.LAUNCHES == len(WW.CASES) + 2


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
    assert GC.LAUNCHES == 3


@pytest.mark.gpu
def test_wrong_device_mix_raises_on_card(cuda, launches):
    _, src, offs, _ = DP.check_inputs()
    with pytest.raises(ValueError, match="expected cuda"):
        DP.window_copy(T(src).to(cuda), T(offs))
    assert DP.LAUNCHES == 0
