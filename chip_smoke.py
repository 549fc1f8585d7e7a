#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU, and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA GPU and nvcc (``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``); without
a GPU it fails. Each phase prints lines tagged with its name; any failure
raises, so the script exits non-zero and never prints its last line.

1. device: the GPU's name and power limit;
2. build: kernels B1 (``image_lens_reproject_torch/csrc/remap_kernel.cu``,
   ``remap_frame.cu``), B2 (``csrc/rescue_kernel.cu``, ``rescue_windows.cu``;
   its launch count is of wrapper calls, each launching the kernel once
   for each size class of its list) and the probe kernels (``csrc/*_probe.cu``,
   one library), one nvcc a source file, started together, from the
   sources, timed; beside them the native EXR codec (whether it loaded,
   from where, and its build time);
3. parity: B1 against the plain PyTorch path, both on the GPU, at the
   headline shape (BASELINE config 3: 3840x1920 full equirect -> 3840x2160
   rectilinear, bicubic, rotation (20, 5, 0), exposure x2, Reinhard 4), at
   the published widths of BASELINE configs 1, 2 and 4, on small cases
   (C = 1, 4, 5; n_samples = 2; partial equirect with clamp; no rotation;
   tonemap off), on batches of 4 (each also against its four one-image
   launches) and on every lens pair x sampler at a small size: bit for
   bit, NaN positions equal and max abs 0 on the rest;
4. planned path: at the headline and at config 2, the plan's three
   sub-tile lists (ops/plan.py; their sizes as on earlier runs), and at
   batch 1 and 4 each size class's B2 launch (rescue and split) and B1 list
   mode against their plain versions, and the whole planned path against
   B1's full frame, all bit for bit, with no read outside a staged window;
   then each of B1 list mode's instances (C = 3, 4 and any; n_samples 1
   and any; batch 1 and 4) against its plain version, bit for bit;
5. band: B1's band mode (K1's row0 / band_rows) against its plain version
   and against B1's frame, bit for bit: the headline in 4 bands of 540
   rows and in 7 of 309 (the last past out_h), at batch 1 and 4, and one
   band at configs 1, 2 and 4; then the planned path inside each headline
   band and each of config 2's 4 bands of 512 rows, from the band's plan
   (no split list, as JAX's mesh step): B2's band mode (K2 at a band's
   row0) and B1 list mode's band mode each against its plain version, and
   the planned band against B1's band, bit for bit, no read outside a
   window;
6. views: B1's view mode (a ``(V, 3, 3)`` rotation stack through
   ``remap_tonemap_batch``, every view in one launch), its launch counts
   set to 0 before: FFmpeg v360's c6x1 cubemap of an 8K frame (3840x7680
   full equirect -> six 90-degree 1920x1920 faces, bilinear) with the
   stack as numpy and on the card, a batch of 2 with C = 4, bicubic and
   the tonemap, and 20 views (more than go by value), each against the
   plain path and against one launch a view, bit for bit, and the
   launches and views counted; then the cubemap's launch timed in turns
   against the plain path, its bound over the union of the faces' texels;
7. field: B1's coordinate field, the cache emptied and its counters set to
   0: the headline, config 2 and a 540-row headline band, three calls
   each with a numpy rotation (the first launches B1 as ever, the second
   fills the field and reads it, the third reads it), each call against
   the plain path bit for bit, and the counters read after (one bypass,
   one fill, one hit a configuration); then the headline's and config 2's
   read launches (``remap_tonemap``, a hit each call) timed in turns
   against B1's direct launch of the same constants (``ilr_remap_frame``),
   each beside its bound with and without the field's 8 bytes a pixel,
   the headline's also against the plain path; and the headline's
   ``coord_field`` against the plain path's coordinates of every pixel,
   bit for bit and timed in turns;
8. main path: the CLI (``image_lens_reproject_torch.cli.main``)
   a. on three 3840x1920 RGB EXR frames made from a seed, default options
      (B1): every output within one half ulp of the plain path's output,
      the field cache emptied and its counters set to 0 before: B1's
      launches split into direct ones, fills and reads of the field;
   b. on the same frames with ``--rescue on --split on`` (B2, B2 split, B1
      list mode), and on one config-2 frame with and without those
      switches: files byte-identical to the default run's;
   c. on one config-4 RGBZ frame (B1): depth remapped and never
      tonemapped, colour tonemapped, each within one half ulp of the plain
      path;
   the launch counts and the zone totals (``utils/tracing.reset_zones``)
   are set to 0 before each run and read after it;
9. mesh: the launch counts set to 0, then ``parallel.batch.sharded_remap_step``
   on meshes (1, 1), (2, 2), (4, 1) and (1, 4) that name the card at every
   position, on 4 headline frames (B1's band mode where the mesh has
   rows), then with ``band_plans`` (the planned path inside each band: B2's
   band mode and B1 list mode's), and with band plans on one config-2
   frame over mesh (1, 4), whose bands have direct sub-tiles; the same step
   without and with band plans on ``parallel.distributed.global_mesh(1, 1)``
   of a one-rank NCCL group on localhost, destroyed after; the CLI with
   ``--mesh 1,1``, ``--mesh auto``, ``--mesh 2,2`` (on one card: its
   warning, then one device) and ``--mesh 1,1 --rescue on --split on`` on
   the main path's headline frames; the counts read after (B2's split mode
   never: a band takes no split list): outputs equal to B1's frame bit for
   bit and files to the default run's byte for byte;
10. probes: the four probe entry points
   (``python -m image_lens_reproject_torch.probes.<dma_probe | roll_probe |
   gather_cost_probe | ww2_probe>``, each ``main()`` on the card, checks
   and its own timings), the probe kernels' launch counts set to 0 before
   and read after; then each probe kernel against its plain version on the
   card, bit for bit: window_copy and window_scan_db on the probe's tables
   and the 2048-tile timing table, lane_roll on the probe's tiles and on
   every edge shape of its module (``roll_probe.edge_cases``: n 1 and 2048,
   h 1, 7, 80, 81, w 1, 3, 250, 256, 257, shifts negative, 0, w - 1, w,
   past w and the int32 extremes),
   window_gather on the probe's ten cases and at 8100 sub-tiles, op_cost
   for each op class; and window_scan_db and window_gather on the edge
   cases of their modules (``probe_edge_cases``);
11. timing: device-time medians after warm-up of runs of back-to-back
   calls, each run queued behind a wait on the card so that the host's
   work before each launch is not timed (``probes.loop_times``), in turns (plain, kernel, kernel, plain), the field cache swapped for
   one that never fills, so that every B1 row times the direct launch: B1 against the plain path
   at configs 1-4 and at the headline at batch 4 (ms a frame); the planned
   path against B1 full frame at the headline and config 2, at batch 1 and
   4; each list kernel against its plain version on config 2's lists, and
   B1 list mode over every sub-tile of the headline against B1's frame; a
   540-row headline band against its plain version, the planned band
   against B1's band at batch 1 and 4, B2's band mode over the band's
   rescue list and B1 list mode's band mode over all its sub-tiles against
   their plain versions, and the (2, 2) mesh step on the one card ("bands
   in turn", not a multi-GPU time) against B1's frame, and with band plans
   against without, at batch 4; the probe
   kernels against their plain versions at the probes' timing shapes
   (lane_roll also in turns against one ``torch.gather`` whose index is
   the stride-0 expand of one row's, precomputed, the ratio printed; the
   same call with the index materialised as int64 is timed on a line of
   its own before it), and op_cost per op class
   at 256 trips, beside the entry point's own times at 2048 and 65536 trips,
   each class's time, bound and share on a line of its own.

It then prints the card's name and power limit, one JSON line about the
kernels (each with its bound, ``bound``: the larger of the bytes these
inputs need moved over the card's memory rate and the operations they need
over the card's rate for them: float32 instructions, and for op_cost's
lane classes shared-memory bytes), and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from image_lens_reproject_torch.baseline import (
    EXPOSURE_EV, OUT_H, OUT_W, REINHARD, ROTATION, SRC_H, SRC_W, configs,
)

ROOT = Path(__file__).resolve().parent
N_FRAMES = 3
FOV_180 = "3.14159265358979"  # the CLI takes fisheye fields of view in radians
B1_SOURCE = "image_lens_reproject_torch/csrc/remap_kernel.cu"
# B2's kernel body; rescue_kernel.cu holds its C entry point.
B2_SOURCE = "image_lens_reproject_torch/csrc/rescue_windows.cu"
K1 = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:2127"
# K1's row0 / band_rows (the argument list of _remap_pallas_one).
K1_BAND = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:1875"
K2 = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:2191"
K3 = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:2296"
PROBES_DIR = "image_lens_reproject_torch/csrc/"
K4, K5 = "bench/dma_probe.py:69", "bench/dma_probe.py:133"
K6 = "bench/gather_cost_probe.py:96"
K7 = "bench/roll_probe.py:49"
K8 = "bench/ww2_probe.py:121 and :201"
K8_SUBTILES = 8100  # the headline's 8 x 128 sub-tiles
K6_PLAIN_ITERS = 256  # op_cost's trips where it is timed against its plain version

# The card's rates for the bounds (an H100 SXM, NVIDIA's data sheet, at
# 700 W): device memory, and float32 instructions outside the tensor cores.
# The data sheet's 67 TFLOP/s counts a fused multiply-add as two
# operations. Every kernel here is built with -fmad=false, so each multiply
# and each add is an instruction of its own, and the card issues at most
# 128 of them a clock on each of its 132 SMs: half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
# Shared memory: 32 banks of 4 bytes a clock on each SM, at the clock that
# rate implies (128 float32 instructions a clock on 132 SMs: 1.98 GHz).
SMEM_BYTES_PER_S = 32 * 4 * 132 * FP32_INSTR_PER_S / (128 * 132)
TAPS = {"nearest": 1, "bilinear": 2, "bicubic": 4}  # taps a side


def bound(n_bytes, n_instr, smem_bytes=0):
    """(ms, what binds): the least time the card could take to move
    ``n_bytes`` of device memory, issue ``n_instr`` float32 instructions and
    move ``smem_bytes`` through shared memory (operations of the SMs)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_instr / FP32_INSTR_PER_S, smem_bytes / SMEM_BYTES_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct(size, index_tensors):
    """How many values of ``range(size)`` the integer tensors hold."""
    import torch

    seen = None
    for t in index_tensors:
        if seen is None:
            seen = torch.zeros(size, dtype=torch.bool, device=t.device)
        seen[t.reshape(-1)] = True
    return 0 if seen is None else int(seen.sum())


def remap_footprint(in_hw, rotation, kw, device, tiles=None, band=None):
    """(texels, pixels): the distinct source texels that the taps of every
    supersample of a remap's output pixels read, and those pixels: the
    rows of ``band`` ((row offset, row count), by default the whole frame;
    rows past out_h included, as the band modes compute them), or, given
    ``tiles`` ((n, >= 2) ints, sub-tile row and column first, the rows
    counted from the band's first), the pixels of those 8 x 128 sub-tiles
    inside the band. A ``(V, 3, 3)`` rotation stack gives the union of its
    views' texels and every view's pixels. What the remap of these inputs
    must read, whatever a kernel stages."""
    import torch
    from image_lens_reproject_torch.models.lens import wrap_mode_for_input
    from image_lens_reproject_torch.ops import remap as R
    from image_lens_reproject_torch.ops import sampling as S

    (in_h, in_w), out_h, out_w, interp = in_hw, kw["out_h"], kw["out_w"], kw["interp"]
    row0, count = band or (0, out_h)
    if tiles is None:
        rows = torch.arange(row0, row0 + count, device=device)[:, None]
        cols = torch.arange(out_w, device=device)[None, :]
        inside = torch.ones_like(rows * cols, dtype=torch.bool)
    else:
        rows, cols = R.subtile_pixels(tiles[:, :2].to(device))
        inside = (rows < count) & (cols < out_w)
        rows = rows + row0
    views = [rotation] if getattr(rotation, "ndim", 2) == 2 else list(rotation)
    wrap = wrap_mode_for_input(kw["in_lens"])
    offsets = R.supersample_offsets(kw.get("n_samples", 1))

    def taps():
        for view in views:
            rot = R.rotation_tensor(view, device)
            for off_x in offsets:
                for off_y in offsets:
                    sx, sy = R.source_coords(kw["in_lens"], kw["out_lens"], in_h, in_w,
                                             R.pixel_centres(cols, out_w) + off_x,
                                             R.pixel_centres(rows, out_h) + off_y, rot, out_h,
                                             out_w)
                    sx, sy, keep = torch.broadcast_tensors(sx, sy, inside)
                    for y in S.y_taps(sy, in_h, interp).idx:
                        for x in S.x_taps(sx, in_w, interp, wrap).idx:
                            yield (y * in_w + x)[keep]

    return distinct(in_h * in_w, taps()), len(views) * int(inside.sum())


def remap_counts(texels, channels, out_pixels, interp, extra_bytes=0):
    """(bytes, instructions) of a remap writing ``out_pixels`` pixels of
    ``channels`` from ``texels`` source texels (``remap_footprint``) with
    one sample a pixel: those texels read once, the pixels written once,
    and ``extra_bytes`` (a list's int32 entries); instructions counted low,
    as the tap sums alone (a multiply and an add per tap and channel)."""
    n_bytes = 4 * channels * (texels + out_pixels) + extra_bytes
    return n_bytes, 2 * out_pixels * channels * TAPS[interp] ** 2


def window_counts(texels, n_tiles, n_steps=None):
    """window_copy (``n_steps`` None: one multiply a value) or
    window_scan_db (one add a value a step): the ``texels`` distinct source
    values its windows cover and the (n, 2) table read once, 16 x 128
    values a tile written once."""
    n_bytes = 4 * (texels + 2 * n_tiles + n_tiles * 16 * 128)
    return n_bytes, n_tiles * 16 * 128 * (n_steps or 1)


def gather_texels(rows, cols, y0, x0, taps, channels):
    """The distinct values of window_gather's (n_sub, rows, cols) window
    that its taps read, clamped as the kernel clamps them."""
    import torch

    n_sub = int(y0.shape[0])
    yl, xl = y0.long(), x0.long()
    base = torch.arange(n_sub, device=y0.device)[:, None, None] * (rows * cols)
    return distinct(n_sub * rows * cols, (
        base + (yl + n).clamp(0, rows - 1) * cols + ((xl + m) * channels + c).clamp(0, cols - 1)
        for n in range(taps) for m in range(taps) for c in range(channels)))


def gather_counts(texels, n_sub, taps, channels):
    """window_gather: the ``texels`` window values its taps read, origins
    and weights read once, the output written once; three instructions a
    tap (two multiplies and an add)."""
    pixels = n_sub * 8 * 128
    n_bytes = 4 * (texels + 2 * pixels + 2 * taps * pixels + channels * pixels)
    return n_bytes, 3 * channels * pixels * taps * taps


def op_cost_counts(op, n_tiles, iters):
    """op_cost: (bytes, float32 instructions, shared-memory bytes). x and idx
    read and the output written once; each class held to the unit it is
    meant to saturate, an element-op at a time: fma 2 float32 instructions
    (a multiply and an add, rounded apart), select 1, sublane_gather the 7
    selects of its tree (csrc/gather_cost_probe.cu gathers sublanes in
    registers); the lane ops at the rate a lane exchange needs, whose 32
    lanes a clock an SM of a warp shuffle or 128 bytes of shared memory
    are one rate: lane_roll, a roll by one lane, one exchange (4 bytes: a
    shuffle, only each warp's boundary lane crossing warps), lane_gather,
    any permutation of 128 lanes across 4 warps, a 4-byte store and a
    4-byte load through shared memory. Besides, 1 instruction each for the
    chains' start, each trip's fold and the final sum."""
    unroll, chains = 16, 4
    elems = n_tiles * 8 * 128
    per_op = {"fma": 2, "select": 1, "sublane_gather": 7}.get(op, 0)
    element_ops = elems * iters * chains * unroll
    n_instr = elems * (chains + iters * chains + chains - 1) + element_ops * per_op
    smem = {"lane_roll": 4, "lane_gather": 8}.get(op, 0) * element_ops
    return 4 * 3 * elems, n_instr, smem


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def smooth(h, w, c, seed):
    """A smooth float32 (h, w, c) image in [0.05, 0.95]: sums of sines."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    return np.stack([
        (0.5 + 0.45 * np.sin(4 * a * xx + 3 * b * yy + p)).astype(np.float32)
        for a, b, p in rng.uniform(0.5, 2, (c, 3))
    ], -1)


def phase_device(torch):
    check(torch.cuda.is_available(), "needs a CUDA GPU, and torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    say("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
                  f"{torch.cuda.device_count()} visible")
    return name, smi


def phase_build(libraries, build, native):
    """Builds every library at once, one thread (and nvcc) each, and the
    native EXR codec (the C++ compiler) beside them."""
    t0 = time.perf_counter()
    errors = []

    def load(lib):
        try:
            lib()
        except Exception as e:  # reported below, after every build ends
            errors.append(e)

    threads = [threading.Thread(target=load, args=(lib,)) for lib in libraries + (native.load,)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    for name in ("ilr_remap", "ilr_rescue", "ilr_probes"):
        seconds, report, units = build.BUILD_INFO[name]
        check(seconds is not None, f"{name} was not built from the sources in this run")
        lines = report.splitlines()
        regs = [int(line.split("Used ")[1].split()[0]) for line in lines
                if "ptxas info" in line and "Used " in line and "registers" in line]
        spills = [int(line.split("spill stores")[0].split(",")[-1].split()[0]) for line in lines
                  if "spill stores" in line]
        frames = [int(line.split("bytes stack frame")[0].split()[-1]) for line in lines
                  if "bytes stack frame" in line]
        say("build", f"nvcc built {name} in {seconds:.2f} s: {len(regs)} kernel instances, "
                     f"{min(regs)}-{max(regs)} registers, {sum(v > 0 for v in spills)} with "
                     f"spill stores (at most {max(spills)} bytes), {sum(v > 0 for v in frames)} "
                     f"with a stack frame")
        say("build", f"  {name}, nvcc a file: " +
            "; ".join(f"{label} {s:.2f} s" for label, s in units.items()))
        if name == "ilr_probes":
            for line in lines:
                if "Compiling entry function" in line or ("ptxas info" in line and "Used" in line):
                    say("build", f"  {line.strip()}")
    if native.LIBRARY_PATH is None:
        say("build", f"native EXR codec not loaded ({native.BUILD_ERROR or 'ILR_NO_NATIVE set'}): "
                     f"the CLI's EXR decode and encode take the numpy path")
    else:
        took = ("built before this run" if native.BUILD_SECONDS is None
                else f"built in {native.BUILD_SECONDS:.2f} s")
        say("build", f"native EXR codec loaded from {native.LIBRARY_PATH}, {took}")
    say("build", f"all {len(libraries)} built in {wall:.2f} s wall")


def to_dev(torch, a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def compare(torch, got, want, finite=False):
    """(max abs, p999, NaN count) of got against want; NaN positions must agree."""
    check(got.shape == want.shape, f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}")
    nan = torch.isnan(got)
    check(torch.equal(nan, torch.isnan(want)), "NaN positions differ")
    if finite:
        check(bool(torch.isfinite(got).all()), "non-finite values")
    err = torch.where((got == want) | nan, 0.0, (got - want).abs()).nan_to_num(nan=math.inf)
    err = err.cpu().numpy().ravel()
    return float(err.max()), float(np.quantile(err, 0.999)), int(nan.sum())


def phase_parity(torch, B1, L, rotation_matrix_degrees, dev):
    from image_lens_reproject_torch.ops.cuda.build import COUNTS

    cfg = configs()
    before = COUNTS["b1.frame"]
    calls = 0
    worst = 0.0
    parts = []

    def run(name, src, rot, kw, finite=False):
        nonlocal calls, worst
        got = B1.remap_tonemap(src, rot, **kw)
        want = B1.remap_tonemap_plain(src, rot, **kw)
        torch.cuda.synchronize()
        calls += 1
        m, p, n_nan = compare(torch, got, want, finite)
        check(m == 0.0, f"{name}: B1 differs from the plain path (max abs {m})")
        worst = max(worst, m)
        return m, p, n_nan

    # The headline, its small cases, and configs 1, 2 and 4 at full width.
    (h, w, c), kw, rot = cfg["3"]
    src = to_dev(torch, np.random.default_rng(0).uniform(0, 2, (1, h, w, c)).astype(np.float32), dev)
    m, p, _ = run("headline", src, rot, kw, finite=True)
    say("parity", f"headline B1 vs plain on the GPU: max abs {m:.3g}, p999 {p:.3g} (bit for bit "
                  f"required)")
    small = dict(kw, out_h=64, out_w=160)
    cases = {
        "C=1": (1, rot, small),
        "C=4": (4, rot, small),
        "C=5": (5, rot, small),
        "n_samples=2": (3, rot, dict(small, n_samples=2)),
        "partial equirect (clamp)": (3, rot, dict(small, in_lens=L.Equirectangular(-2.0, 1.5, -1.2, 1.0))),
        "no rotation": (3, None, small),
        "tonemap off": (3, rot, dict(small, exposure=1.0, reinhard=1.0)),
    }
    for i, (name, (c, r, ckw)) in enumerate(cases.items()):
        s = to_dev(torch, np.random.default_rng(i + 1).uniform(0, 2, (2, 96, 192, c)).astype(np.float32), dev)
        parts.append(f"{name} {run(name, s, r, ckw, finite=True)[0]:.3g}")
    say("parity", f"small cases: {'; '.join(parts)}")

    # A batch of 4 (the images share one launch, each pixel's coordinates
    # computed once for all four) against four one-image launches and the
    # plain path, on a wrapping and a clamping input.
    n_batch = 0
    for in_lens in (kw["in_lens"], L.Equirectangular(-2.0, 1.5, -1.2, 1.0)):
        for c in (1, 3, 4, 5):
            for n in (1, 2):
                bkw = dict(small, in_lens=in_lens, n_samples=n)
                s = to_dev(torch, np.random.default_rng(40 + c).uniform(0, 2, (4, 96, 192, c))
                           .astype(np.float32), dev)
                whole = B1.remap_tonemap(s, rot, **bkw)
                singles = torch.cat([B1.remap_tonemap(s[i:i + 1], rot, **bkw) for i in range(4)])
                want = B1.remap_tonemap_plain(s, rot, **bkw)
                torch.cuda.synchronize()
                calls += 5
                for what, got in (("one launch", whole), ("four one-image launches", singles)):
                    check(compare(torch, got, want)[0] == 0.0,
                          f"batch of 4, C={c}, n_samples={n}: {what} differ from the plain path")
                n_batch += 1
    say("parity", f"{n_batch} batches of 4 (C = 1, 3, 4, 5; n_samples 1, 2; wrap and clamp): "
                  f"each equals its four one-image launches and the plain path bit for bit")
    for name in ("1", "2", "4"):
        (h, w, c), kw, rot = cfg[name]
        s = to_dev(torch, np.random.default_rng(10 + int(name)).uniform(0, 2, (1, h, w, c))
                   .astype(np.float32), dev)
        m, p, n_nan = run(f"config {name}", s, rot, kw)
        spec = B1.specialisation(s.shape, kw.get("n_samples", 1), s.data_ptr() % 16 == 0)
        say("parity", f"config {name} ({type(kw['in_lens']).__name__} {h}x{w}x{c} -> "
                      f"{type(kw['out_lens']).__name__} {kw['out_w']}x{kw['out_h']}, {kw['interp']}; "
                      f"instance channels, samples {spec}): max abs {m:.3g}, p999 {p:.3g}, "
                      f"NaN {n_nan} at equal positions")

    # Every lens pair x sampler at a small size, with rotation, supersampling,
    # C = 4 and the tonemap.
    lenses = [L.Rectilinear(35.0, 36.0, 27.0), L.FisheyeEquidistant(math.pi, 36.0, 36.0),
              L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0),
              L.FisheyeStereographic(12.0, 3.0, 36.0, 24.0), L.full_equirectangular()]
    s = to_dev(torch, np.random.default_rng(11).uniform(0, 2, (2, 40, 80, 4)).astype(np.float32), dev)
    r = rotation_matrix_degrees(20.0, 5.0, -3.0)
    matrix_worst = 0.0
    for li in lenses:
        for lo in lenses:
            for interp in ("nearest", "bilinear", "bicubic"):
                mkw = dict(in_lens=li, out_lens=lo, out_h=36, out_w=68, interp=interp,
                           n_samples=2, exposure=2.0, reinhard=4.0)
                matrix_worst = max(matrix_worst, run(f"{type(li).__name__} -> {type(lo).__name__} "
                                                     f"{interp}", s, r, mkw)[0])
    say("parity", f"25 lens pairs x 3 samplers (2x40x80x4 -> 36x68, n_samples 2): "
                  f"worst max abs {matrix_worst:.3g}")
    launched = COUNTS["b1.frame"] - before
    check(launched == calls, f"B1 launched {launched} times for {calls} calls")
    say("parity", f"B1 launches +{launched}, worst max abs {worst:.3g}: bit for bit everywhere")
    return worst


# The plan's list sizes (rescue, split, direct) at full width on the card:
# the size classes sort the lists and must not move a sub-tile between them.
PLAN_SIZES = {"3": (8100, 0, 0), "2": (7654, 24, 514)}


def phase_planned(torch, B1, B2, P, RF, dev):
    """Plans at the headline and config 2; at batch 1 and 4, each size
    class's B2 launch and B1 list mode against their plain versions, and
    the whole planned path against B1's full frame. Returns the plans,
    batch-1 sources and each kernel's worst max abs error."""
    from image_lens_reproject_torch.ops.cuda.build import COUNTS

    cfg = configs()
    errs = {"list": 0.0, "windows": 0.0, "windows_split": 0.0}
    out = {}
    counts = (COUNTS["b1.list"], COUNTS["b2.frame"], COUNTS["b2.split"])
    for name in ("3", "2"):
        (h, w, c), kw, rot = cfg[name]
        t0 = time.perf_counter()
        plan = P.make_plan(rot, in_h=h, in_w=w, channels=c, split=True, device=dev,
                           **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        sizes = plan.sizes()
        check((sizes["rescue"], sizes["split"], sizes["direct"]) == PLAN_SIZES[name],
              f"config {name}: plan sizes {sizes}, expected {PLAN_SIZES[name]}")
        for batch in (1, 4):
            src = to_dev(torch, np.random.default_rng(20 + int(name)).uniform(0, 2, (batch, h, w, c))
                         .astype(np.float32), dev)
            frame = B1.remap_tonemap(src, rot, **kw)
            parts = []
            for key, entries, split, classes in (
                    ("windows", plan.rescue, False, plan.rescue_classes),
                    ("windows_split", plan.split, True, plan.split_classes)):
                start = 0
                for count, floats in classes:
                    part = entries[start:start + count]
                    start += count
                    got = torch.full_like(frame, math.nan)
                    want = got.clone()
                    misses = B2.new_misses(dev)
                    B2.remap_windows(src, rot, got, part, split=split, misses=misses,
                                     classes=((count, floats),), **kw)
                    B2.remap_windows_plain(src, rot, want, part, split=split,
                                           misses=B2.new_misses(dev), **kw)
                    torch.cuda.synchronize()
                    check(int(misses.item()) == 0,
                          f"config {name} batch {batch}: B2 {key} read outside its windows")
                    e = compare(torch, got, want)[0]
                    check(e == 0.0, f"config {name} batch {batch}: B2 {key}, class of {count} "
                                    f"sub-tiles at {4 * floats} B, differs from its plain version")
                    errs[key] = max(errs[key], e)
                    images = B2.images_per_cta(batch, 4 * floats)
                    parts.append(f"{key} {count} x <= {4 * floats} B ({images} image(s) a CTA)")
            if len(plan.direct):
                got = torch.full_like(frame, math.nan)
                want = got.clone()
                B1.remap_tonemap_list(src, rot, got, plan.direct, **kw)
                B1.remap_tonemap_list_plain(src, rot, want, plan.direct, **kw)
                errs["list"] = max(errs["list"], compare(torch, got, want)[0])
            misses = B2.new_misses(dev)
            planned = RF.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw)
            torch.cuda.synchronize()
            check(int(misses.item()) == 0, f"config {name} batch {batch}: the planned path read "
                                           f"outside its windows")
            check(torch.equal(torch.isnan(planned), torch.isnan(frame)),
                  f"config {name} batch {batch}: NaN positions")
            check(torch.equal(planned.nan_to_num(7.0), frame.nan_to_num(7.0)),
                  f"config {name} batch {batch}: the planned path differs from B1's full frame")
            say("planned", f"config {name} batch {batch}: each class's launch == its plain version "
                           f"bit for bit, 0 reads outside windows: {'; '.join(parts)}; planned "
                           f"path == B1 full frame bit for bit")
            if batch == 1:
                out[name] = (src, plan)
            del src, frame, planned
        say("planned", f"config {name}: plan in {plan_s:.3f} s: {sizes['rescue']} rescue, "
                       f"{sizes['split']} split, {sizes['direct']} direct of "
                       f"{plan.grid[0] * plan.grid[1]} sub-tiles; budget "
                       f"{P.WINDOW_BUDGET_BYTES} B; size classes (sub-tiles, largest staged bytes) rescue "
                       f"{[(n, 4 * f) for n, f in plan.rescue_classes]}, split "
                       f"{[(n, 4 * f) for n, f in plan.split_classes]}")
    errs["list"] = max(errs["list"], list_instances(torch, B1, dev))
    launched = tuple(COUNTS[k] - n for k, n in zip(("b1.list", "b2.frame", "b2.split"), counts))
    check(launched[1] >= 1 and launched[2] >= 1,
          f"B2 launched {launched[1]} times and B2 split {launched[2]} times")
    for key, e in errs.items():
        check(e == 0.0, f"{key}: differs from its plain version (max abs {e})")
    say("planned", f"kernels against their plain versions, bit for bit: B1 list {errs['list']:.3g}, "
                   f"B2 {errs['windows']:.3g}, B2 split {errs['windows_split']:.3g}; "
                   f"launches +{launched[0]} list, +{launched[1]} B2, +{launched[2]} B2 split")
    return out, errs


# List mode's instances: (C, 16-byte aligned source) -> the channel
# specialisation it reaches (0: the generic instance), each at n_samples 1
# and 2 (the one-sample instance and any).
LIST_INSTANCES = {(3, True): 3, (4, True): 4, (4, False): 0, (5, True): 0}


def list_instances(torch, B1, dev):
    """B1 list mode's every instance against its plain version at batch 1
    and 4, on sub-tiles inside the frame and clipped at its edges, bit for
    bit; returns the worst max abs error."""
    from image_lens_reproject_torch.models import lens as L
    from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees

    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    tiles = to_dev(torch, np.array([[0, 0], [1, 2], [4, 1], [4, 2]], np.int32), dev)
    worst, parts = 0.0, []
    for (c, aligned), spec in LIST_INSTANCES.items():
        for n in (1, 2):
            for batch in (1, 4):
                shape = (batch, 40, 80, c)
                flat = torch.empty(int(np.prod(shape)) + 4, device=dev)
                src = flat[(0 if aligned else 1):][:int(np.prod(shape))].view(shape)
                src.copy_(to_dev(torch, np.random.default_rng(50 + c).uniform(0, 2, shape)
                                 .astype(np.float32), dev))
                check(B1.specialisation(shape, n, src.data_ptr() % 16 == 0)[0] == spec,
                      f"list mode C={c} aligned={aligned}: not the instance of channels {spec}")
                kw = dict(in_lens=L.full_equirectangular(), out_lens=L.Rectilinear(35.0, 36.0, 27.0),
                          out_h=36, out_w=300, interp="bicubic", n_samples=n, exposure=2.0,
                          reinhard=4.0)
                got = torch.full((batch, 36, 300, c), math.nan, device=dev)
                want = got.clone()
                B1.remap_tonemap_list(src, rot, got, tiles, **kw)
                B1.remap_tonemap_list_plain(src, rot, want, tiles, **kw)
                torch.cuda.synchronize()
                e = compare(torch, got, want)[0]
                check(e == 0.0, f"list mode C={c} aligned={aligned} n={n} batch {batch}: "
                                f"differs from its plain version (max abs {e})")
                worst = max(worst, e)
        parts.append(f"C={c}{'' if aligned else ' unaligned'} -> channels {spec or 'any'}")
    say("planned", f"B1 list mode's instances ({'; '.join(parts)}; n_samples 1 and any; batch 1 "
                   f"and 4; sub-tiles clipped at the edges) == plain bit for bit")
    return worst


def _within_one_half_ulp(got, want):
    nan = np.isnan(want)
    if not (got.shape == want.shape and np.array_equal(np.isnan(got), nan)):
        return False
    got, want = got[~nan], want[~nan]
    ulp = np.maximum(
        np.spacing(np.abs(want).astype(np.float16)), np.spacing(np.abs(got).astype(np.float16))
    ).astype(np.float32)
    return bool((np.abs(got - want) <= ulp).all())


def _cli(cli, torch, args):
    """Runs ``cli.main(args)`` with the zone totals reset first, so that the
    phase report it prints covers this run alone; returns its wall seconds."""
    from image_lens_reproject_torch.utils import tracing

    tracing.reset_zones()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    check(rc == 0, f"the CLI returned {rc} for {' '.join(args)}")
    return time.perf_counter() - t0


def headline_args(in_dir):
    """The CLI's arguments for the headline on the EXR frames of ``in_dir``."""
    return [
        "-i", str(in_dir), "--exr", "--device", "cuda", "-j", "4",
        "--no-configs", f"{SRC_W},{SRC_H}", "--i-equirectangular", "full",
        "--rectilinear", "35,36", "--output-resolution", f"{OUT_W},{OUT_H}",
        "--rotation", ",".join(str(a) for a in ROTATION),
        "--exposure", str(EXPOSURE_EV), "--reinhard", str(REINHARD), "--bc",
    ]


def phase_main_path(torch, B1, B2, cli, exr, dev, tmp):
    """The CLI's paths, in ``tmp``; leaves the headline frames in
    ``tmp/in`` and the default run's outputs in ``tmp/out``."""
    from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts

    cfg = configs()
    launches = {}
    # a. the headline frames, default options: kernel B1.
    in_dir = tmp / "in"
    in_dir.mkdir()
    names = [f"frame_{i:04d}.exr" for i in range(N_FRAMES)]
    for i, name in enumerate(names):
        exr.write_exr(str(in_dir / name), smooth(SRC_H, SRC_W, 3, seed=i))
    headline = headline_args(in_dir)
    reset_counts()
    B1.FIELDS = B1.FieldCache()
    wall = _cli(cli, torch, headline + ["-o", str(tmp / "out")])
    check(COUNTS["b1.frame"] == N_FRAMES,
          f"B1 launched {COUNTS['b1.frame']} times for {N_FRAMES} frames")
    check(COUNTS["b1.field_bypass"] + COUNTS["b1.field_fill"] + COUNTS["b1.field_hit"] == N_FRAMES,
          f"the field saw {COUNTS['b1.field_bypass']} bypasses, {COUNTS['b1.field_fill']} "
          f"fills and {COUNTS['b1.field_hit']} hits in {N_FRAMES} frames")
    # A fill launches coord_field and then the read instance, as a hit does.
    launches["field"] = COUNTS["b1.field_fill"] + COUNTS["b1.field_hit"]
    launches["coord_field"] = COUNTS["b1.field_fill"]
    launches["frame"] = COUNTS["b1.frame"] - launches["field"]
    written = sorted(p.name for p in (tmp / "out").glob("*.exr"))
    check(written == names, f"the CLI wrote {written}, expected {names}")
    (_, _, _), kw, rot = cfg["3"]
    for name in names:
        src = to_dev(torch, exr.read_exr(str(in_dir / name)).data[None], dev)
        plain = B1.remap_tonemap_plain(src, rot, **kw)[0].cpu().numpy()
        exr.write_exr(str(tmp / "plain.exr"), plain)
        got = exr.read_exr(str(tmp / "out" / name)).data
        check(np.isfinite(got).all(), f"{name}: non-finite output")
        check(_within_one_half_ulp(got, exr.read_exr(str(tmp / "plain.exr")).data),
              f"{name}: CLI output differs from the plain path by more than one half ulp")
    say("main path", f"CLI default on {N_FRAMES} frames {SRC_W}x{SRC_H} EXR -> {OUT_W}x{OUT_H}: "
                     f"rc 0, B1 launches {COUNTS['b1.frame']} (direct {launches['frame']}, "
                     f"reading the field {launches['field']}, coord_field "
                     f"{launches['coord_field']}), "
                     f"outputs within one half ulp of the plain path; wall {wall:.2f} s with "
                     f"EXR decode/encode")

    # b. --rescue on --split on: kernel B2, B2 split and B1 list mode.
    reset_counts()
    wall_r = _cli(cli, torch, headline + ["-o", str(tmp / "rescued"), "--rescue", "on",
                                          "--split", "on"])
    head = (COUNTS["b1.list"], COUNTS["b2.frame"], COUNTS["b2.split"])
    check(COUNTS["b1.frame"] == 0 and COUNTS["b2.frame"] == N_FRAMES,
          f"--rescue on: B1 frame {COUNTS['b1.frame']}, B2 {COUNTS['b2.frame']} launches")
    for name in names:
        check((tmp / "rescued" / name).read_bytes() == (tmp / "out" / name).read_bytes(),
              f"{name}: --rescue on --split on wrote other bytes than the default run")
    c2_dir = tmp / "in2"
    c2_dir.mkdir()
    exr.write_exr(str(c2_dir / "fisheye.exr"), smooth(2048, 2048, 3, seed=5))
    cfg2 = [
        "-i", str(c2_dir), "--exr", "--device", "cuda",
        "--no-configs", "2048,2048", "--i-equisolid", f"15,36,{FOV_180}",
        "--equirectangular", "full", "--output-resolution", "4096,2048",
        "--rotation", "30,10,5", "--bl",
    ]
    reset_counts()
    _cli(cli, torch, cfg2 + ["-o", str(tmp / "c2_rescued"), "--rescue", "on", "--split", "on"])
    c2 = (COUNTS["b1.list"], COUNTS["b2.frame"], COUNTS["b2.split"])
    _cli(cli, torch, cfg2 + ["-o", str(tmp / "c2_default")])
    check((tmp / "c2_rescued" / "fisheye.exr").read_bytes()
          == (tmp / "c2_default" / "fisheye.exr").read_bytes(),
          "config 2: --rescue on --split on wrote other bytes than the default run")
    launches["list"] = head[0] + c2[0]
    launches["windows"] = head[1] + c2[1]
    launches["windows_split"] = head[2] + c2[2]
    for key in ("list", "windows", "windows_split"):
        check(launches[key] >= 1, f"the --rescue/--split runs never launched {key}")
    say("main path", f"CLI --rescue on --split on: headline {N_FRAMES} frames (B1 list, B2, "
                     f"B2 split launches {head}) and one config-2 frame ({c2}): files "
                     f"byte-identical to the default runs; headline wall {wall_r:.2f} s")

    # c. one config-4 RGBZ frame: depth remapped, never tonemapped.
    c4_dir = tmp / "in4"
    c4_dir.mkdir()
    rgbz = smooth(2048, 2048, 4, seed=6)
    exr.write_exr(str(c4_dir / "rgbz.exr"), rgbz, channel_names=["R", "G", "B", "Z"])
    reset_counts()
    _cli(cli, torch, [
        "-i", str(c4_dir), "-o", str(tmp / "c4"), "--exr", "--device", "cuda",
        "--no-configs", "2048,2048", "--i-rectilinear", "50,36",
        "--equisolid", f"15,36,{FOV_180}", "--output-resolution", "2048,2048", "--bl",
        "--exposure", "1", "--reinhard", "4",
    ])
    check(COUNTS["b1.frame"] == 1, f"config 4: B1 launched {COUNTS['b1.frame']} times for 1 frame")
    launches["frame"] += COUNTS["b1.frame"]
    (_, _, _), kw4, _ = cfg["4"]
    src = to_dev(torch, exr.read_exr(str(c4_dir / "rgbz.exr")).data[None], dev)
    check(src.shape[-1] == 4, f"config 4: decoded {src.shape[-1]} channels")
    remapped = B1.remap_tonemap_plain(src, None, **kw4)[0].cpu().numpy()
    toned = B1.remap_tonemap_plain(src, None, **dict(kw4, exposure=2.0, reinhard=4.0))[0]
    toned = toned.cpu().numpy()
    check(np.array_equal(toned[..., 3], remapped[..., 3], equal_nan=True),
          "config 4: the plain path tonemapped depth")
    exr.write_exr(str(tmp / "plain4.exr"), toned)
    got = exr.read_exr(str(tmp / "c4" / "rgbz.exr")).data
    want = exr.read_exr(str(tmp / "plain4.exr")).data
    check(got.shape == (2048, 2048, 4), f"config 4: output shape {got.shape}")
    check(_within_one_half_ulp(got, want), "config 4: CLI output differs from the plain path "
                                           "(depth remapped only, colour tonemapped)")
    n_nan = int(np.isnan(got).any(axis=-1).sum())
    say("main path", f"CLI config 4: 2048x2048 RGBZ EXR -> equisolid 2048x2048, exposure 1 EV, "
                     f"Reinhard 4: B1 launches 1; depth within one half ulp of the plain remap "
                     f"without tonemap, colour of the plain remap with it; {n_nan} NaN pixels "
                     f"(the fold ring) at the plain path's positions")
    return launches


# The headline's band of the timing and of the kernels line: the second of
# 4 bands of 540 rows (B1's band mode).
HEADLINE_BAND = (540, 540)
MESHES = ((1, 1), (2, 2), (4, 1), (1, 4))


def phase_band(torch, B1, B2, P, RF, dev):
    """B1's band mode against its plain version and against B1's frame, bit
    for bit (checks: their launches are not the main path's): at the
    headline 4 bands of 540 rows and 7 of 309 (the last running to row
    2163, past out_h), at batch 1 and 4; one band at configs 1, 2 and 4.
    Then the planned path inside each headline band and each of config 2's
    4 bands of 512 rows (the bands of mesh (1, 4), rescue and direct lists),
    from the band's plan: B2's band mode and B1 list mode's each against
    its plain version, and the whole planned band against B1's band, bit
    for bit with no read outside a window. Returns the worst max abs error
    of each band kernel against its plain version, and the plan of the
    headline's rows 540-1079."""
    cfg = configs()
    errs = {"band": 0.0, "windows_band": 0.0, "list_band": 0.0}
    parts, planned_parts = [], []
    plans = {}

    def band(name, src, rot, kw, row0, count):
        got = B1.remap_tonemap(src, rot, row_offset=row0, row_count=count, **kw)
        want = B1.remap_tonemap_plain(src, rot, row_offset=row0, row_count=count, **kw)
        torch.cuda.synchronize()
        m = compare(torch, got, want)[0]
        check(m == 0.0, f"{name}: band [{row0}, {row0 + count}) differs from its plain version "
                        f"(max abs {m})")
        errs["band"] = max(errs["band"], m)
        return got

    def planned_band(name, config, src, rot, kw, row0, count, b1_band):
        """The planned path in rows [row0, row0 + count) against B1's band."""
        key = (config, row0, count)
        if key not in plans:
            plans[key] = P.make_plan(
                rot, in_h=src.shape[1], in_w=src.shape[2], channels=src.shape[3], split=False,
                device=dev, row_offset=row0, row_count=count,
                **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})
        plan = plans[key]
        bkw = dict(kw, row_offset=row0, row_count=count)
        for err_key, entries, run, plain, extra in (
                ("windows_band", plan.rescue, B2.remap_windows, B2.remap_windows_plain,
                 dict(split=False)),
                ("list_band", plan.direct, B1.remap_tonemap_list, B1.remap_tonemap_list_plain,
                 None)):
            if not len(entries):
                continue
            got = torch.full_like(b1_band, math.nan)
            want = got.clone()
            misses = B2.new_misses(dev)
            if extra is None:
                run(src, rot, got, entries, **bkw)
                plain(src, rot, want, entries, **bkw)
            else:
                run(src, rot, got, entries, misses=misses, classes=plan.rescue_classes,
                    **extra, **bkw)
                plain(src, rot, want, entries, misses=B2.new_misses(dev), **extra, **bkw)
            torch.cuda.synchronize()
            check(int(misses.item()) == 0, f"{name}: B2's band read outside its windows")
            m = compare(torch, got, want)[0]
            check(m == 0.0, f"{name}: {err_key} in [{row0}, {row0 + count}) differs from its "
                            f"plain version (max abs {m})")
            errs[err_key] = max(errs[err_key], m)
        misses = B2.new_misses(dev)
        got = RF.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw)
        torch.cuda.synchronize()
        check(int(misses.item()) == 0, f"{name}: the planned band read outside its windows")
        check(compare(torch, got, b1_band)[0] == 0.0,
              f"{name}: the planned band [{row0}, {row0 + count}) differs from B1's band")
        sizes = plan.sizes()
        return sizes["rescue"], sizes["direct"]

    (h, w, c), kw, rot = cfg["3"]
    out_h = kw["out_h"]
    for batch in (1, 4):
        src = to_dev(torch, np.random.default_rng(60 + batch).uniform(0, 2, (batch, h, w, c))
                     .astype(np.float32), dev)
        frame = B1.remap_tonemap(src, rot, **kw)
        for n_rows in (4, 7):
            rows = -(-out_h // n_rows)
            bands, lists = [], []
            for j in range(n_rows):
                bands.append(band(f"headline batch {batch}", src, rot, kw, j * rows, rows))
                lists.append(planned_band(f"headline batch {batch}", "3", src, rot, kw,
                                          j * rows, rows, bands[-1]))
            joined = torch.cat(bands, dim=1)
            check(joined.shape[1] == n_rows * rows, f"{n_rows} bands hold {joined.shape[1]} rows")
            check(compare(torch, joined[:, :out_h], frame)[0] == 0.0,
                  f"headline batch {batch}: {n_rows} bands of {rows} rows differ from B1's frame")
            parts.append(f"batch {batch}, {n_rows} x {rows} rows (to row {n_rows * rows})")
            if batch == 1:
                planned_parts.append(f"headline {n_rows} x {rows} rows: (rescue, direct) "
                                     f"{lists}, batch 1 and 4")
            del bands, joined
        del src, frame
    for name in ("1", "2", "4"):
        (h, w, c), kw, rot = cfg[name]
        src = to_dev(torch, np.random.default_rng(64 + int(name)).uniform(0, 2, (1, h, w, c))
                     .astype(np.float32), dev)
        row0, count = kw["out_h"] // 3, kw["out_h"] // 4
        got = band(f"config {name}", src, rot, kw, row0, count)
        frame = B1.remap_tonemap(src, rot, **kw)
        check(compare(torch, got, frame[:, row0:row0 + count])[0] == 0.0,
              f"config {name}: band [{row0}, {row0 + count}) differs from B1's frame")
        parts.append(f"config {name} rows [{row0}, {row0 + count})")
        if name == "2":
            rows = kw["out_h"] // 4
            lists = [planned_band("config 2", "2", src, rot, kw, j * rows, rows,
                                  band("config 2", src, rot, kw, j * rows, rows))
                     for j in range(4)]
            planned_parts.append(f"config 2, 4 x {rows} rows: (rescue, direct) {lists}")
            check(sum(d for _, d in lists) > 0, "config 2's bands have no direct sub-tile")
    say("band", f"B1 band mode == its plain version and == B1's frame's rows, bit for bit: "
                f"{'; '.join(parts)}")
    say("band", f"planned path inside each band (no split list), from the band's plan: B2 band "
                f"mode and B1 list band mode == their plain versions, the planned band == B1's "
                f"band, bit for bit, 0 reads outside windows: {'; '.join(planned_parts)}")
    return errs, plans[("3",) + HEADLINE_BAND]


# FFmpeg v360's c6x1 cubemap of an 8K 360 video frame (the benchmark's
# cubemap8k): a 3840x7680 equirect to six 90-degree 1920^2 rectilinear
# faces, bilinear, in v360's order rludfb, (pan, pitch, roll) in this
# package's rotation_matrix_degrees.
CUBE_FACES = ((-90.0, 0.0, 0.0), (90.0, 0.0, 0.0), (0.0, -90.0, 0.0), (0.0, 90.0, 0.0),
              (0.0, 0.0, 0.0), (180.0, 0.0, 0.0))


def phase_views(torch, B1, RF, L, rotation_matrix_degrees, dev, smi):
    """B1's view mode: the launch counts set to 0, then remap_tonemap_batch
    with a (V, 3, 3) stack against the plain path and against one launch a
    view, bit for bit, and timed in turns against the plain path on the
    cubemap. Returns (launches, max abs, times)."""
    from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts

    reset_counts()
    calls = views_run = 0
    worst = 0.0
    parts = []

    def run(name, src, stack, kw):
        nonlocal calls, views_run, worst
        got = RF.remap_tonemap_batch(src, stack, **kw)
        calls += 1
        views_run += len(stack)
        want = B1.remap_tonemap_plain(src, stack, **kw)
        host = stack.cpu().numpy() if isinstance(stack, torch.Tensor) else stack
        for v in range(len(host)):
            one = B1.remap_tonemap(src, host[v], **kw)
            check(compare(torch, got[:, v], one)[0] == 0.0,
                  f"{name}: view {v} differs from its single-rotation launch")
        torch.cuda.synchronize()
        m, p, _ = compare(torch, got, want, finite=True)
        check(m == 0.0, f"{name}: view mode differs from the plain path (max abs {m})")
        worst = max(worst, m)
        parts.append(f"{name} {m:.3g}")

    cube = np.stack([rotation_matrix_degrees(*f) for f in CUBE_FACES])
    kw = dict(in_lens=L.full_equirectangular(), out_lens=L.Rectilinear(18.0, 36.0, 36.0),
              out_h=1920, out_w=1920, interp="bilinear")
    gen = torch.Generator(device=dev).manual_seed(71)
    src = torch.rand((1, 3840, 7680, 3), generator=gen, device=dev) * 2
    run("cubemap 8K, numpy stack", src, cube, kw)
    run("cubemap 8K, CUDA stack", src, to_dev(torch, cube, dev), kw)
    small = dict(kw, out_h=60, out_w=72, interp="bicubic", exposure=2.0, reinhard=4.0)
    s4 = torch.rand((2, 200, 400, 4), generator=gen, device=dev) * 2
    run("batch 2, C = 4, bicubic, tonemap", s4, cube, small)
    many = np.stack([rotation_matrix_degrees(18.0 * k, 7.0 * k - 60.0, 3.0 * k)
                     for k in range(20)])
    run(f"{len(many)} views (more than {B1.MAX_VIEWS_BY_VALUE} go by value)", s4, many, small)
    check(COUNTS["b1.views"] == calls and COUNTS["b1.views_computed"] == views_run,
          f"view mode: {COUNTS['b1.views']} launches of {COUNTS['b1.views_computed']} views "
          f"for {calls} calls of {views_run} views")
    say("views", f"view mode vs the plain path and one launch a view, bit for bit: "
                 f"{'; '.join(parts)}; b1.views {COUNTS['b1.views']}, b1.views_computed "
                 f"{COUNTS['b1.views_computed']}")
    launches = COUNTS["b1.views"]
    plain_ms, ms = in_turns(torch, lambda: B1.remap_tonemap_plain(src, cube, **kw),
                            lambda: RF.remap_tonemap_batch(src, cube, **kw), 2, 25)
    texels, pixels = remap_footprint((3840, 7680), cube, kw, dev)
    counts = remap_counts(texels, 3, pixels, kw["interp"])
    b_ms, b_by = bound(*counts)
    say("views", f"cubemap 8K, six faces in one launch: B1 {ms:.4f} ms a frame "
                 f"({pixels / 1e3 / ms:.1f} Mpix/s), plain path {plain_ms:.4f} ms; the taps read "
                 f"{texels} of {3840 * 7680} source texels (the faces' union); "
                 f"{counts[0] / 1e6:.1f} MB moved: bound {b_ms:.4f} ms ({b_by}), B1 at "
                 f"{100 * b_ms / ms:.1f} % of it; card {smi}")
    return {"views": launches}, {"views": worst}, {"views": (ms, plain_ms, None, counts)}


def phase_field(torch, B1, dev, smi):
    """B1's coordinate field: three calls a configuration, bit for bit with
    the plain path, and the counters; the headline's and config 2's read
    launches timed in turns against B1's direct launch of the same
    constants (``ilr_remap_frame``), and the headline's against the plain
    path; the headline's ``coord_field`` against the plain path's
    coordinates, bit for bit and in turns. Returns (max abs, times) of the
    read instance (``field``) and of ``coord_field``."""
    import ctypes

    from image_lens_reproject_torch.ops import remap as R
    from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts

    B1.FIELDS = B1.FieldCache()
    reset_counts()
    cfg = configs()
    cases = {"headline": ("3", {}), "config 2": ("2", {}),
             "headline band rows 540-1079": ("3", dict(row_offset=540, row_count=540))}
    sources = {}
    worst = 0.0
    for i, (name, (key, band)) in enumerate(cases.items()):
        (h, w, c), kw, rot = cfg[key]
        src = sources.setdefault(key, to_dev(torch, np.random.default_rng(60 + i).uniform(
            0, 2, (1, h, w, c)).astype(np.float32), dev))
        kw = dict(kw, **band)
        before = (COUNTS["b1.field_bypass"], COUNTS["b1.field_fill"], COUNTS["b1.field_hit"])
        outs = [B1.remap_tonemap(src, rot, **kw) for _ in range(3)]
        want = B1.remap_tonemap_plain(src, rot, **kw)
        torch.cuda.synchronize()
        for k, got in enumerate(outs):
            err = compare(torch, got, want)[0]
            worst = max(worst, err)
            check(err == 0.0, f"{name}: call {k + 1} differs from the plain path")
        after = (COUNTS["b1.field_bypass"], COUNTS["b1.field_fill"], COUNTS["b1.field_hit"])
        check(tuple(a - b for a, b in zip(after, before)) == (1, 1, 1),
              f"{name}: field counters (bypasses, fills, hits) went {before} -> {after}")
    say("field", f"headline, config 2, a headline band: direct, fill + read, read, each bit for "
                 f"bit with the plain path; b1.field_bypass {COUNTS['b1.field_bypass']}, "
                 f"b1.field_fill {COUNTS['b1.field_fill']}, b1.field_hit "
                 f"{COUNTS['b1.field_hit']}; {len(B1.FIELDS)} fields, "
                 f"{B1.FIELDS.bytes / 1e6:.1f} MB")
    lib = B1.library()
    times = {}
    for key in ("3", "2"):
        (h, w, c), kw, rot = cfg[key]
        src = sources[key]
        # remap_tonemap's defaults, so that p is the constants it launches with.
        p, _, stream = B1.launch_setup(
            "chip_smoke", src, rot, **dict(dict(n_samples=1, exposure=1.0, reinhard=1.0), **kw))
        out = torch.empty((1, kw["out_h"], kw["out_w"], c), device=dev)

        def direct():
            rc = lib.ilr_remap_frame(src.data_ptr(), out.data_ptr(), None, ctypes.byref(p),
                                     dev.index, stream)
            check(rc == 0, f"config {key}: B1's direct launch failed: CUDA error {rc}")

        def read():
            return B1.remap_tonemap(src, rot, **kw)

        hits = COUNTS["b1.field_hit"]
        direct_ms, ms = in_turns(torch, direct, read, 25, 25)
        check(COUNTS["b1.field_hit"] > hits, f"config {key}: the timed calls read no field")
        texels, pixels = remap_footprint((h, w), rot, kw, dev)
        counts = remap_counts(texels, c, pixels, kw["interp"], extra_bytes=8 * pixels)
        b_ms, b_by = bound(*counts)
        frame_ms = bound(*remap_counts(texels, c, pixels, kw["interp"]))[0]
        say("field", f"config {key}: B1 reading the field {ms:.4f} ms, its direct launch "
                     f"{direct_ms:.4f} ms ({direct_ms / ms:.2f}x); bound with the field's 8 B a "
                     f"pixel {b_ms:.4f} ms ({b_by}): {100 * b_ms / ms:.1f} %; the frame's bound "
                     f"{frame_ms:.4f} ms: {100 * frame_ms / ms:.1f} % against "
                     f"{100 * frame_ms / direct_ms:.1f} %; card {smi}")
        if key != "3":
            continue
        plain_ms, _ = in_turns(torch, lambda: B1.remap_tonemap_plain(src, rot, **kw), read, 3, 5)
        times["field"] = (ms, plain_ms, None, counts)
        # coord_field over the headline's frame against the plain path's
        # coordinates of every pixel centre (offset 0: one supersample).
        field = torch.empty((p.band_rows, p.out_w, 2), device=dev)

        def fill():
            rc = lib.ilr_coord_field(field.data_ptr(), ctypes.byref(p), dev.index, stream)
            check(rc == 0, f"coord_field failed: CUDA error {rc}")

        out_h, out_w = kw["out_h"], kw["out_w"]
        cx = R.pixel_centres(torch.arange(out_w, device=dev)[None, :], out_w)
        cy = R.pixel_centres(torch.arange(out_h, device=dev)[:, None], out_h)
        rot_t = R.rotation_tensor(rot, dev)

        def coords():
            return R.source_coords(kw["in_lens"], kw["out_lens"], h, w, cx + 0.0, cy + 0.0,
                                   rot_t, out_h, out_w)

        fill()
        sx, sy = coords()
        torch.cuda.synchronize()
        coord_err = max(compare(torch, field[..., 0], sx.expand(out_h, out_w))[0],
                        compare(torch, field[..., 1], sy.expand(out_h, out_w))[0])
        check(coord_err == 0.0, f"coord_field differs from the plain coordinates by {coord_err}")
        coord_plain_ms, coord_ms = in_turns(torch, coords, fill, 5, 25)
        coord_counts = (8 * pixels, 0)
        cb_ms, cb_by = bound(*coord_counts)
        times["coord_field"] = (coord_ms, coord_plain_ms, None, coord_counts)
        say("field", f"coord_field, the headline's frame: {coord_ms:.4f} ms once a "
                     f"configuration, the plain path's coordinates {coord_plain_ms:.4f} ms, bit "
                     f"for bit; bound (the field's {8 * pixels / 1e6:.1f} MB written) "
                     f"{cb_ms:.4f} ms ({cb_by}), {100 * cb_ms / coord_ms:.1f} % of it; read "
                     f"{ms:.4f} ms against the plain path {plain_ms:.4f} ms; card {smi}")
        del field
    return {"field": worst, "coord_field": coord_err}, times


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_mesh(torch, B1, B2, cli, dev, tmp):
    """The mesh path, its launches counted: ``sharded_remap_step`` on meshes
    that name ``dev`` at every position, on 4 headline frames, without and
    with band plans (``band_plans``: the planned path inside each band),
    and with band plans on one config-2 frame over mesh (1, 4), whose bands
    have direct sub-tiles; the same step, without and with band plans, on
    ``distributed.global_mesh(1, 1)`` of a one-rank process group (NCCL on
    the card); the CLI with ``--mesh 1,1``, ``auto`` and ``2,2``, and with
    ``--mesh 1,1 --rescue on --split on``, on the main path's frames in
    ``tmp/in``. Outputs equal B1's frame bit for bit, with no read outside
    a window, and the CLI's files the default run's (``tmp/out``) byte for
    byte. Returns the launches."""
    import torch.distributed as dist
    from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts
    from image_lens_reproject_torch.parallel import batch as PB
    from image_lens_reproject_torch.parallel import distributed
    from image_lens_reproject_torch.parallel import mesh as PM

    cfg = configs()
    (h, w, c), kw, rot = cfg["3"]
    host = torch.from_numpy(np.random.default_rng(70).uniform(0, 2, (4, h, w, c)).astype(np.float32))
    want = B1.remap_tonemap(host.to(dev), rot, **kw).cpu()
    plan_kw = dict(in_h=h, in_w=w, channels=c, rotation=rot,
                   **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})

    def same(what, got, expected=want):
        check(compare(torch, got, expected)[0] == 0.0, f"{what}: differs from B1's frame")

    def planned_step(what, mesh, batch, step_kw, band_kw, expected):
        plans = PB.band_plans(mesh, **band_kw)
        check(all(len(p.split) == 0 for p in plans.values()), f"{what}: a band has a split list")
        misses = {pos: B2.new_misses(mesh.devices[pos[0]][pos[1]]) for pos in plans}
        out = PB.sharded_remap_step(PB.shard_batch(batch, mesh), band_kw["rotation"], mesh=mesh,
                                    plans=plans, misses=misses, **step_kw).assemble()
        n = sum(int(m.item()) for m in misses.values())
        check(n == 0, f"{what} with band plans: {n} reads outside windows")
        same(f"{what} with band plans", out, expected)
        return sorted({(p.band, p.sizes()["rescue"], p.sizes()["direct"])
                       for p in plans.values()})

    reset_counts()
    t0 = time.perf_counter()
    for b, r in MESHES:
        mesh = PM.make_mesh([dev] * (b * r), batch=b, rows=r)
        same(f"mesh ({b}, {r})", PB.sharded_remap_step(PB.shard_batch(host, mesh), rot, mesh=mesh,
                                                        **kw).assemble())
    steps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bands = {}
    for b, r in MESHES:
        mesh = PM.make_mesh([dev] * (b * r), batch=b, rows=r)
        bands[(b, r)] = planned_step(f"mesh ({b}, {r})", mesh, host, kw, plan_kw, want)
    (h2, w2, c2), kw2, rot2 = cfg["2"]
    host2 = torch.from_numpy(np.random.default_rng(73).uniform(0, 2, (1, h2, w2, c2))
                             .astype(np.float32))
    want2 = B1.remap_tonemap(host2.to(dev), rot2, **kw2).cpu()
    plan_kw2 = dict(in_h=h2, in_w=w2, channels=c2, rotation=rot2,
                    **{k: kw2[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})
    bands_c2 = planned_step("config 2, mesh (1, 4)", PM.make_mesh([dev] * 4, batch=1, rows=4),
                            host2, kw2, plan_kw2, want2)
    planned_s = time.perf_counter() - t0
    backend = "cuda" if dev.type == "cuda" else "cpu"
    address = f"localhost:{_free_port()}"
    active = distributed.init(address, 1, 0, device=backend, timeout=120)
    check(not active and dist.is_initialized() and dist.get_world_size() == 1,
          f"distributed.init({address!r}, 1, 0) gave {active}, initialized {dist.is_initialized()}")
    try:
        mesh = distributed.global_mesh(1, 1)
        check(mesh.ranks == ((0,),) and mesh.devices == ((dev,),), f"global_mesh(1, 1): {mesh}")
        same("global_mesh(1, 1)", PB.sharded_remap_step(PB.shard_batch(host, mesh), rot, mesh=mesh,
                                                         **kw).assemble())
        planned_step("global_mesh(1, 1)", mesh, host, kw, plan_kw, want)
        group = f"{dist.get_backend()} group of 1 rank at {address}"
    finally:
        dist.destroy_process_group()
    runs = []
    names = sorted(p.name for p in (tmp / "in").glob("*.exr"))
    for arg, extra in (("1,1", []), ("auto", []), ("2,2", []),
                       ("1,1", ["--rescue", "on", "--split", "on"])):
        text = io.StringIO()
        out = tmp / f"mesh_{arg.replace(',', 'x')}{'_rescued' if extra else ''}"
        with contextlib.redirect_stdout(text):
            wall = _cli(cli, torch, headline_args(tmp / "in") + ["-o", str(out), "--mesh", arg]
                        + extra)
        label = " ".join(["--mesh", arg] + extra)
        for line in text.getvalue().splitlines():
            say("mesh", f"{label}: {line}")
        warned = ("Warning: --mesh 2x2 needs 4 devices, have 1; using single-device dispatch"
                  in text.getvalue())
        check(warned == (arg == "2,2" and torch.cuda.device_count() < 4),
              f"{label}: warning printed {warned}")
        for name in names:
            check((out / name).read_bytes() == (tmp / "out" / name).read_bytes(),
                  f"{label}: {name} differs from the default run's")
        runs.append(f"{label} {wall:.2f} s{' (warned)' if warned else ''}")
    launches = {"band": COUNTS["b1.band"], "mesh_frame": COUNTS["b1.frame"],
                "windows_band": COUNTS["b2.band"], "list_band": COUNTS["b1.list_band"]}
    check(launches["band"] >= 1, "the mesh path never launched B1's band mode")
    check(launches["windows_band"] >= 1, "the mesh path never launched B2's band mode")
    check(launches["list_band"] >= 1, "the mesh path never launched B1 list mode's band mode")
    check(COUNTS["b2.split"] == 0, "a band launched B2's split mode")
    say("mesh", f"sharded_remap_step on meshes {list(MESHES)} of {dev} repeated, 4 headline "
                f"frames: == B1's frame bit for bit ({steps_s:.2f} s with host copies); with "
                f"band plans (band, rescue, direct) {bands}, and config 2 on mesh (1, 4) "
                f"{bands_c2}: == B1's frame bit for bit, 0 reads outside windows "
                f"({planned_s:.2f} s with plans and host copies); global_mesh(1, 1) of a "
                f"{group}: the same without and with band plans, group destroyed; CLI on "
                f"{len(names)} frames, {'; '.join(runs)}: the default run's bytes; launches "
                f"B1 band {launches['band']}, frame {launches['mesh_frame']}, list band "
                f"{launches['list_band']}, list {COUNTS['b1.list']}; B2 band "
                f"{launches['windows_band']}, frame {COUNTS['b2.frame']}, split "
                f"{COUNTS['b2.split']}")
    return launches


def phase_mesh_timing(torch, B1, B2, RF, dev, smi, band_plan):
    """At the headline's rows 540-1079, in turns: B1's band against its
    plain version; the planned band (from ``band_plan``, the band's plan)
    against B1's band at batch 1 and 4; B2's band mode over the plan's
    rescue list and B1 list mode's band mode over every sub-tile of the
    band, each against its plain version, with their bounds; then the
    (2, 2) mesh step on this one card against B1's frame, and with band
    plans against without, at batch 4."""
    from image_lens_reproject_torch.parallel import batch as PB
    from image_lens_reproject_torch.parallel import mesh as PM

    (h, w, c), kw, rot_host = configs()["3"]
    rot = to_dev(torch, rot_host, dev)
    row0, count = HEADLINE_BAND
    bkw = dict(kw, row_offset=row0, row_count=count)
    src = to_dev(torch, np.random.default_rng(71).uniform(0, 2, (1, h, w, c)).astype(np.float32), dev)
    plain_ms, ms = in_turns(
        torch, lambda: B1.remap_tonemap_plain(src, rot, **bkw),
        lambda: B1.remap_tonemap(src, rot, **bkw), 5, 25)
    texels, pixels = remap_footprint((h, w), rot, kw, dev, band=HEADLINE_BAND)
    counts = remap_counts(texels, c, pixels, kw["interp"])
    b_ms, b_by = bound(*counts)
    times = {"band": (ms, plain_ms, None, counts)}
    say("timing", f"config 3, B1 band rows [{row0}, {row0 + count}): {ms:.4f} ms, plain path "
                  f"{plain_ms:.4f} ms; the taps read {texels} of {h * w} source texels; "
                  f"{counts[0] / 1e6:.1f} MB moved: bound {b_ms:.4f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.1f} % of it")
    src4 = to_dev(torch, np.random.default_rng(72).uniform(0, 2, (4, h, w, c)).astype(np.float32), dev)
    misses = B2.new_misses(dev)
    for batch, s in ((1, src), (4, src4)):
        band_ms, planned_ms = in_turns(
            torch, lambda: B1.remap_tonemap(s, rot, **bkw),
            lambda: RF.remap_tonemap_planned_batch(s, rot, band_plan, misses=misses, **kw),
            25 // batch, 25 // batch)
        times[f"planned_band{batch}"] = (planned_ms / batch, band_ms / batch)
        say("timing", f"config 3 band rows [{row0}, {row0 + count}) at batch {batch}: planned "
                      f"band ({band_plan.sizes()}) {planned_ms / batch:.4f} ms a frame, B1's band "
                      f"{band_ms / batch:.4f} ms a frame ({planned_ms / band_ms:.2f}x)")
    out = torch.empty((1, count, kw["out_w"], c), device=dev)
    rescue = band_plan.rescue
    plain_ms, ms = in_turns(
        torch,
        lambda: B2.remap_windows_plain(src, rot, out, rescue, split=False, misses=misses, **bkw),
        lambda: B2.remap_windows(src, rot, out, rescue, split=False, misses=misses,
                                 classes=band_plan.rescue_classes, **bkw), 3, 25)
    check(int(misses.item()) == 0, "the planned band read outside its windows while timed")
    texels, pixels = remap_footprint((h, w), rot, kw, dev, tiles=rescue, band=HEADLINE_BAND)
    counts = remap_counts(texels, c, pixels, kw["interp"], extra_bytes=4 * rescue.numel())
    times["windows_band"] = (ms, plain_ms, None, counts)
    parts = [f"B2 band {ms:.4f} ms over {rescue.shape[0]} sub-tiles (plain {plain_ms:.4f}; "
             f"bound {bound(*counts)[0]:.4f} ms, {bound(*counts)[1]}, "
             f"{100 * bound(*counts)[0] / ms:.1f} %)"]
    rows, cols = band_plan.grid
    every = torch.stack(torch.meshgrid(torch.arange(rows), torch.arange(cols), indexing="ij"), -1)
    every = every.reshape(-1, 2).to(torch.int32).to(dev)
    plain_ms, ms = in_turns(
        torch, lambda: B1.remap_tonemap_list_plain(src, rot, out, every, **bkw),
        lambda: B1.remap_tonemap_list(src, rot, out, every, **bkw), 3, 25)
    check(compare(torch, out, B1.remap_tonemap(src, rot, **bkw))[0] == 0.0,
          "list band mode over every sub-tile of the band differs from B1's band")
    texels, pixels = remap_footprint((h, w), rot, kw, dev, tiles=every, band=HEADLINE_BAND)
    counts = remap_counts(texels, c, pixels, kw["interp"], extra_bytes=4 * every.numel())
    times["list_band"] = (ms, plain_ms, None, counts)
    parts.append(f"B1 list band {ms:.4f} ms over all {every.shape[0]} sub-tiles (plain "
                 f"{plain_ms:.4f}; bound {bound(*counts)[0]:.4f} ms, {bound(*counts)[1]}, "
                 f"{100 * bound(*counts)[0] / ms:.1f} %; B1's band {times['band'][0]:.4f} ms)")
    say("timing", f"config 3 band rows [{row0}, {row0 + count}), band kernels alone: "
                  f"{'; '.join(parts)}; card {smi}")
    mesh = PM.make_mesh([dev] * 4, batch=2, rows=2)
    frame_ms, step_ms = in_turns(
        torch, lambda: B1.remap_tonemap(src4, rot, **kw),
        lambda: PB.sharded_remap_step(PB.shard_batch(src4, mesh), rot, mesh=mesh, **kw), 2, 5)
    say("timing", f"mesh (2, 2) step, one card, bands in turn (not a multi-GPU time): "
                  f"{step_ms / 4:.4f} ms a frame ({step_ms:.4f} ms for 4 frames: shard, gather "
                  f"copies, 4 band launches), B1's frame at batch 4 {frame_ms / 4:.4f} ms a frame "
                  f"({step_ms / frame_ms:.2f}x); card {smi}")
    plans = PB.band_plans(mesh, in_h=h, in_w=w, channels=c, rotation=rot_host,
                          **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})
    counters = {pos: B2.new_misses(dev) for pos in plans}
    plain_step_ms, planned_step_ms = in_turns(
        torch, lambda: PB.sharded_remap_step(PB.shard_batch(src4, mesh), rot, mesh=mesh, **kw),
        lambda: PB.sharded_remap_step(PB.shard_batch(src4, mesh), rot, mesh=mesh, plans=plans,
                                      misses=counters, **kw), 2, 5)
    check(sum(int(m.item()) for m in counters.values()) == 0,
          "the (2, 2) step with band plans read outside its windows while timed")
    say("timing", f"mesh (2, 2) step, one card, bands in turn, batch 4: with band plans "
                  f"{planned_step_ms / 4:.4f} ms a frame, without {plain_step_ms / 4:.4f} ms a "
                  f"frame ({planned_step_ms / plain_step_ms:.2f}x); card {smi}")
    return times


def phase_probes(torch, probes, dev):
    """The probe entry points as a user runs them, their kernels' launches
    counted; then each probe kernel against its plain version on the card.
    Returns (launches, max abs errors, timing inputs)."""
    from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts

    DP, RP, GC, WW = probes
    reset_counts()
    records = {}  # op_cost's timings, op class -> the entry point's JSON line
    for mod in (DP, RP, GC, WW):
        name = mod.__name__.rsplit(".", 1)[1]
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = mod.main(["--device", "cuda"])
        for line in text.getvalue().splitlines():
            say("probes", f"{name}: {line}")
            if mod is GC and line.startswith('{"op"'):
                rec = json.loads(line)
                records[rec["op"]] = rec
        check(rc == 0, f"python -m image_lens_reproject_torch.probes.{name} returned {rc}")
        say("probes", f"{name}: rc 0 in {time.perf_counter() - t0:.2f} s")
    check(sorted(records) == sorted(GC.OPS) and
          all("ns_per_tile_op_per_sm" in rec for rec in records.values()),
          f"gather_cost_probe timed {sorted(records)}, expected every class of {GC.OPS}")
    kernels = ("window_copy", "window_scan_db", "lane_roll", "op_cost", "window_gather")
    launches = {key: COUNTS["probes." + key] for key in kernels}
    for key, n in launches.items():
        check(n >= 1, f"the probe entry points never launched {key}")
    say("probes", f"launches on the entry points' runs: {launches}")

    errs = {}

    def same(key, got, want):
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"{key}: the kernel differs from its plain version on the card")
        errs[key] = max(errs.get(key, 0.0), float((got - want).abs().max()) if got.numel() else 0.0)

    rng, src, offs, offs_db = DP.check_inputs()
    src = to_dev(torch, src, dev)
    big = to_dev(torch, DP.timing_table(rng), dev)
    for table in (to_dev(torch, offs, dev), to_dev(torch, offs_db, dev), big):
        same("window_copy", DP.window_copy(src, table), DP.window_copy_plain(src, table))
        same("window_scan_db", DP.window_scan_db(src, table, DP.N_STEPS),
             DP.window_scan_db_plain(src, table, DP.N_STEPS))
    rng, x, shifts = RP.check_inputs()
    x, shifts = to_dev(torch, x, dev), to_dev(torch, shifts, dev)
    same("lane_roll", RP.lane_roll(x, shifts), RP.lane_roll_plain(x, shifts))
    roll_inputs = RP.timing_inputs(rng, dev)
    same("lane_roll", RP.lane_roll(*roll_inputs), RP.lane_roll_plain(*roll_inputs))
    roll_edges, t0 = 0, time.perf_counter()
    for xe, se in RP.edge_cases(dev):
        same("lane_roll", RP.lane_roll(xe, se), RP.lane_roll_plain(xe, se))
        roll_edges += 1
    roll_edges_s = time.perf_counter() - t0
    for _, channels, inputs in WW.cases():
        inputs = [to_dev(torch, a, dev) for a in inputs]
        same("window_gather", WW.window_gather(*inputs, channels),
             WW.window_gather_plain(*inputs, channels))
    gather_inputs = {}
    rng = np.random.default_rng(8)
    for drift in (False, True):
        inputs = [to_dev(torch, a, dev) for a in WW.case_inputs(rng, K8_SUBTILES, 1, 4, 3,
                                                                  drift=drift)]
        same("window_gather", WW.window_gather(*inputs, 3), WW.window_gather_plain(*inputs, 3))
        gather_inputs[drift] = inputs
    edge_cases = probe_edge_cases(torch, DP, WW, dev, same)
    x, idx = GC.check_inputs()
    n = GC.copies_for(dev)
    xb = to_dev(torch, np.broadcast_to(x, (n,) + x.shape[1:]), dev)
    ib = to_dev(torch, np.broadcast_to(idx, (n,) + idx.shape[1:]), dev)
    for op in GC.OPS:
        same("op_cost", GC.op_cost(xb, ib, op, GC.CHECK_ITERS),
             GC.op_cost_plain(xb, ib, op, GC.CHECK_ITERS))
    say("probes", f"kernels against their plain versions on the card, bit for bit: window_copy and "
                  f"window_scan_db on 3 tables (64, 64, {DP.BIG_TILES} tiles), lane_roll on "
                  f"{RP.N_TILES} and {RP.BIG_TILES} tiles and on {roll_edges} edge calls in "
                  f"{roll_edges_s:.1f} s (n "
                  f"{RP.EDGE_N} x h {RP.EDGE_H} x w {RP.EDGE_W}; at n = 1 each shift of "
                  f"roll_probe.edge_shifts), window_gather on the 10 probe cases "
                  f"and {K8_SUBTILES} sub-tiles (row-invariant, drift), op_cost x {len(GC.OPS)} "
                  f"op classes at {GC.CHECK_ITERS} trips on {n} tiles; {edge_cases}")
    return launches, errs, (src, big, roll_inputs, gather_inputs, xb, ib, records)


def probe_edge_cases(torch, DP, WW, dev, same):
    """window_scan_db and window_gather against their plain versions on the
    card: the scan at ``DP.EDGE_STEPS`` on the probe's tables, the edge
    table and the timing table, from each of ``DP.EDGE_SOURCES``; the
    gather on ``WW.EDGE_CASES``, both tap counts. Returns a summary."""
    rng, src, offs, offs_db = DP.check_inputs()
    tables = [to_dev(torch, t, dev) for t in (offs, offs_db, DP.EDGE_OFFS, DP.timing_table(rng))]
    full = to_dev(torch, src, dev)
    for layout in DP.EDGE_SOURCES:
        s = DP.edge_source(full, layout)
        for table in tables:
            for steps in DP.EDGE_STEPS:
                same("window_scan_db", DP.window_scan_db(s, table, steps),
                     DP.window_scan_db_plain(s, table, steps))
    g = np.random.default_rng(9)
    for label in WW.EDGE_CASES:
        for taps in WW.TAPS:
            inputs = WW.edge_inputs(g, label, taps, dev)
            same("window_gather", WW.window_gather(*inputs, 3), WW.window_gather_plain(*inputs, 3))
    return (f"window_scan_db at {DP.EDGE_STEPS} steps on 4 tables x {list(DP.EDGE_SOURCES)} "
            f"sources; window_gather on {list(WW.EDGE_CASES)}, both tap counts")


def in_turns(torch, base, new, base_reps, new_reps, warmup=2):
    """Medians of (base, new) in ms a call, taken as base, new, new, base:
    each block warms up, then times three runs of back-to-back calls on the
    card's clock (``probes.loop_times``)."""
    from image_lens_reproject_torch.probes import loop_times

    t_base, t_new = [], []
    for block in (t_base, t_new, t_new, t_base):
        fn, reps = (new, new_reps) if block is t_new else (base, base_reps)
        block += loop_times(fn, warmup=warmup, reps=reps, rounds=3)
    return statistics.median(t_base), statistics.median(t_new)


def phase_timing(torch, B1, B2, RF, planned, dev, smi):
    """Times B1's direct launches: the field cache is swapped for one that
    remembers no first sighting, so no call fills or reads a field
    (``phase_field`` times the field's kernels)."""
    fields = B1.FIELDS
    B1.FIELDS = B1.FieldCache(seen_keys=0)
    try:
        return _timing(torch, B1, B2, RF, planned, dev, smi)
    finally:
        B1.FIELDS = fields


def _timing(torch, B1, B2, RF, planned, dev, smi):
    cfg = configs()
    times = {}
    for name in ("1", "2", "3", "4"):
        (h, w, c), kw, rot = cfg[name]
        src = to_dev(torch, np.random.default_rng(30 + int(name)).uniform(0, 2, (1, h, w, c))
                     .astype(np.float32), dev)
        rot = None if rot is None else to_dev(torch, rot, dev)
        plain_ms, ms = in_turns(torch, lambda: B1.remap_tonemap_plain(src, rot, **kw),
                                lambda: B1.remap_tonemap(src, rot, **kw), 5, 25)
        texels, pixels = remap_footprint((h, w), rot, kw, dev)
        counts = remap_counts(texels, c, pixels, kw["interp"])
        times[name] = (ms, plain_ms, None, counts)
        mpix = kw["out_h"] * kw["out_w"] / 1e3
        b_ms, b_by = bound(*counts)
        say("timing", f"config {name}, one frame: B1 {ms:.4f} ms ({mpix / ms:.1f} Mpix/s), plain path "
                      f"{plain_ms:.4f} ms ({mpix / plain_ms:.1f} Mpix/s); the taps read {texels} of "
                      f"{h * w} source texels; {counts[0] / 1e6:.1f} MB moved, "
                      f"{counts[1] / 1e9:.3f} G instructions counted: bound {b_ms:.4f} ms "
                      f"({b_by}), B1 at {100 * b_ms / ms:.1f} % of it")
    # The headline at batch 4: one launch for four frames.
    (h, w, c), kw, rot = cfg["3"]
    src = to_dev(torch, np.random.default_rng(35).uniform(0, 2, (4, h, w, c)).astype(np.float32), dev)
    rot = to_dev(torch, rot, dev)
    plain_ms, ms = in_turns(torch, lambda: B1.remap_tonemap_plain(src, rot, **kw),
                            lambda: B1.remap_tonemap(src, rot, **kw), 2, 10)
    times["3x4"] = (ms / 4, plain_ms / 4)
    del src
    say("timing", f"config 3 at batch 4: B1 {ms / 4:.4f} ms a frame ({ms:.4f} ms a launch), plain "
                  f"path {plain_ms / 4:.4f} ms a frame; at batch 1 B1 {times['3'][0]:.4f} ms")
    for name in ("3", "2"):
        src, plan = planned[name]
        (h, w, c), kw, rot = cfg[name]
        # On the card, as above: a host rotation is copied at every call,
        # and that copy waits for the work already queued.
        rot = None if rot is None else to_dev(torch, rot, dev)
        misses = B2.new_misses(dev)
        for batch in (1, 4):
            if batch > 1:
                src = to_dev(torch, np.random.default_rng(36).uniform(0, 2, (batch, h, w, c))
                             .astype(np.float32), dev)
            frame_ms, planned_ms = in_turns(
                torch, lambda: B1.remap_tonemap(src, rot, **kw),
                lambda: RF.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw),
                25 // batch, 25 // batch)
            key = f"planned{name}" + ("" if batch == 1 else f"x{batch}")
            times[key] = (planned_ms / batch, frame_ms / batch)
            check(int(misses.item()) == 0, f"config {name}: reads outside windows while timing")
            say("timing", f"config {name} at batch {batch}: planned path (B2 + B2 split + B1 list) "
                          f"{planned_ms / batch:.4f} ms a frame, B1 full frame "
                          f"{frame_ms / batch:.4f} ms a frame ({planned_ms / frame_ms:.2f}x)")
        del src
    # Each list kernel alone on config 2's lists, against its plain version.
    src, plan = planned["2"]
    (h, w, c), kw, rot = cfg["2"]
    rot = to_dev(torch, rot, dev)
    out = torch.empty((1, kw["out_h"], kw["out_w"], 3), device=dev)
    misses = B2.new_misses(dev)
    for key, entries, split, classes in (("windows", plan.rescue, False, plan.rescue_classes),
                                         ("windows_split", plan.split, True, plan.split_classes)):
        times[key] = in_turns(
            torch,
            lambda: B2.remap_windows_plain(src, rot, out, entries, split=split, misses=misses, **kw),
            lambda: B2.remap_windows(src, rot, out, entries, split=split, misses=misses,
                                     classes=classes, **kw), 3, 25)[::-1]
    times["list"] = in_turns(
        torch, lambda: B1.remap_tonemap_list_plain(src, rot, out, plan.direct, **kw),
        lambda: B1.remap_tonemap_list(src, rot, out, plan.direct, **kw), 3, 25)[::-1]
    parts = []
    for key, entries, label in (("windows", plan.rescue, "B2"), ("windows_split", plan.split,
                                                                 "B2 split"),
                                ("list", plan.direct, "B1 list")):
        texels, pixels = remap_footprint((h, w), rot, kw, dev, tiles=entries)
        counts = remap_counts(texels, c, pixels, kw["interp"], extra_bytes=4 * entries.numel())
        times[key] = times[key] + (None, counts)
        ms, plain_ms = times[key][:2]
        b_ms, b_by = bound(*counts)
        parts.append(f"{label} {ms:.4f} ms over {entries.shape[0]} sub-tiles (plain "
                     f"{plain_ms:.4f}; taps read {texels} texels, {counts[0] / 1e6:.2f} MB moved; "
                     f"bound {b_ms:.4f} ms, {b_by}, {100 * b_ms / ms:.1f} %)")
    say("timing", f"config 2 lists alone: {'; '.join(parts)}; card {smi}")
    # List mode over every sub-tile of the headline, against B1's frame: the
    # same pixels, the same instance, one thread a pixel in both.
    src, plan = planned["3"]
    (h, w, c), kw, rot = cfg["3"]
    rot = to_dev(torch, rot, dev)
    rows, cols = plan.grid
    every = torch.stack(torch.meshgrid(torch.arange(rows), torch.arange(cols), indexing="ij"), -1)
    every = every.reshape(-1, 2).to(torch.int32).to(dev)
    out = torch.empty((1, kw["out_h"], kw["out_w"], c), device=dev)
    frame_ms, list_ms = in_turns(torch, lambda: B1.remap_tonemap(src, rot, **kw),
                                 lambda: B1.remap_tonemap_list(src, rot, out, every, **kw), 25, 25)
    check(compare(torch, out, B1.remap_tonemap(src, rot, **kw))[0] == 0.0,
          "list mode over every sub-tile differs from B1's frame")
    say("timing", f"config 3, B1 list mode over all {every.shape[0]} sub-tiles {list_ms:.4f} ms, "
                  f"B1 full frame {frame_ms:.4f} ms ({list_ms / frame_ms:.2f}x), equal bit for bit")
    return times


def phase_probe_timing(torch, probes, inputs, smi):
    """Each probe kernel against its plain version in turns, at the probes'
    timing shapes; lane_roll also against one torch.gather (stride-0 index,
    in turns; a materialised index on a line of its own); op_cost per op
    class at 256 trips, beside the entry point's own times at the probe's
    two trip counts. Returns name -> (ms, plain ms, library ms or None,
    (bytes, instructions))."""
    from image_lens_reproject_torch.probes import loop_ms

    DP, RP, GC, WW = probes
    src, big, (xr, sr), gather_inputs, xb, ib, records = inputs
    times = {}
    n = int(big.shape[0])
    ids = torch.arange(src.numel(), device=src.device).view(src.shape)
    for key, plain, kernel, steps in (
            ("window_copy", lambda: DP.window_copy_plain(src, big),
             lambda: DP.window_copy(src, big), None),
            ("window_scan_db", lambda: DP.window_scan_db_plain(src, big, DP.N_STEPS),
             lambda: DP.window_scan_db(src, big, DP.N_STEPS), DP.N_STEPS)):
        plain_ms, ms = in_turns(torch, plain, kernel, 10, 25)
        texels = distinct(src.numel(), (DP.windows(ids, big, s) for s in range(steps or 1)))
        times[key] = (ms, plain_ms, None, window_counts(texels, n, steps))
        per = f"{ms * 1e6 / n / (steps or 1):.1f} ns/{'step' if steps else 'tile'}"
        b_ms = bound(*times[key][3])[0]
        say("timing", f"{key} over {n} tiles: {ms:.4f} ms ({per}), plain {plain_ms:.4f} ms; "
                      f"windows cover {texels} of {src.numel()} source values; bound "
                      f"{b_ms:.4f} ms, {100 * b_ms / ms:.1f} %")

    # The library call: one torch.gather with the index precomputed outside
    # the timed loop. Materialised (.contiguous(), int64) it reads 8 more
    # bytes an element than the roll needs; stride-0 (the index of one row,
    # expanded) it reads the values only. The stride-0 call is the yardstick.
    dense = RP.roll_index(sr, xr.shape[2]).expand(xr.shape).contiguous()
    dense_ms = loop_ms(lambda: torch.gather(xr, 2, dense), warmup=2, reps=25)
    say("timing", f"lane_roll's library call with a materialised int64 index (.contiguous(), "
                  f"not the yardstick): torch.gather {dense_ms:.4f} ms")
    del dense
    index = RP.roll_index(sr, xr.shape[2]).expand(xr.shape)
    plain_ms, ms = in_turns(torch, lambda: RP.lane_roll_plain(xr, sr), lambda: RP.lane_roll(xr, sr),
                            10, 25)
    library_ms, lib_kernel_ms = in_turns(torch, lambda: torch.gather(xr, 2, index),
                                         lambda: RP.lane_roll(xr, sr), 25, 25)
    counts = (8 * xr.numel() + 4 * sr.numel(), 0)
    times["lane_roll"] = (ms, plain_ms, library_ms, counts)
    b_ms = bound(*counts)[0]
    say("timing", f"lane_roll over {xr.shape[0]} x {tuple(xr.shape[1:])} tiles "
                  f"({counts[0] / 1e6:.1f} MB moved): {ms:.4f} ms "
                  f"({counts[0] / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms, {100 * b_ms / ms:.1f} % of it")
    say("timing", f"lane_roll against torch.gather with a stride-0 index, in turns: gather "
                  f"{library_ms:.4f} ms, kernel {lib_kernel_ms:.4f} ms, kernel / gather "
                  f"{lib_kernel_ms / library_ms:.3f} ({library_ms / lib_kernel_ms:.2f}x faster)")

    for drift, inp in gather_inputs.items():
        plain_ms, ms = in_turns(torch, lambda: WW.window_gather_plain(*inp, 3),
                                lambda: WW.window_gather(*inp, 3), 5, 25)
        win, y0, x0, wx = inp[:4]
        taps = int(wx.shape[0])
        texels = gather_texels(int(win.shape[1]), int(win.shape[2]), y0, x0, taps, 3)
        counts = gather_counts(texels, int(win.shape[0]), taps, 3)
        label = "drift" if drift else "row-invariant"
        say("timing", f"window_gather, bicubic C=3, {win.shape[0]} sub-tiles, {label} x0 "
                      f"(taps read {texels} of {win.numel()} window values; "
                      f"{counts[0] / 1e6:.1f} MB moved): {ms:.4f} ms "
                      f"({counts[0] / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, bound "
                      f"{bound(*counts)[0]:.4f} ms")
        if not drift:
            times["window_gather"] = (ms, plain_ms, None, counts)
        else:
            times["window_gather_drift"] = (ms, plain_ms, None, counts)

    total = [0.0, 0.0, 0, 0, 0.0]  # ms, plain ms, bytes, instructions, bound ms
    classes = {}
    for op in GC.OPS:
        rec = records[op]  # the entry point's run, in the probes phase
        plain_ms, ms = in_turns(torch, lambda: GC.op_cost_plain(xb, ib, op, K6_PLAIN_ITERS),
                                lambda: GC.op_cost(xb, ib, op, K6_PLAIN_ITERS), 1, 10, warmup=1)
        counts = op_cost_counts(op, int(xb.shape[0]), K6_PLAIN_ITERS)
        b_ms, b_by = bound(*counts)
        for i, v in enumerate((ms, plain_ms) + counts[:2] + (b_ms,)):
            total[i] += v
        say("timing", f"op_cost {op} on {rec['copies']} tiles ({rec['sms']} SMs): "
                      f"{rec['ns_per_tile_op_per_sm']:.3f} ns per tile-op per SM "
                      f"({GC.SMALL} trips {rec['ms_small']:.4f} ms, {GC.BIG} trips "
                      f"{rec['ms_big']:.4f} ms, the entry point's run); at {K6_PLAIN_ITERS} trips "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}"
                      f"{', shared memory' if counts[2] else ''}), {100 * b_ms / ms:.1f} % of it")
        classes[op] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "share": b_ms / ms}
    say("timing", f"op_cost classes at {K6_PLAIN_ITERS} trips: {json.dumps(classes)}")
    # The classes' bounds add up: each class is its own launch.
    times["op_cost"] = (total[0], total[1], None, (total[2], total[3]), (total[4], "operations"))
    say("timing", f"probe kernels timed; card {smi}")
    return times


def main() -> int:
    import torch

    name, smi = phase_device(torch)
    sys.path.insert(0, str(ROOT))
    from image_lens_reproject_torch import cli
    from image_lens_reproject_torch.io import exr
    from image_lens_reproject_torch.models import lens as L
    from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
    from image_lens_reproject_torch.ops import plan as P
    from image_lens_reproject_torch.ops import remap_fused as RF
    from image_lens_reproject_torch.ops.cuda import build
    from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
    from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2
    from image_lens_reproject_torch import probes
    from image_lens_reproject_torch.probes import dma_probe, gather_cost_probe, roll_probe, ww2_probe
    from image_lens_reproject_torch.utils import native

    probe_mods = (dma_probe, roll_probe, gather_cost_probe, ww2_probe)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    spans = []  # (phase, seconds), printed with the total

    def timed(phase, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        spans.append(f"{phase} {time.perf_counter() - start:.1f}")
        return result

    timed("build", phase_build, (B1.library, B2.library, probes.library), build, native)
    max_abs = timed("parity", phase_parity, torch, B1, L, rotation_matrix_degrees, dev)
    planned, errs = timed("planned", phase_planned, torch, B1, B2, P, RF, dev)
    band_errs, band_plan = timed("band", phase_band, torch, B1, B2, P, RF, dev)
    errs.update(band_errs)
    view_launches, view_errs, view_times = timed("views", phase_views, torch, B1, RF, L,
                                                 rotation_matrix_degrees, dev, smi)
    errs.update(view_errs)
    field_errs, field_times = timed("field", phase_field, torch, B1, dev, smi)
    errs.update(field_errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = timed("main path", phase_main_path, torch, B1, B2, cli, exr, dev, Path(tmp))
        launches.update(timed("mesh", phase_mesh, torch, B1, B2, cli, dev, Path(tmp)))
    launches.update(view_launches)
    probe_launches, probe_errs, probe_inputs = timed("probes", phase_probes, torch, probe_mods,
                                                     dev)
    launches.update(probe_launches)
    errs.update(probe_errs)
    errs["frame"] = max_abs
    times = timed("timing", phase_timing, torch, B1, B2, RF, planned, dev, smi)
    times.update(timed("mesh timing", phase_mesh_timing, torch, B1, B2, RF, dev, smi, band_plan))
    times.update(timed("probe timing", phase_probe_timing, torch, probe_mods, probe_inputs, smi))
    times["frame"] = times["3"]
    times.update(view_times)
    times.update(field_times)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s ({', '.join(spans)} s)")

    def entry(kernel, source, replaces, key):
        ms, plain_ms, library_ms, counts = times[key][:4]
        bound_ms, bound_by = times[key][4] if len(times[key]) > 4 else bound(*counts)
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": errs[key], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    print(smi)
    print(json.dumps({"kernels": [
        entry("remap_frame", B1_SOURCE, K1, "frame"),
        entry("remap_list", B1_SOURCE, K1, "list"),
        entry("remap_band", B1_SOURCE, K1_BAND, "band"),
        entry("remap_windows", B2_SOURCE, K2, "windows"),
        entry("remap_windows_split", B2_SOURCE, K3, "windows_split"),
        entry("remap_windows_band", B2_SOURCE, K2, "windows_band"),
        entry("remap_list_band", B1_SOURCE, K1_BAND, "list_band"),
        entry("remap_views", B1_SOURCE, K1, "views"),
        entry("remap_field", B1_SOURCE, K1, "field"),
        entry("coord_field", B1_SOURCE, K1, "coord_field"),
        entry("window_copy", PROBES_DIR + "dma_probe.cu", K4, "window_copy"),
        entry("window_scan_db", PROBES_DIR + "dma_probe.cu", K5, "window_scan_db"),
        entry("op_cost", PROBES_DIR + "gather_cost_probe.cu", K6, "op_cost"),
        entry("lane_roll", PROBES_DIR + "roll_probe.cu", K7, "lane_roll"),
        entry("window_gather", PROBES_DIR + "ww2_probe.cu", K8, "window_gather"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
