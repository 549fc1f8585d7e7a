#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU, and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA GPU and nvcc (``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``); without
a GPU it fails. Each phase prints lines tagged with its name; any failure
raises, so the script exits non-zero and never prints its last line.

1. device: the GPU's name and power limit;
2. build: kernels B1 (``image_lens_reproject_torch/csrc/remap_kernel.cu``)
   and B2 (``csrc/rescue_kernel.cu``), one nvcc each, started together,
   from the sources, timed;
3. parity: B1 against the plain PyTorch path, both on the GPU, at the
   headline shape (BASELINE config 3: 3840x1920 full equirect -> 3840x2160
   rectilinear, bicubic, rotation (20, 5, 0), exposure x2, Reinhard 4), at
   the published widths of BASELINE configs 1, 2 and 4, on small cases
   (C = 1, 4, 5; n_samples = 2; partial equirect with clamp; no rotation;
   tonemap off) and on every lens pair x sampler at a small size: NaN
   positions equal and max abs < 1e-3 on the rest, the BASELINE budget;
4. planned path: at the headline and at config 2, the plan's three
   sub-tile lists (ops/plan.py), each list's kernel against its plain
   version (B2, B2 split, B1 list mode), and the whole planned path against
   B1's full frame, bit for bit, with no read outside a staged window;
5. main path: the CLI (``image_lens_reproject_torch.cli.main``)
   a. on three 3840x1920 RGB EXR frames made from a seed, default options
      (B1): every output within one half ulp of the plain path's output;
   b. on the same frames with ``--rescue on --split on`` (B2, B2 split, B1
      list mode), and on one config-2 frame with and without those
      switches: files byte-identical to the default run's;
   c. on one config-4 RGBZ frame (B1): depth remapped and never
      tonemapped, colour tonemapped, each within one half ulp of the plain
      path;
   the launch counts are set to 0 before each run and read after it;
6. timing: CUDA-event medians after warm-up, in turns (plain, kernel,
   kernel, plain): B1 against the plain path at configs 1-4; the planned
   path against B1 full frame at the headline and config 2; each list
   kernel against its plain version on config 2's lists.

It then prints the card's name and power limit, one JSON line about the
kernels, and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

ROOT = Path(__file__).resolve().parent
SRC_H, SRC_W, OUT_H, OUT_W = 1920, 3840, 2160, 3840
ROTATION = (20.0, 5.0, 0.0)
EXPOSURE_EV, REINHARD = 1.0, 4.0
N_FRAMES = 3
PARITY_MAX = 1e-3  # BASELINE parity budget (max abs err)
FOV_180 = "3.14159265358979"  # the CLI takes fisheye fields of view in radians
B1_SOURCE = "image_lens_reproject_torch/csrc/remap_kernel.cu"
B2_SOURCE = "image_lens_reproject_torch/csrc/rescue_kernel.cu"
K1 = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:2127"
K2 = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:2191"
K3 = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:2296"


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def configs(L, rotation_matrix_degrees):
    """BASELINE configs 1-4 at their published widths (bench/baseline_configs.py:141-158):
    name -> (source shape (H, W, C), remap keyword arguments, rotation)."""
    equisolid = L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)
    return {
        "1": ((1080, 1080, 3), dict(
            in_lens=L.FisheyeEquidistant(math.pi, 36.0, 36.0),
            out_lens=L.Rectilinear(35.0, 36.0, 36.0 * 1080 / 1920),
            out_h=1080, out_w=1920, interp="bilinear"), None),
        "2": ((2048, 2048, 3), dict(
            in_lens=equisolid, out_lens=L.full_equirectangular(),
            out_h=2048, out_w=4096, interp="bilinear"), rotation_matrix_degrees(30.0, 10.0, 5.0)),
        "3": ((SRC_H, SRC_W, 3), dict(
            in_lens=L.full_equirectangular(), out_lens=L.Rectilinear(35.0, 36.0, 36.0 * OUT_H / OUT_W),
            out_h=OUT_H, out_w=OUT_W, interp="bicubic",
            exposure=2.0 ** EXPOSURE_EV, reinhard=REINHARD), rotation_matrix_degrees(*ROTATION)),
        "4": ((2048, 2048, 4), dict(
            in_lens=L.Rectilinear(50.0, 36.0, 36.0), out_lens=equisolid,
            out_h=2048, out_w=2048, interp="bilinear"), None),
    }


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


def phase_build(B1, B2, build):
    t0 = time.perf_counter()
    errors = []

    def load(lib):
        try:
            lib()
        except Exception as e:  # reported below, after both builds end
            errors.append(e)

    threads = [threading.Thread(target=load, args=(k.library,)) for k in (B1, B2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    for name in ("ilr_remap", "ilr_rescue"):
        seconds, report = build.BUILD_INFO[name]
        check(seconds is not None, f"{name} was not built from the sources in this run")
        lines = report.splitlines()
        regs = [int(line.split("Used ")[1].split()[0]) for line in lines
                if "ptxas info" in line and "Used " in line and "registers" in line]
        spills = [int(line.split("spill stores")[0].split(",")[-1].split()[0]) for line in lines
                  if "spill stores" in line]
        say("build", f"nvcc built {name} in {seconds:.2f} s: {len(regs)} kernel instances, "
                     f"{min(regs)}-{max(regs)} registers, {sum(v > 0 for v in spills)} with "
                     f"spill stores (at most {max(spills)} bytes)")
    say("build", f"both built in {wall:.2f} s wall")


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
    cfg = configs(L, rotation_matrix_degrees)
    before = B1.LAUNCHES
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
        check(m < PARITY_MAX, f"{name}: max abs err {m} >= {PARITY_MAX}")
        worst = max(worst, m)
        return m, p, n_nan

    # The headline, its small cases, and configs 1, 2 and 4 at full width.
    (h, w, c), kw, rot = cfg["3"]
    src = to_dev(torch, np.random.default_rng(0).uniform(0, 2, (1, h, w, c)).astype(np.float32), dev)
    m, p, _ = run("headline", src, rot, kw, finite=True)
    say("parity", f"headline B1 vs plain on the GPU: max abs {m:.3g}, p999 {p:.3g} (budget {PARITY_MAX})")
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
    for name in ("1", "2", "4"):
        (h, w, c), kw, rot = cfg[name]
        s = to_dev(torch, np.random.default_rng(10 + int(name)).uniform(0, 2, (1, h, w, c))
                   .astype(np.float32), dev)
        m, p, n_nan = run(f"config {name}", s, rot, kw)
        say("parity", f"config {name} ({type(kw['in_lens']).__name__} {h}x{w}x{c} -> "
                      f"{type(kw['out_lens']).__name__} {kw['out_w']}x{kw['out_h']}, {kw['interp']}): "
                      f"max abs {m:.3g}, p999 {p:.3g}, NaN {n_nan} at equal positions")

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
    launched = B1.LAUNCHES - before
    check(launched == calls, f"B1 launched {launched} times for {calls} calls")
    say("parity", f"B1 launches +{launched}, worst max abs {worst:.3g}")
    return worst


def phase_planned(torch, B1, B2, P, RF, L, rotation_matrix_degrees, dev):
    """Plans at the headline and config 2; each list kernel and the whole
    planned path against their references. Returns the plans, sources and
    each kernel's worst max abs error."""
    cfg = configs(L, rotation_matrix_degrees)
    errs = {"list": 0.0, "windows": 0.0, "windows_split": 0.0}
    out = {}
    counts = (B1.LIST_LAUNCHES, B2.LAUNCHES, B2.SPLIT_LAUNCHES)
    for name in ("3", "2"):
        (h, w, c), kw, rot = cfg[name]
        src = to_dev(torch, np.random.default_rng(20 + int(name)).uniform(0, 2, (1, h, w, c))
                     .astype(np.float32), dev)
        t0 = time.perf_counter()
        plan = P.make_plan(rot, in_h=h, in_w=w, channels=c, split=True, device=dev,
                           **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        frame = B1.remap_tonemap(src, rot, **kw)
        for key, entries, split, floats in (("windows", plan.rescue, False, plan.rescue_floats),
                                            ("windows_split", plan.split, True, plan.split_floats)):
            if not len(entries):
                continue
            got = torch.full_like(frame, math.nan)
            want = got.clone()
            misses = B2.new_misses(dev)
            B2.remap_windows(src, rot, got, entries, split=split, misses=misses,
                             window_floats=floats, **kw)
            B2.remap_windows_plain(src, rot, want, entries, split=split, misses=B2.new_misses(dev), **kw)
            torch.cuda.synchronize()
            check(int(misses.item()) == 0, f"config {name}: B2 {key} read outside its windows")
            errs[key] = max(errs[key], compare(torch, got, want)[0])
        if len(plan.direct):
            got = torch.full_like(frame, math.nan)
            want = got.clone()
            B1.remap_tonemap_list(src, rot, got, plan.direct, **kw)
            B1.remap_tonemap_list_plain(src, rot, want, plan.direct, **kw)
            errs["list"] = max(errs["list"], compare(torch, got, want)[0])
        misses = B2.new_misses(dev)
        planned = RF.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw)
        torch.cuda.synchronize()
        check(int(misses.item()) == 0, f"config {name}: the planned path read outside its windows")
        check(torch.equal(torch.isnan(planned), torch.isnan(frame)), f"config {name}: NaN positions")
        check(torch.equal(planned.nan_to_num(7.0), frame.nan_to_num(7.0)),
              f"config {name}: the planned path differs from B1's full frame")
        sizes = plan.sizes()
        say("planned", f"config {name}: plan in {plan_s:.3f} s: {sizes['rescue']} rescue, "
                       f"{sizes['split']} split, {sizes['direct']} direct of "
                       f"{plan.grid[0] * plan.grid[1]} sub-tiles; largest window "
                       f"{4 * plan.rescue_floats} B (split pair {4 * plan.split_floats} B) of "
                       f"{P.WINDOW_BUDGET_BYTES}; planned path == B1 full frame bit for bit, "
                       f"0 reads outside windows")
        out[name] = (src, plan)
    launched = (B1.LIST_LAUNCHES - counts[0], B2.LAUNCHES - counts[1], B2.SPLIT_LAUNCHES - counts[2])
    check(launched[1] >= 1 and launched[2] >= 1,
          f"B2 launched {launched[1]} times and B2 split {launched[2]} times")
    for key, e in errs.items():
        check(e < PARITY_MAX, f"{key}: max abs err {e} >= {PARITY_MAX}")
    say("planned", f"kernels against their plain versions: B1 list {errs['list']:.3g}, "
                   f"B2 {errs['windows']:.3g}, B2 split {errs['windows_split']:.3g}; "
                   f"launches +{launched[0]} list, +{launched[1]} B2, +{launched[2]} B2 split")
    return out, errs


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    check(rc == 0, f"the CLI returned {rc} for {' '.join(args)}")
    return time.perf_counter() - t0


def _reset(B1, B2):
    B1.LAUNCHES = B1.LIST_LAUNCHES = B2.LAUNCHES = B2.SPLIT_LAUNCHES = 0


def phase_main_path(torch, B1, B2, L, rotation_matrix_degrees, cli, exr, dev):
    cfg = configs(L, rotation_matrix_degrees)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)

        # a. the headline frames, default options: kernel B1.
        in_dir = tmp / "in"
        in_dir.mkdir()
        names = [f"frame_{i:04d}.exr" for i in range(N_FRAMES)]
        for i, name in enumerate(names):
            exr.write_exr(str(in_dir / name), smooth(SRC_H, SRC_W, 3, seed=i))
        headline = [
            "-i", str(in_dir), "--exr", "--device", "cuda", "-j", "4",
            "--no-configs", f"{SRC_W},{SRC_H}", "--i-equirectangular", "full",
            "--rectilinear", "35,36", "--output-resolution", f"{OUT_W},{OUT_H}",
            "--rotation", ",".join(str(a) for a in ROTATION),
            "--exposure", str(EXPOSURE_EV), "--reinhard", str(REINHARD), "--bc",
        ]
        _reset(B1, B2)
        wall = _cli(cli, torch, headline + ["-o", str(tmp / "out")])
        launches["frame"] = B1.LAUNCHES
        check(B1.LAUNCHES == N_FRAMES, f"B1 launched {B1.LAUNCHES} times for {N_FRAMES} frames")
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
                         f"rc 0, B1 launches {B1.LAUNCHES}, outputs within one half ulp of the plain "
                         f"path; wall {wall:.2f} s with EXR decode/encode")

        # b. --rescue on --split on: kernel B2, B2 split and B1 list mode.
        _reset(B1, B2)
        wall_r = _cli(cli, torch, headline + ["-o", str(tmp / "rescued"), "--rescue", "on",
                                              "--split", "on"])
        head = (B1.LIST_LAUNCHES, B2.LAUNCHES, B2.SPLIT_LAUNCHES)
        check(B1.LAUNCHES == 0 and B2.LAUNCHES == N_FRAMES,
              f"--rescue on: B1 frame {B1.LAUNCHES}, B2 {B2.LAUNCHES} launches")
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
        _reset(B1, B2)
        _cli(cli, torch, cfg2 + ["-o", str(tmp / "c2_rescued"), "--rescue", "on", "--split", "on"])
        c2 = (B1.LIST_LAUNCHES, B2.LAUNCHES, B2.SPLIT_LAUNCHES)
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
        _reset(B1, B2)
        _cli(cli, torch, [
            "-i", str(c4_dir), "-o", str(tmp / "c4"), "--exr", "--device", "cuda",
            "--no-configs", "2048,2048", "--i-rectilinear", "50,36",
            "--equisolid", f"15,36,{FOV_180}", "--output-resolution", "2048,2048", "--bl",
            "--exposure", "1", "--reinhard", "4",
        ])
        check(B1.LAUNCHES == 1, f"config 4: B1 launched {B1.LAUNCHES} times for 1 frame")
        launches["frame"] += B1.LAUNCHES
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


def event_ms(torch, fn, warmup, reps):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def in_turns(torch, base, new, base_reps, new_reps):
    """Medians of (base, new) CUDA-event times taken as base, new, new, base."""
    t_base, t_new = [], []
    for block in (t_base, t_new, t_new, t_base):
        fn, reps = (new, new_reps) if block is t_new else (base, base_reps)
        block += event_ms(torch, fn, warmup=2, reps=reps)
    return statistics.median(t_base), statistics.median(t_new)


def phase_timing(torch, B1, B2, RF, L, rotation_matrix_degrees, planned, dev, smi):
    cfg = configs(L, rotation_matrix_degrees)
    times = {}
    for name in ("1", "2", "3", "4"):
        (h, w, c), kw, rot = cfg[name]
        src = to_dev(torch, np.random.default_rng(30 + int(name)).uniform(0, 2, (1, h, w, c))
                     .astype(np.float32), dev)
        rot = None if rot is None else to_dev(torch, rot, dev)
        plain_ms, ms = in_turns(torch, lambda: B1.remap_tonemap_plain(src, rot, **kw),
                                lambda: B1.remap_tonemap(src, rot, **kw), 5, 25)
        times[name] = (ms, plain_ms)
        mpix = kw["out_h"] * kw["out_w"] / 1e3
        say("timing", f"config {name}, one frame: B1 {ms:.4f} ms ({mpix / ms:.1f} Mpix/s), plain path "
                      f"{plain_ms:.4f} ms ({mpix / plain_ms:.1f} Mpix/s)")
    for name in ("3", "2"):
        src, plan = planned[name]
        _, kw, rot = cfg[name]
        misses = B2.new_misses(dev)
        frame_ms, planned_ms = in_turns(
            torch, lambda: B1.remap_tonemap(src, rot, **kw),
            lambda: RF.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw), 25, 25)
        times[f"planned{name}"] = (planned_ms, frame_ms)
        check(int(misses.item()) == 0, f"config {name}: reads outside windows while timing")
        say("timing", f"config {name}: planned path (B2 + B2 split + B1 list) {planned_ms:.4f} ms, "
                      f"B1 full frame {frame_ms:.4f} ms ({planned_ms / frame_ms:.2f}x)")
    # Each list kernel alone on config 2's lists, against its plain version.
    src, plan = planned["2"]
    _, kw, rot = cfg["2"]
    out = torch.empty((1, kw["out_h"], kw["out_w"], 3), device=dev)
    misses = B2.new_misses(dev)
    for key, entries, split, floats in (("windows", plan.rescue, False, plan.rescue_floats),
                                        ("windows_split", plan.split, True, plan.split_floats)):
        times[key] = in_turns(
            torch,
            lambda: B2.remap_windows_plain(src, rot, out, entries, split=split, misses=misses, **kw),
            lambda: B2.remap_windows(src, rot, out, entries, split=split, misses=misses,
                                     window_floats=floats, **kw), 3, 25)[::-1]
    times["list"] = in_turns(
        torch, lambda: B1.remap_tonemap_list_plain(src, rot, out, plan.direct, **kw),
        lambda: B1.remap_tonemap_list(src, rot, out, plan.direct, **kw), 3, 25)[::-1]
    sizes = plan.sizes()
    say("timing", f"config 2 lists alone: B2 {times['windows'][0]:.4f} ms over {sizes['rescue']} "
                  f"sub-tiles (plain {times['windows'][1]:.4f}); B2 split "
                  f"{times['windows_split'][0]:.4f} ms over {sizes['split']} (plain "
                  f"{times['windows_split'][1]:.4f}); B1 list {times['list'][0]:.4f} ms over "
                  f"{sizes['direct']} (plain {times['list'][1]:.4f}); card {smi}")
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

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    phase_build(B1, B2, build)
    max_abs = phase_parity(torch, B1, L, rotation_matrix_degrees, dev)
    planned, errs = phase_planned(torch, B1, B2, P, RF, L, rotation_matrix_degrees, dev)
    launches = phase_main_path(torch, B1, B2, L, rotation_matrix_degrees, cli, exr, dev)
    times = phase_timing(torch, B1, B2, RF, L, rotation_matrix_degrees, planned, dev, smi)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")

    def entry(kernel, source, replaces, key, err, ms_plain):
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": err, "ms": ms_plain[0],
                "plain_ms": ms_plain[1]}

    print(smi)
    print(json.dumps({"kernels": [
        entry("remap_frame", B1_SOURCE, K1, "frame", max_abs, times["3"]),
        entry("remap_list", B1_SOURCE, K1, "list", errs["list"], times["list"]),
        entry("remap_windows", B2_SOURCE, K2, "windows", errs["windows"], times["windows"]),
        entry("remap_windows_split", B2_SOURCE, K3, "windows_split", errs["windows_split"],
              times["windows_split"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
