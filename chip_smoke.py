#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU, and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA GPU and nvcc (``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``); without
a GPU it fails. Each phase prints one line; any failure raises, so the
script exits non-zero and never prints its last line.

1. device: the GPU's name and power limit;
2. build: kernel B1 (``image_lens_reproject_torch/csrc/remap_kernel.cu``)
   with nvcc, from the sources, timed;
3. parity: B1 against the plain PyTorch path, both on the GPU, at the
   headline shape (3840x1920 full equirect -> 3840x2160 rectilinear,
   bicubic, rotation (20, 5, 0), exposure x2, Reinhard 4) and on small
   cases (C = 1, 4, 5; n_samples = 2; partial equirect with clamp; no
   rotation; tonemap off): max abs < 1e-3 each, the BASELINE budget;
4. main path: the CLI (``image_lens_reproject_torch.cli.main``) on three
   3840x1920 RGB EXR frames made from a seed; B1's launch count is set to
   0 before and read after; every output must be within one half ulp of
   the plain path's output on the same decoded input, encoded the same way;
5. timing: B1 and the plain path at the headline shape, medians of
   CUDA-event times after warm-up, in turns (plain, B1, B1, plain).

It then prints the card's name and power limit, one JSON line about the
kernels, and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC_H, SRC_W, OUT_H, OUT_W = 1920, 3840, 2160, 3840
ROTATION = (20.0, 5.0, 0.0)
EXPOSURE_EV, REINHARD = 1.0, 4.0
N_FRAMES = 3
PARITY_MAX = 1e-3  # BASELINE parity budget (max abs err)
KERNEL_SOURCE = "image_lens_reproject_torch/csrc/remap_kernel.cu"
REPLACES = "image_lens_reproject_tpu/ops/pallas/remap_kernel.py:2127"


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


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


def phase_build(B1, build):
    t0 = time.perf_counter()
    B1.library()
    seconds, report = build.BUILD_INFO["ilr_remap"]
    check(seconds is not None, "kernel B1 was not built from the sources in this run")
    ptxas = " | ".join(
        line.split(":", 1)[1].strip() for line in report.splitlines()
        if "ptxas info" in line and ("registers" in line or "spill" in line)
    )
    say("build", f"nvcc built B1 in {seconds:.2f} s (load {time.perf_counter() - t0:.2f} s); ptxas: {ptxas}")
    return seconds


def headline_kwargs(L):
    return dict(
        in_lens=L.full_equirectangular(), out_lens=L.Rectilinear(35.0, 36.0, 36.0 * OUT_H / OUT_W),
        out_h=OUT_H, out_w=OUT_W, interp="bicubic", n_samples=1,
        exposure=2.0 ** EXPOSURE_EV, reinhard=REINHARD,
    )


def compare(torch, B1, src, rotation, kw):
    """B1 and its plain version on the same GPU tensor: (max abs, p999, out)."""
    got = B1.remap_tonemap(src, rotation, **kw)
    want = B1.remap_tonemap_plain(src, rotation, **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (src.shape[0], kw["out_h"], kw["out_w"], src.shape[3]),
          f"B1 gave shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "B1 gave non-finite values")
    err = (got - want).abs().cpu().numpy()
    return float(err.max()), float(np.quantile(err, 0.999)), got


def phase_parity(torch, B1, L, rotation_matrix_degrees, dev):
    kw = headline_kwargs(L)
    rot = rotation_matrix_degrees(*ROTATION)
    src = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 2, (1, SRC_H, SRC_W, 3)).astype(np.float32)
    ).to(dev)
    before = B1.LAUNCHES
    max_abs, p999, _ = compare(torch, B1, src, rot, kw)
    check(max_abs < PARITY_MAX, f"headline max abs err {max_abs} >= {PARITY_MAX}")
    worst = max_abs

    small = dict(kw, out_h=64, out_w=160)
    partial = L.Equirectangular(-2.0, 1.5, -1.2, 1.0)
    cases = {
        "C=1": (1, rot, small),
        "C=4": (4, rot, small),
        "C=5": (5, rot, small),
        "n_samples=2": (3, rot, dict(small, n_samples=2)),
        "partial equirect (clamp)": (3, rot, dict(small, in_lens=partial)),
        "no rotation": (3, None, small),
        "tonemap off": (3, rot, dict(small, exposure=1.0, reinhard=1.0)),
    }
    parts = []
    for i, (name, (c, r, ckw)) in enumerate(cases.items()):
        s = torch.from_numpy(
            np.random.default_rng(i + 1).uniform(0, 2, (2, 96, 192, c)).astype(np.float32)
        ).to(dev)
        m, _, _ = compare(torch, B1, s, r, ckw)
        check(m < PARITY_MAX, f"{name}: max abs err {m} >= {PARITY_MAX}")
        worst = max(worst, m)
        parts.append(f"{name} {m:.3g}")
    launched = B1.LAUNCHES - before
    check(launched == 1 + len(cases), f"B1 launched {launched} times for {1 + len(cases)} calls")
    say("parity", f"headline B1 vs plain on the GPU: max abs {max_abs:.3g}, p999 {p999:.3g} "
                  f"(budget {PARITY_MAX}); small cases: {'; '.join(parts)}; launches +{launched}")
    return worst


def _within_one_half_ulp(got, want):
    ulp = np.maximum(
        np.spacing(np.abs(want).astype(np.float16)), np.spacing(np.abs(got).astype(np.float16))
    ).astype(np.float32)
    return got.shape == want.shape and bool((np.abs(got - want) <= ulp).all())


def phase_main_path(torch, B1, L, rotation_matrix_degrees, cli, exr, dev):
    kw = headline_kwargs(L)
    rot = rotation_matrix_degrees(*ROTATION)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        in_dir, out_dir, plain_dir = tmp / "in", tmp / "out", tmp / "plain"
        for d in (in_dir, plain_dir):
            d.mkdir()
        rng = np.random.default_rng(1)
        names = [f"frame_{i:04d}.exr" for i in range(N_FRAMES)]
        for name in names:
            exr.write_exr(str(in_dir / name), rng.uniform(0, 2, (SRC_H, SRC_W, 3)).astype(np.float32))

        B1.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main([
            "-i", str(in_dir), "-o", str(out_dir), "--exr", "--device", "cuda", "-j", "4",
            "--no-configs", f"{SRC_W},{SRC_H}", "--i-equirectangular", "full",
            "--rectilinear", "35,36", "--output-resolution", f"{OUT_W},{OUT_H}",
            "--rotation", ",".join(str(a) for a in ROTATION),
            "--exposure", str(EXPOSURE_EV), "--reinhard", str(REINHARD), "--bc",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = B1.LAUNCHES
        check(rc == 0, f"the CLI returned {rc}")
        check(launches >= 1, "the main path never launched kernel B1")
        check(launches == N_FRAMES, f"B1 launched {launches} times for {N_FRAMES} frames")
        written = sorted(p.name for p in out_dir.glob("*.exr"))
        check(written == names, f"the CLI wrote {written}, expected {names}")

        for name in names:
            src = torch.from_numpy(exr.read_exr(str(in_dir / name)).data[None]).to(dev)
            plain = B1.remap_tonemap_plain(src, rot, **kw)[0].cpu().numpy()
            exr.write_exr(str(plain_dir / name), plain)
            got = exr.read_exr(str(out_dir / name)).data
            want = exr.read_exr(str(plain_dir / name)).data
            check(np.isfinite(got).all(), f"{name}: non-finite output")
            check(_within_one_half_ulp(got, want), f"{name}: CLI output differs from the plain path "
                                                   "by more than one half ulp")
    say("main path", f"CLI on {N_FRAMES} frames {SRC_W}x{SRC_H} EXR -> {OUT_W}x{OUT_H}: rc 0, "
                     f"{len(names)} outputs, B1 launches {launches}, outputs within one half ulp "
                     f"of the plain path; wall {wall:.2f} s with EXR decode/encode")
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


def phase_timing(torch, B1, L, rotation_matrix_degrees, dev, smi):
    kw = headline_kwargs(L)
    rot = torch.from_numpy(rotation_matrix_degrees(*ROTATION)).to(dev)
    src = torch.from_numpy(
        np.random.default_rng(2).uniform(0, 2, (1, SRC_H, SRC_W, 3)).astype(np.float32)
    ).to(dev)
    kernel = lambda: B1.remap_tonemap(src, rot, **kw)  # noqa: E731
    plain = lambda: B1.remap_tonemap_plain(src, rot, **kw)  # noqa: E731
    t_plain, t_kernel = [], []
    for block in (t_plain, t_kernel, t_kernel, t_plain):
        fn, reps = (kernel, 50) if block is t_kernel else (plain, 10)
        block += event_ms(torch, fn, warmup=3, reps=reps)
    ms, plain_ms = statistics.median(t_kernel), statistics.median(t_plain)
    mpix = OUT_H * OUT_W / 1e3
    say("timing", f"headline, one frame, CUDA-event medians: B1 {ms:.4f} ms ({mpix / ms:.1f} Mpix/s, "
                  f"n={len(t_kernel)}), plain path {plain_ms:.4f} ms ({mpix / plain_ms:.1f} Mpix/s, "
                  f"n={len(t_plain)}); card {smi}")
    return ms, plain_ms


def main() -> int:
    import torch

    name, smi = phase_device(torch)
    sys.path.insert(0, str(ROOT))
    from image_lens_reproject_torch import cli
    from image_lens_reproject_torch.io import exr
    from image_lens_reproject_torch.models import lens as L
    from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
    from image_lens_reproject_torch.ops.cuda import build
    from image_lens_reproject_torch.ops.cuda import remap_kernel as B1

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build(B1, build)
    max_abs = phase_parity(torch, B1, L, rotation_matrix_degrees, dev)
    launches = phase_main_path(torch, B1, L, rotation_matrix_degrees, cli, exr, dev)
    ms, plain_ms = phase_timing(torch, B1, L, rotation_matrix_degrees, dev, smi)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "remap_equirect_rect_bicubic", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
