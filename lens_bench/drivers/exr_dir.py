"""Traffic kind ``exr_dir``: the CLI over a directory of EXR frames.

What CLI users run: ``cli.main`` over a directory of ``frames`` HALF EXR
frames (written in set-up from the seed, ZIP at zlib level ``zip_level``,
the codec and compression a Blender render uses), writing EXR, with
``-j threads`` and the configuration's lenses, sampler, rotation and
tonemap as CLI flags. The window starts calls back to back while it is
open; each runs to its end and writes into a directory of its own.

``dir_mpix_s``: output pixels of every frame written by the calls started
in the window over the seconds those calls took. The program's tracing
zones are reset before the window; a traced run profiles the first call,
host events included: against seconds of host work a frame, their cost
is nothing to the gaps they label.
Once the window has closed, a seeded sample of ``sample`` written frames
is read back with the benchmark's own EXR reader and compared, as HALF,
with the reference applied to the HALF frames the benchmark wrote;
frames that a call did not write are counted as missing.

Mix parameters: ``frames``, ``threads``, ``zip_level``, ``sample``,
``extra_args`` (more CLI flags).
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import exr, frames, program, trace
from ..compare import Checks, limits_of
from ..harness import DriverResult, RunContext, peak_bytes, setup_seconds, warmed_up
from ..reference import remap as ref

IN_FLAGS = {"rectilinear": "--i-rectilinear", "fisheye_equidistant": "--i-equidistant",
            "fisheye_equisolid": "--i-equisolid", "fisheye_stereographic": "--i-stereographic",
            "equirectangular": "--i-equirectangular"}
SAMPLERS = {"nearest": "--nn", "bilinear": "--bl", "bicubic": "--bc"}


def lens_flag(spec: dict, output: bool):
    """The CLI flag of a lens, as ``--flag=values`` (a value may be
    negative); the CLI derives the sensor height from the resolution."""
    t = spec["type"]
    flag = IN_FLAGS[t].replace("--i-", "--") if output else IN_FLAGS[t]
    if t == "fisheye_equidistant":
        vals = [spec["fov"]]
    elif t == "rectilinear":
        vals = [spec["focal_length"], spec["sensor_width"]]
    elif t == "equirectangular":
        vals = [spec[k] for k in ("longitude_min", "longitude_max", "latitude_min",
                                  "latitude_max")]
    else:
        vals = [spec["focal_length"], spec["sensor_width"], spec["fov"]]
    return f"{flag}=" + ",".join(repr(float(v)) for v in vals)


def cli_args(cfg: dict, mix: dict, in_dir: Path, device: str):
    """The CLI's arguments for the configuration over ``in_dir``, less ``-o``."""
    args = ["-i", str(in_dir), "--exr", "--device", device, "-j", str(int(mix["threads"])),
            "--no-configs", f"{cfg['src_w']},{cfg['src_h']}",
            lens_flag(cfg["in_lens"], False), lens_flag(cfg["out_lens"], True),
            "--output-resolution", f"{cfg['out_w']},{cfg['out_h']}",
            SAMPLERS[cfg["interp"]], "-s", str(cfg.get("n_samples", 1)),
            "--exposure=" + repr(float(cfg.get("exposure_ev", 0.0))),
            "--reinhard=" + repr(float(cfg.get("reinhard", 1.0)))]
    if cfg.get("rotation_deg"):
        args.append("--rotation=" + ",".join(repr(float(a)) for a in cfg["rotation_deg"]))
    return args + list(mix.get("extra_args", []))


def call(cli, args) -> float:
    """Runs ``cli(args)`` with its printing kept; raises on a non-zero
    return. Returns its seconds."""
    printed = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli(args)
    dt = time.perf_counter() - t
    text = printed.getvalue()
    if rc != 0 or "Error" in text:
        print(text[-4000:], file=sys.stderr)
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    return dt


def run(cell, ctx: RunContext) -> DriverResult:
    cfg, mix = cell.config, cell.traffic
    work = Path(tempfile.mkdtemp(prefix="lens_bench_exr_"))
    try:
        return _run(cfg, mix, ctx, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cfg, mix, ctx: RunContext, work: Path) -> DriverResult:
    n = int(mix["frames"])
    halves = frames.make(n, cfg["src_h"], cfg["src_w"], cfg["channels"], ctx.seed,
                         ctx.device).half().cpu().numpy()
    in_dir, warm_dir = work / "in", work / "warm"
    in_dir.mkdir()
    warm_dir.mkdir()
    names = [f"frame_{i:04d}.exr" for i in range(n)]
    for name, img in zip(names, halves):
        exr.write(str(in_dir / name), img, level=int(mix["zip_level"]))
    os.link(in_dir / names[0], warm_dir / names[0])

    cli = program.cli_main()
    tracing = program.tracing()
    call(cli, cli_args(cfg, mix, warm_dir, ctx.device) + ["-o", str(work / "warm_out")])
    shutil.rmtree(work / "warm_out")
    warmed_up(ctx)

    args = cli_args(cfg, mix, in_dir, ctx.device)
    tracing.reset_zones()
    durations, out_dirs, traced = [], [], None
    setup_s = setup_seconds(ctx)
    t0 = time.perf_counter()
    while not durations or time.perf_counter() - t0 < ctx.seconds:
        out = work / f"out_{len(durations)}"
        out_dirs.append(out)
        if ctx.trace and not durations:
            with trace.Traced(ctx.cuda) as traced:
                durations.append(call(cli, args + ["-o", str(out)]))
        else:
            durations.append(call(cli, args + ["-o", str(out)]))
    peak = peak_bytes(ctx)
    zones = tracing.zone_totals()

    written = [[d / nm for nm in names if (d / nm).exists()] for d in out_dirs]
    disk = sum(p.stat().st_size for p in in_dir.iterdir()) + sum(
        p.stat().st_size for w in written for p in w)
    print(f"exr_dir: {len(durations)} calls of {n} frames; {disk} bytes of EXR written",
          file=sys.stderr)
    n_written = sum(len(w) for w in written)
    missing = n * len(out_dirs) - n_written
    checks = Checks(limits_of(cfg))
    checks.number("missing_frames", missing, 0)
    rng = np.random.default_rng(int(ctx.seed) % 2**63)
    pool = [(k, i) for k in range(len(out_dirs)) for i in range(n)]
    failed = missing
    for j in rng.choice(len(pool), size=min(int(mix["sample"]), len(pool)), replace=False):
        k, i = pool[int(j)]
        path = out_dirs[k] / names[i]
        if not path.exists():
            continue
        got = torch.from_numpy(exr.read(str(path))).to(ctx.device)
        src = torch.from_numpy(halves[i][None].astype(np.float32)).to(ctx.device)
        want = ref.remap(src, cfg)[0].half().float()
        failed += 0 if checks.frame(got, want) else 1
        del got, src, want
    out_px = cfg["out_h"] * cfg["out_w"]
    return DriverResult(
        attempted=n * len(out_dirs), failed=failed,
        e2e={"dir_mpix_s": n_written * out_px / math.fsum(durations) / 1e6,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, frames=n_written,
        summary=None if traced is None else traced.summary,
        traced_frames=len(written[0]), zones=zones)
