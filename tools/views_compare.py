#!/usr/bin/env python3
"""Kernel B1's view mode against one launch a view, on a CUDA card.

``python3 tools/views_compare.py [--frames N] [--alt DIR] [--out DIR]``

On the cubemap8k configuration (``lens_bench/configs/cubemap8k.json``: an
8K equirect frame to six 1920 x 1920 cube faces, bilinear), over a pool of
8 frames on the card, with the faces as one numpy (6, 3, 3) stack:

- host clock, back to back, ``--frames`` frames a run, in turns (view,
  six, six, view): ``remap_tonemap_batch`` once a frame with the stack
  against six calls a frame with one rotation each; ms a frame, closed by
  ``torch.cuda.synchronize()``;
- the card's time (``probes.loop_ms``: the calls queued behind a wait on
  the card, so the host's work is hidden) of the same two, in turns;
- with ``--alt DIR`` (a copy of ``csrc/`` whose ``remap_frame.cu`` orders
  its blocks otherwise, same C entry points), that build's view launch on
  the card, in turns against the package's.

Every output is checked bit for bit against the six single-rotation calls.
Prints one line a measurement and writes ``views_compare.json`` under
``--out`` (default ``tools/out/views_compare/``, listed in ``.gitignore``).
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "tools" / "out" / "views_compare"
CONFIG = ROOT / "lens_bench" / "configs" / "cubemap8k.json"
POOL = 8


def say(text: str) -> None:
    print(f"[views_compare] {text}", flush=True)


def host_ms(torch, fn, frames: int) -> float:
    """ms a frame of ``frames`` calls of ``fn(i)`` back to back, host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(frames):
        fn(i)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / frames


def in_turns(a, b):
    """Medians of (a(), b()) timed as a, b, b, a."""
    ta, tb = [], []
    for block, fn in ((ta, a), (tb, b), (tb, b), (ta, a)):
        block.append(fn())
    return statistics.median(ta), statistics.median(tb)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=2000, help="frames a host-clock run")
    ap.add_argument("--alt", type=Path, help="a csrc/ copy with another remap_frame.cu")
    ap.add_argument("--out", type=Path, default=OUT_DIR, help="directory for views_compare.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("views_compare needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from image_lens_reproject_torch import probes
    from image_lens_reproject_torch.models import lens as L
    from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
    from image_lens_reproject_torch.ops import remap_fused
    from image_lens_reproject_torch.ops.cuda import build
    from image_lens_reproject_torch.ops.cuda import remap_kernel as B1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    record = {"card": f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
                      f"{torch.__version__}, CUDA {torch.version.cuda}"}
    say(record["card"])
    cfg = json.loads(CONFIG.read_text())
    out_lens = L.Rectilinear(**{k: v for k, v in cfg["out_lens"].items() if k != "type"})
    kw = dict(in_lens=L.full_equirectangular(), out_lens=out_lens, out_h=cfg["out_h"],
              out_w=cfg["out_w"], interp=cfg["interp"], n_samples=1, exposure=1.0, reinhard=1.0)
    views = np.stack([rotation_matrix_degrees(*v) for v in cfg["views_deg"]])
    gen = torch.Generator(device="cuda").manual_seed(17)
    pool = [torch.rand((1, cfg["src_h"], cfg["src_w"], cfg["channels"]), generator=gen,
                       device="cuda") for _ in range(POOL)]
    remap = remap_fused.remap_tonemap_batch

    def view_call(i):
        return remap(pool[i % POOL], views, **kw)

    def six_calls(i):
        return [remap(pool[i % POOL], views[v], **kw) for v in range(len(views))]

    for i in range(POOL):
        got, singles = view_call(i), six_calls(i)
        for v, one in enumerate(singles):
            if not torch.equal(got[:, v], one):
                raise RuntimeError(f"frame {i} view {v}: the view launch differs")
    say("the view launch == six single-rotation launches, bit for bit, on every frame")

    view_ms, six_ms = in_turns(lambda: host_ms(torch, view_call, args.frames),
                               lambda: host_ms(torch, six_calls, args.frames))
    record["host_ms_a_frame"] = {"view": view_ms, "six": six_ms, "speedup": six_ms / view_ms}
    say(f"host clock, back to back: one view call {view_ms:.4f} ms a frame, six calls "
        f"{six_ms:.4f} ms a frame: {six_ms / view_ms:.2f}x")

    calls = iter(range(10**9))
    card_view, card_six = in_turns(
        lambda: probes.loop_ms(lambda: view_call(next(calls)), warmup=2, reps=40),
        lambda: probes.loop_ms(lambda: six_calls(next(calls)), warmup=2, reps=20))
    record["card_ms_a_frame"] = {"view": card_view, "six": card_six,
                                 "speedup": card_six / card_view}
    say(f"the card's time: one view launch {card_view:.4f} ms a frame, six launches "
        f"{card_six:.4f} ms a frame: {card_six / card_view:.3f}x")

    if args.alt is not None:
        alt = build.bind(build.load("alt_ilr_remap", B1.SOURCES, args.alt.resolve()),
                         B1.SIGNATURES)
        frame = pool[0]
        p, rot, stream = B1.launch_setup("views_compare", frame, views, views=len(views), **kw)
        outs = {}

        def raw(lib, name):
            out = torch.empty((1, len(views), cfg["out_h"], cfg["out_w"], cfg["channels"]),
                              device="cuda")
            outs[name] = out
            args = (frame.data_ptr(), out.data_ptr(), None if rot is None else rot.data_ptr(),
                    len(views), ctypes.byref(p), frame.device.index, stream)
            return lambda: build.raise_on_error(lib, lib.ilr_remap_views(*args), "view mode")

        pkg_fn, alt_fn = raw(B1.library(), "package"), raw(alt, "alt")
        pkg_ms, alt_ms = in_turns(lambda: probes.loop_ms(pkg_fn, warmup=2, reps=40),
                                  lambda: probes.loop_ms(alt_fn, warmup=2, reps=40))
        torch.cuda.synchronize()
        same = torch.equal(outs["package"], outs["alt"])
        record["alt"] = {"dir": str(args.alt), "package_ms": pkg_ms, "alt_ms": alt_ms,
                         "bit_equal": same}
        say(f"block order: package {pkg_ms:.4f} ms, {args.alt.name} {alt_ms:.4f} ms a frame "
            f"({alt_ms / pkg_ms:.3f}x); equal bit for bit: {same}")
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "views_compare.json").write_text(json.dumps(record, indent=1))
    say(f"wrote {args.out / 'views_compare.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
