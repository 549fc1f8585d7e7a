"""Batch orchestrator: file discovery, host decode, device dispatch, encode.

PyTorch port of the JAX package's ``pipeline.py``, single-device path
(reference: the CTPL thread-pool fan-out of src/main.cpp:536-660). The
remap runs on ``opts.device``, so the pipeline has three stages:

    decode threads  ->  process_batch on the device  ->  encode threads

Host decode/encode run on a ThreadPoolExecutor (the ``-j`` knob).

Parity-preserving behaviors (reference src/main.cpp:536-660):
* skip-if-exists checks ALL requested output formats before decoding;
* directory scan: regular files, sorted paths, prefix/suffix filter, only
  .exr/.png submitted (JPEG input only via --single);
* --no-reproject with scale == 1 bypasses the remap (plain copy);
* per-image try/except prints the error and continues the batch;
* progress counter printed as "%4d / %4d: stem".
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .io import exr as exr_io
from .io import jpeg as jpeg_io
from .io import png as png_io
from .io.image import ImageBuffer
from .models.lens import LensSpec
from .ops import color, remap_fused
from .utils.tracing import trace_zone


@dataclasses.dataclass
class PipelineOptions:
    input_lens: LensSpec
    output_lens: LensSpec
    out_width: int
    out_height: int
    interp: str = "bicubic"
    n_samples: int = 1
    rotation: Optional[np.ndarray] = None  # (3,3) float32 or None
    exposure: float = 1.0  # linear multiplier (2^EV)
    reinhard: float = 1.0
    store_png: bool = False
    store_exr: bool = False
    skip_if_exists: bool = False
    do_reproject: bool = True
    scale: float = 1.0
    num_threads: int = 1
    batch_size: int = 1  # images per device dispatch (framework extension)
    json_log: bool = False  # machine-readable progress lines (extension)
    device: str = "cuda"  # torch device the remap runs on
    # "overlap" runs decode / device dispatch / encode as overlapping
    # stages across host threads; "serial" runs each frame
    # decode->dispatch->encode to completion before the next starts.
    ordering: str = "overlap"


def discover_files(
    input_dir: str, filter_prefix: str = "", filter_suffix: str = ""
) -> List[Path]:
    """Sorted, filtered directory listing (src/main.cpp:624-651)."""
    paths = sorted(p for p in Path(input_dir).iterdir() if p.is_file())
    out = []
    for p in paths:
        fn = p.name
        if len(fn) < len(filter_prefix) or len(fn) < len(filter_suffix):
            continue
        if filter_prefix and not fn.startswith(filter_prefix):
            continue
        if filter_suffix and not fn.endswith(filter_suffix):
            continue
        if p.suffix in (".exr", ".png"):
            out.append(p)
    return out


def read_image(path: Path) -> ImageBuffer:
    """Decode by extension (src/main.cpp:566-575)."""
    suffix = path.suffix.lower()
    if suffix == ".exr":
        return exr_io.read_exr(str(path))
    if suffix == ".png":
        return png_io.read_png(str(path))
    if suffix in (".jpeg", ".jpg"):
        return jpeg_io.read_jpeg(str(path))
    raise ValueError(f"Input format not supported: {path.suffix}")


class PipelineStats:
    """Progress/failure accounting + console contract (src/main.cpp:615-619).

    ``json_log=True`` switches progress lines to one JSON object per line.
    """

    def __init__(self, json_log: bool = False):
        self.done = 0
        self.failed: List[str] = []
        self.pixels = 0
        self.wall_seconds = 0.0
        self.ordering = "overlap"  # set by run_pipeline from the options
        self.json_log = json_log
        self._lock = threading.Lock()

    def mark_done(self, count: int, stem: str, pixels: int = 0) -> int:
        with self._lock:
            self.done += 1
            self.pixels += pixels
            dc = self.done
        if self.json_log:
            print(json.dumps({"event": "done", "n": dc, "total": count, "file": stem}))
        else:
            print(f"{dc:4d} / {count:4d}: {stem}")
        return dc

    def mark_failed(self, name: str, err: Exception):
        with self._lock:
            self.failed.append(name)
        if self.json_log:
            print(json.dumps({"event": "error", "file": name, "message": str(err)}))
        else:
            print(f"Error: {err}")


def _output_paths(output_dir: Path, p: Path):
    base = output_dir / p.name
    return base.with_suffix(".png"), base.with_suffix(".exr")


def _outputs_exist(opts: PipelineOptions, out_png: Path, out_exr: Path) -> bool:
    """All requested formats already on disk? (src/main.cpp:551-563)."""
    exists = True
    if opts.store_png and not out_png.exists():
        exists = False
    if opts.store_exr and not out_exr.exists():
        exists = False
    return exists


def process_batch(
    images: Sequence[np.ndarray], opts: PipelineOptions
) -> List[np.ndarray]:
    """Remap + tonemap a uniform-shape batch on ``opts.device``; returns host arrays."""
    with trace_zone("device_dispatch"):
        device = torch.device(opts.device)
        batch = torch.from_numpy(np.stack(images)).to(device)
        if not opts.do_reproject and opts.scale == 1.0:
            out = batch  # --no-reproject fast path (src/main.cpp:592-596)
            if color.needed(opts.exposure, opts.reinhard):
                out = color.post_process(out, opts.exposure, opts.reinhard)
        else:
            out = remap_fused.remap_tonemap_batch(
                batch,
                opts.rotation,
                in_lens=opts.input_lens,
                out_lens=opts.output_lens,
                out_h=opts.out_height,
                out_w=opts.out_width,
                interp=opts.interp,
                n_samples=opts.n_samples,
                exposure=opts.exposure,
                reinhard=opts.reinhard,
            )
        host = out.cpu().numpy()
    return [host[i] for i in range(host.shape[0])]


def write_outputs(img: np.ndarray, layout, opts: PipelineOptions, out_png: Path, out_exr: Path):
    with trace_zone("encode"):
        if opts.store_png:
            png_io.write_png(str(out_png), img)
        if opts.store_exr:
            exr_io.write_exr(str(out_exr), img)


def run_pipeline(
    paths: Sequence[Path],
    output_dir: str,
    opts: PipelineOptions,
) -> PipelineStats:
    """Process a list of input images end to end.

    Decode and encode run on ``opts.num_threads`` host threads; device
    dispatches are batched ``opts.batch_size`` at a time. Failures are
    isolated per image (src/main.cpp:617-619) and reported at the end.
    """
    output_dir_path = Path(output_dir)
    output_dir_path.mkdir(parents=True, exist_ok=True)

    stats = PipelineStats(json_log=opts.json_log)
    count = len(paths)
    t0 = time.perf_counter()

    # Stage 1: skip-check + decode (host threads).
    todo = []
    for p in paths:
        out_png, out_exr = _output_paths(output_dir_path, p)
        if opts.skip_if_exists and _outputs_exist(opts, out_png, out_exr):
            print(f"Skipping '{out_png}'. Already exists.")
            stats.done += 1
            continue
        todo.append((p, out_png, out_exr))

    if opts.ordering not in ("overlap", "serial"):
        raise ValueError(
            f"ordering must be 'overlap' or 'serial', got {opts.ordering!r}")
    serial = opts.ordering == "serial"
    stats.ordering = opts.ordering
    pool = ThreadPoolExecutor(
        max_workers=1 if serial else max(1, opts.num_threads))

    def decode_one(item):
        p, out_png, out_exr = item
        try:
            with trace_zone("decode"):
                buf = read_image(p)
            return (p, out_png, out_exr, buf, None)
        except Exception as e:  # per-image isolation
            return (p, out_png, out_exr, None, e)

    # "overlap": pool.map prefetches decodes across threads while the
    # device works and encodes are submitted asynchronously below.
    # "serial": decode lazily on the consumer thread, one frame fully
    # finishing (including its encode) before the next decode starts.
    decoded_iter = (
        map(decode_one, todo) if serial else pool.map(decode_one, todo))

    # Stage 2+3: batch device dispatch, then encode on host threads.
    pending_writes = []
    batch_items: List[tuple] = []

    def flush_batch():
        if not batch_items:
            return
        items = list(batch_items)
        batch_items.clear()
        try:
            results = process_batch([b.data for (_, _, _, b, _) in items], opts)
        except Exception as e:  # per-batch isolation: report and go on
            for (p, _, _, _, _) in items:
                stats.mark_failed(p.name, e)
            return
        for (p, out_png, out_exr, buf, _), img in zip(items, results):
            def write_and_count(img=img, buf=buf, p=p, out_png=out_png, out_exr=out_exr):
                try:
                    write_outputs(img, buf.layout, opts, out_png, out_exr)
                    stats.mark_done(count, p.stem, pixels=img.shape[0] * img.shape[1])
                except Exception as e:
                    stats.mark_failed(p.name, e)
            if serial:
                write_and_count()
            else:
                pending_writes.append(pool.submit(write_and_count))

    try:
        current_shape = None
        for p, out_png, out_exr, buf, err in decoded_iter:
            if err is not None:
                stats.mark_failed(p.name, err)
                continue
            # Keep batches shape-uniform: a batch is one stacked tensor.
            if current_shape is not None and buf.data.shape != current_shape:
                flush_batch()
            current_shape = buf.data.shape
            batch_items.append((p, out_png, out_exr, buf, None))
            if len(batch_items) >= opts.batch_size:
                flush_batch()
        flush_batch()

        for fut in pending_writes:
            fut.result()
    finally:
        pool.shutdown(wait=True)

    stats.wall_seconds = time.perf_counter() - t0
    if stats.failed:
        print(f"Failed {len(stats.failed)} file(s): {', '.join(stats.failed)}", file=sys.stderr)
    if stats.pixels and stats.wall_seconds > 0:
        mpixps = stats.pixels / stats.wall_seconds / 1e6
        print(f"Throughput: {mpixps:.1f} Mpix/s ({stats.done} images, {stats.wall_seconds:.2f}s)")
    return stats
