"""Batch orchestrator: file discovery, host decode, device dispatch, encode.

PyTorch port of the JAX package's ``pipeline.py`` (reference: the CTPL
thread-pool fan-out of src/main.cpp:536-660). The remap runs on
``opts.device``, or over a (batch, rows) mesh of devices with
``opts.mesh`` (``parallel/``), so the pipeline has three stages:

    decode threads  ->  process_batch on the device(s)  ->  encode threads

Host decode/encode run on a ThreadPoolExecutor (the ``-j`` knob). Under
torchrun (``parallel.distributed.init``), every rank runs the pipeline on
the same files and the mesh spans the ranks; rank 0 alone writes the
outputs.

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
from collections import OrderedDict
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
from .ops import color, dispatch, remap_fused
from .ops import plan as plan_mod
from .ops.cuda import rescue_kernel
from .parallel import batch as pbatch
from .parallel import distributed
from .parallel import mesh as pmesh
from .utils import tracing
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
    # Multi-device data parallelism (framework extension): "b,r" mesh shape
    # (batch x rows axes) or "auto" to use every visible device on the
    # batch axis when more than one is present; None disables.
    mesh: Optional[str] = None
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


def _device_count(opts: PipelineOptions) -> int:
    """The devices a mesh may span: the ranks of a process group, else the
    distinct visible devices of ``opts.device``'s kind."""
    if distributed.world_size() > 1:
        return distributed.world_size()
    return len(set(pmesh.visible_devices(torch.device(opts.device).type)))


def _resolve_mesh(opts: PipelineOptions):
    """Parse opts.mesh -> (batch_axis, rows_axis) or None.

    "auto" uses every visible device on the batch axis when >1 is present.
    Invalid shapes (not B,R, an axis below 1, more devices than present)
    fall back to single-device dispatch with a warning — never an error.
    """
    if not opts.mesh:
        return None
    n_dev = _device_count(opts)
    if opts.mesh == "auto":
        return (n_dev, 1) if n_dev > 1 else None
    try:
        b_ax, r_ax = (int(x) for x in opts.mesh.split(","))
    except ValueError:
        print(f"Warning: bad --mesh '{opts.mesh}', expected B,R or auto")
        return None
    if b_ax * r_ax > n_dev or b_ax < 1 or r_ax < 1:
        print(f"Warning: --mesh {b_ax}x{r_ax} needs {b_ax * r_ax} devices, "
              f"have {n_dev}; using single-device dispatch")
        return None
    # Neither out_h nor in_h needs to divide the rows axis:
    # sharded_remap_step pads + crops the output bands, and process_batch
    # row-pads the source for sharding transport (sliced off post-gather).
    return b_ax, r_ax


_MESHES: "dict[tuple, pmesh.Mesh]" = {}


def _mesh_for(shape, opts: PipelineOptions) -> pmesh.Mesh:
    """The (batch, rows) mesh of this shape: over the ranks of a process
    group (made once: each row group is a ``dist.new_group`` that every rank
    creates together), else over the first b x r visible devices."""
    b_ax, r_ax = shape
    if distributed.world_size() <= 1:
        devices = pmesh.visible_devices(torch.device(opts.device).type)
        return pmesh.make_mesh(devices=devices[:b_ax * r_ax], batch=b_ax, rows=r_ax)
    key = (shape, torch.distributed.group.WORLD)
    if key not in _MESHES:
        _MESHES[key] = distributed.global_mesh(b_ax, r_ax)
    return _MESHES[key]


def _remap_on_mesh(host: torch.Tensor, opts: PipelineOptions, shape, kw, frame=None):
    """The batch through ``sharded_remap_step`` on a (batch, rows) mesh:
    padded to a multiple of b by repeating its last image and to a
    multiple of r source rows by repeating its last row (transport only:
    the step cuts the rows back to the true height after its gather), then
    shard, step and assemble on the host, and the padding images dropped.

    With ``--rescue on`` each position takes the planned path inside its
    band, from cached band plans (``_band_plans_for``), with a misses
    counter on its own device. Returns ``(output, misses)``: the reads
    outside a window summed over every position (of every rank, under a
    process group, so that all ranks raise or none), 0 without rescue.
    The copies and the step are ``dispatch.*`` spans, as in
    ``process_batch``."""
    b_ax, r_ax = shape
    mesh = _mesh_for(shape, opts)
    n_real, in_h = int(host.shape[0]), int(host.shape[1])
    plans = misses = None
    if dispatch.rescue_enabled():
        plans = _band_plans_for(mesh, host, opts)
        misses = {pos: rescue_kernel.new_misses(mesh.devices[pos[0]][pos[1]])
                  for pos in mesh.local_positions()}
    with trace_zone("dispatch.h2d", frame) as span:
        pad = (-n_real) % b_ax
        if pad:
            host = torch.cat([host, host[-1:].expand(pad, *host.shape[1:])])
        pad_h = (-in_h) % r_ax
        if pad_h:
            host = torch.cat([host, host[:, -1:].expand(-1, pad_h, -1, -1)], dim=1)
        span.nbytes = host.nbytes
        sharded = pbatch.shard_batch(host, mesh)
    with trace_zone("dispatch.remap", frame):
        out = pbatch.sharded_remap_step(sharded, opts.rotation, mesh=mesh, in_h=in_h,
                                        plans=plans, misses=misses, **kw)
    with trace_zone("dispatch.d2h", frame) as span:
        result = out.assemble()[:n_real]
        span.nbytes = result.nbytes
        if misses is None:
            return result, 0
        total = sum(int(m.item()) for m in misses.values())
    if mesh.ranks is not None:
        (i, j), = mesh.local_positions()
        summed = torch.tensor([total], dtype=torch.int64, device=mesh.devices[i][j])
        torch.distributed.all_reduce(summed)
        total = int(summed.item())
    return result, total


_PLAN_CACHE_MAX = 16
_PLAN_CACHE: "OrderedDict[tuple, object]" = OrderedDict()


def _cached(key, make):
    """``_PLAN_CACHE[key]``, made by ``make()`` the first time; the least
    recently used entries go past ``_PLAN_CACHE_MAX``."""
    value = _PLAN_CACHE.get(key)
    if value is None:
        value = make()
    _PLAN_CACHE[key] = value
    _PLAN_CACHE.move_to_end(key)
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return value


def _config_key(shape, opts: PipelineOptions) -> tuple:
    """What a plan depends on, as the JAX pipeline keys its plans: input
    shape, lenses, output size, sampler, supersampling, rotation."""
    return (tuple(int(d) for d in shape), opts.input_lens, opts.output_lens, opts.out_height,
            opts.out_width, opts.interp, opts.n_samples,
            None if opts.rotation is None else np.asarray(opts.rotation).tobytes())


def _plan_for(batch: torch.Tensor, opts: PipelineOptions, use_split: bool) -> plan_mod.Plan:
    """The sub-tile plan of this configuration, made once and cached:
    keyed by the configuration, the split switch and the device."""

    def make():
        plan = plan_mod.make_plan(
            opts.rotation, in_lens=opts.input_lens, out_lens=opts.output_lens,
            in_h=int(batch.shape[1]), in_w=int(batch.shape[2]), channels=int(batch.shape[3]),
            out_h=opts.out_height, out_w=opts.out_width, interp=opts.interp,
            n_samples=opts.n_samples, split=use_split, device=batch.device,
        )
        if opts.json_log:
            print(json.dumps({"event": "plan", **plan.sizes()}))
        return plan

    return _cached(("frame", _config_key(batch.shape[1:], opts), use_split, str(batch.device)),
                   make)


def _band_plans_for(mesh: pmesh.Mesh, host: torch.Tensor, opts: PipelineOptions):
    """The band plans of this mesh and configuration (``pbatch.band_plans``),
    made once and cached: keyed as the JAX pipeline keys its mesh plans
    (mesh shape and the configuration), plus the mesh's devices."""

    def make():
        plans = pbatch.band_plans(
            mesh, in_lens=opts.input_lens, out_lens=opts.output_lens,
            in_h=int(host.shape[1]), in_w=int(host.shape[2]), channels=int(host.shape[3]),
            out_h=opts.out_height, out_w=opts.out_width, interp=opts.interp,
            n_samples=opts.n_samples, rotation=opts.rotation)
        if opts.json_log:
            for (i, j), plan in sorted(plans.items()):
                print(json.dumps({"event": "plan", "position": [i, j], "band": list(plan.band),
                                  **plan.sizes()}))
        return plans

    shape = (mesh.shape[pmesh.BATCH_AXIS], mesh.shape[pmesh.ROWS_AXIS])
    devices = tuple(str(d) for row in mesh.devices for d in row)
    return _cached(("mesh", shape, _config_key(host.shape[1:], opts), devices), make)


def process_batch(
    images: Sequence[np.ndarray], opts: PipelineOptions, frame: Optional[int] = None
) -> List[np.ndarray]:
    """Remap + tonemap a uniform-shape batch on ``opts.device``; returns host arrays.

    With ``opts.mesh`` the batch is cut over a (batch, rows) mesh of
    devices (``parallel/batch.py``): each position runs B1's band mode, or
    with ``--rescue on`` the planned path inside its band (kernel B2 and
    B1's list mode from the band's plan; no split list, as in JAX). Else,
    with ``--rescue on`` the remap takes the planned path over the frame
    (B2, B2's split mode with ``--split on``, B1's list mode). Each gives
    the same output; a read outside a staged window raises after the
    batch is back on the host.

    Spans, tagged with ``frame`` (the index in the run of the batch's
    first frame), inside the ``device_dispatch`` zone: ``dispatch.stack``
    (``np.stack``), ``dispatch.h2d`` (the copy to the device),
    ``dispatch.remap`` (the call that queues the remap) and
    ``dispatch.d2h`` (the copy back, which waits for the remap), each
    copy with its bytes. None adds a synchronisation.
    """
    misses, counter = 0, None
    with trace_zone("device_dispatch", frame):
        device = torch.device(opts.device)
        with trace_zone("dispatch.stack", frame) as span:
            host = torch.from_numpy(np.stack(images))
            span.nbytes = host.nbytes
        kw = dict(
            in_lens=opts.input_lens,
            out_lens=opts.output_lens,
            out_h=opts.out_height,
            out_w=opts.out_width,
            interp=opts.interp,
            n_samples=opts.n_samples,
            exposure=opts.exposure,
            reinhard=opts.reinhard,
        )
        if (opts.do_reproject or opts.scale != 1.0) and (
                mesh_shape := _resolve_mesh(opts)) is not None:
            # Before the rescue branch, as in the JAX pipeline.
            out, misses = _remap_on_mesh(host, opts, mesh_shape, kw, frame)
            result = out.numpy()
        else:
            with trace_zone("dispatch.h2d", frame, host.nbytes):
                batch = host.to(device)
            with trace_zone("dispatch.remap", frame):
                if not opts.do_reproject and opts.scale == 1.0:
                    out = batch  # --no-reproject fast path (src/main.cpp:592-596)
                    if color.needed(opts.exposure, opts.reinhard):
                        out = color.post_process(out, opts.exposure, opts.reinhard)
                elif dispatch.rescue_enabled():
                    # As in the JAX pipeline, split only with rescue on.
                    plan = _plan_for(batch, opts, use_split=dispatch.split_enabled())
                    counter = rescue_kernel.new_misses(device)
                    out = remap_fused.remap_tonemap_planned_batch(
                        batch, opts.rotation, plan, misses=counter, **kw)
                else:
                    out = remap_fused.remap_tonemap_batch(batch, opts.rotation, **kw)
            with trace_zone("dispatch.d2h", frame, out.nbytes):
                result = out.cpu().numpy()
                if counter is not None:
                    misses = int(counter.item())
    if misses:
        raise RuntimeError(f"the planned path read {misses} taps outside their "
                           "staged source windows")
    return [result[i] for i in range(result.shape[0])]


def write_outputs(img: np.ndarray, layout, opts: PipelineOptions, out_png: Path, out_exr: Path,
                  frame: Optional[int] = None):
    with trace_zone("encode", frame):
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

    Spans tagged with the frame's index in the run: ``decode`` and
    ``encode`` on the pool threads; ``dispatch.wait_decode`` on the
    dispatching thread, around taking the next decoded frame;
    ``encode.queued``, from the frame's submission to the moment an encode
    thread starts it (explicit times); and, untagged, ``pipeline.drain``
    around the wait for the last encodes.
    """
    output_dir_path = Path(output_dir)
    output_dir_path.mkdir(parents=True, exist_ok=True)

    stats = PipelineStats(json_log=opts.json_log)
    writer = distributed.process_index() == 0
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

    def decode_one(frame):
        p, out_png, out_exr = todo[frame]
        try:
            with trace_zone("decode", frame):
                buf = read_image(p)
            return (p, out_png, out_exr, buf, None)
        except Exception as e:  # per-image isolation
            return (p, out_png, out_exr, None, e)

    # "overlap": pool.map prefetches decodes across threads while the
    # device works and encodes are submitted asynchronously below.
    # "serial": decode lazily on the consumer thread, one frame fully
    # finishing (including its encode) before the next decode starts.
    frames = range(len(todo))
    decoded_iter = map(decode_one, frames) if serial else pool.map(decode_one, frames)

    # Stage 2+3: batch device dispatch, then encode on host threads.
    pending_writes = []
    batch_items: List[tuple] = []

    def flush_batch():
        if not batch_items:
            return
        items = list(batch_items)
        batch_items.clear()
        try:
            results = process_batch([b.data for (_, _, _, _, b) in items], opts,
                                    frame=items[0][0])
        except Exception as e:  # per-batch isolation: report and go on
            for (_, p, _, _, _) in items:
                stats.mark_failed(p.name, e)
            return
        for (frame, p, out_png, out_exr, buf), img in zip(items, results):
            def write_and_count(img=img, buf=buf, p=p, out_png=out_png, out_exr=out_exr,
                                frame=frame, queued=tracing.now_ns()):
                tracing.record("encode.queued", queued, tracing.now_ns(), frame)
                try:
                    if writer:
                        write_outputs(img, buf.layout, opts, out_png, out_exr, frame)
                    stats.mark_done(count, p.stem, pixels=img.shape[0] * img.shape[1])
                except Exception as e:
                    stats.mark_failed(p.name, e)
            if serial:
                write_and_count()
            else:
                pending_writes.append(pool.submit(write_and_count))

    try:
        current_shape = None
        for frame in frames:
            with trace_zone("dispatch.wait_decode", frame):
                p, out_png, out_exr, buf, err = next(decoded_iter)
            if err is not None:
                stats.mark_failed(p.name, err)
                continue
            # Keep batches shape-uniform: a batch is one stacked tensor.
            if current_shape is not None and buf.data.shape != current_shape:
                flush_batch()
            current_shape = buf.data.shape
            batch_items.append((frame, p, out_png, out_exr, buf))
            if len(batch_items) >= opts.batch_size:
                flush_batch()
        flush_batch()

        with trace_zone("pipeline.drain"):
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
