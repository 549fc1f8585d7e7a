"""Hardware probes of the card, ported from the JAX package's TPU probes.

Four entry points, each the counterpart of a probe under ``bench/``, each
with its kernels in one library (``ilr_probes``, built from the four
``csrc/*_probe.cu`` sources at first use):

- ``python -m image_lens_reproject_torch.probes.dma_probe``: windows
  fetched at dynamic offsets, single and double-buffered (``window_copy``,
  ``window_scan_db``);
- ``python -m image_lens_reproject_torch.probes.roll_probe``: a roll of
  each tile by its own shift (``lane_roll``);
- ``python -m image_lens_reproject_torch.probes.gather_cost_probe``: the
  cost per tile-op of five op classes (``op_cost``);
- ``python -m image_lens_reproject_torch.probes.ww2_probe``: a windowed tap
  gather (``window_gather``).

Each runs on the card and raises without one; ``--device cpu`` runs its
checks through the plain versions and measures no time. Each wrapper takes
the plain version for a CPU tensor, launches its kernel for a CUDA tensor,
and raises on anything else.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
from typing import Callable, List, Optional, Sequence

import torch

from ..ops.cuda import build

SOURCES = ("dma_probe.cu", "roll_probe.cu", "gather_cost_probe.cu", "ww2_probe.cu")
NOT_MEASURED = "timing: not measured on cpu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: (src, h, w, offs, n_tiles, [n_steps,] out, device, stream)
    "ilr_window_copy": [_P, _I, _I, _P, _I, _P, _I, _P],
    "ilr_window_scan_db": [_P, _I, _I, _P, _I, _I, _P, _I, _P],
    # x, shifts, n, h, w, out, device, stream
    "ilr_lane_roll": [_P, _P, _I, _I, _I, _P, _I, _P],
    # x, idx, n, op, iters, out, device, stream
    "ilr_op_cost": [_P, _P, _I, _I, _I, _P, _I, _P],
    # win, y0, x0, wx, wy, n_sub, rows, cols, taps, channels, out, device, stream
    "ilr_window_gather": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P],
}


@functools.cache
def library() -> ctypes.CDLL:
    """The probe kernels' shared library, built from ``csrc/`` by nvcc at the first call."""
    lib = build.load("ilr_probes", SOURCES)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return build.bind_common(lib)


def launch(name: str, first: torch.Tensor, *args) -> None:
    """Calls ``name`` of the library with ``args``, then ``first``'s device
    and current stream, and raises if the launch was refused."""
    lib = library()
    stream = torch.cuda.current_stream(first.device).cuda_stream
    rc = getattr(lib, name)(*args, first.device.index, stream)
    build.raise_on_error(lib, rc, name)


def expect(name: str, t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
           device: Optional[torch.device] = None) -> None:
    """Raises unless ``t`` is a contiguous ``ndim``-dimensional ``dtype``
    tensor on ``device`` (when given) on the CPU or a CUDA card."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous {ndim}-d tensor, "
                         f"got shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: {what} on {t.device}, expected {device}")


def parse_args(argv: Optional[Sequence[str]], description: str) -> torch.device:
    """The entry points' one option, ``--device``: the card unless ``cpu``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default): the kernels, timed; cpu: the plain versions, "
                             "untimed")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the probe runs on a CUDA card and none is available "
                               "(--device cpu runs its checks through the plain versions)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def event_times(fn: Callable[[], object], warmup: int, reps: int) -> List[float]:
    """CUDA-event times of ``reps`` calls of ``fn`` in ms, after ``warmup`` calls."""
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


def event_ms(fn: Callable[[], object], warmup: int, reps: int) -> float:
    """Median CUDA-event time of ``fn`` in ms, after ``warmup`` calls."""
    return statistics.median(event_times(fn, warmup, reps))
