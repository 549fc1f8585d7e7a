"""Tracing / profiling zones — the analog of the reference's Tracy hooks.

Reference: Tracy ``ZoneScoped`` macros around decode / remap / tonemap /
encode (src/reproject.cpp:277,407,422; src/image_formats.cpp:145,209,306;
src/main.cpp:145,545). Here zones are:

* ``torch.profiler.record_function`` ranges, which show in a trace taken
  with ``start_trace`` (Perfetto / chrome://tracing) for the thread that
  started the trace: the pipeline's device dispatch, not its decode and
  encode pool threads, and
* wall-clock accumulators always, printed as a per-phase summary by
  ``zone_report()``.

Enable a full trace with the CLI ``--trace-dir`` flag.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_profiler: Optional[torch.profiler.profile] = None
_trace_dir: Optional[str] = None


@contextlib.contextmanager
def trace_zone(name: str) -> Iterator[None]:
    """Time a named phase; a range in the profiler trace when one is active."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def start_trace(trace_dir: str) -> None:
    """Start a torch.profiler trace of the host and, when present, the GPU."""
    global _profiler, _trace_dir
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=activities)
    _profiler.__enter__()
    _trace_dir = trace_dir


def stop_trace() -> Optional[Path]:
    """Stop the trace and write it as ``trace.json`` in the trace directory."""
    global _profiler, _trace_dir
    if _profiler is None:
        return None
    _profiler.__exit__(None, None, None)
    out = Path(_trace_dir) / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    _profiler.export_chrome_trace(str(out))
    _profiler = None
    _trace_dir = None
    return out


def zone_totals() -> Dict[str, Tuple[float, int]]:
    with _lock:
        return {k: (_totals[k], _counts[k]) for k in _totals}


def zone_report() -> str:
    """Per-phase wall-time summary, the console analog of Tracy zones."""
    rows = zone_totals()
    if not rows:
        return ""
    lines = ["--- phase timings ---"]
    for name, (total, n) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{name:>20s}: {total*1e3:9.1f} ms total / {n:5d} calls")
    return "\n".join(lines)
