"""Tracing spans and profiles — the analog of the reference's Tracy hooks.

Reference: Tracy ``ZoneScoped`` macros around decode / remap / tonemap /
encode (src/reproject.cpp:277,407,422; src/image_formats.cpp:145,209,306;
src/main.cpp:145,545). Here one primitive, the span (``trace_zone``):

* adds its wall time, and a byte count where it moves data, to one table
  of zone totals, read by ``zone_totals`` and printed by ``zone_report``
  (the CLI's phase report), and appends itself to a span log
  (``span_log``) with its thread, its frame tag and its bytes;
* opens a profiler range (torch's ``_RecordFunctionFast``, a cheap
  ``record_function``) only while a torch profiler is running, so that with none it costs two clock reads and a
  table update. Ranges are recorded on the threads whose host events the
  profiler records; elsewhere they cost the range's entry and nothing more.

Hot paths (kernel B1's launch wrapper) check ``profiling()`` once a call
and record their spans only while a profiler runs, else enter ``OFF``;
the steps inside such a span are ``QuietSpan``s, which open no range.
``record`` adds a span with explicit times, for waits that start on one
thread and end on another (a frame queued for an encode thread).

**Clock.** Span times are ``time.perf_counter_ns()`` (``now_ns``). A torch
profiler trace puts an event at ``ts`` microseconds after its
``baseTimeNanoseconds``, on ``time.time_ns()``'s clock, so a span starting
at ``t`` sits at ``trace_ts(t, base)`` = ``(t + offset - base) / 1000`` in
that trace, on every thread, where ``offset`` is ``time_ns() -
perf_counter_ns()`` from an anchor pair of the two clocks (``anchor``,
taken at import, at ``reset_zones`` and at ``start_trace``).

``start_trace`` / ``stop_trace`` (the CLI's ``--trace-dir``) profile the
host, every thread where the installed torch can (``profile_all_threads``),
and the GPU when present. ``stop_trace`` then writes the span log into the
trace: each span's frame tag, bytes and detail into its range's ``args``;
a span whose range the profiler did not record (a pool thread's, where the
profiler records one thread) as a complete event on its own thread's
``tid``; and each explicit-time span as an async event.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

now_ns = time.perf_counter_ns
LOG_MAX = 1 << 16  # the span log keeps the newest spans

_lock = threading.Lock()
# Each thread adds to a table of its own, name -> [total ns, count, bytes],
# so that a span takes no lock; the readers sum the tables.
_local = threading.local()
_tables: List[Tuple[threading.Thread, Dict[str, List[int]]]] = []
_log: "collections.deque[tuple]" = collections.deque(maxlen=LOG_MAX)
_offset_ns = 0  # time_ns() - perf_counter_ns(), from ``anchor``
_profiler: Optional[torch.profiler.profile] = None
_trace_dir: Optional[str] = None
_trace_start_ns = 0


class SpanRecord(NamedTuple):
    name: str
    tid: int  # the thread's native id, as a profiler trace's ``tid``
    t0: int  # now_ns() at the start
    t1: int  # now_ns() at the end
    frame: Optional[int]
    nbytes: int
    detail: Optional[str]
    explicit: bool  # from ``record``: may start on another thread


def anchor() -> None:
    """Takes a new (perf_counter_ns, time_ns) anchor pair for ``trace_ts``."""
    global _offset_ns
    a = now_ns()
    u = time.time_ns()
    b = now_ns()
    _offset_ns = u - (a + b) // 2


def trace_ts(t: int, base_ns: int) -> float:
    """A ``now_ns()`` stamp as a profiler trace's ``ts`` (microseconds),
    for a trace whose ``baseTimeNanoseconds`` is ``base_ns``."""
    return (t + _offset_ns - base_ns) / 1000.0


def _open_range(name: str):
    """A profiler range, entered: recorded on the threads whose host
    events the running profiler records, a no-op elsewhere."""
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


def _thread_table() -> tuple:
    """(native thread id, this thread's table), made at its first span."""
    mine = (threading.get_native_id(), {})
    with _lock:
        _tables.append((threading.current_thread(), mine[1]))
    _local.mine = mine
    return mine


def _add(name, t0, t1, frame, nbytes, detail, explicit=False) -> None:
    try:
        tid, table = _local.mine
    except AttributeError:
        tid, table = _thread_table()
    z = table.get(name)
    if z is None:
        z = table[name] = [0, 0, 0]
    z[0] += t1 - t0
    z[1] += 1
    z[2] += nbytes
    _log.append((name, tid, t0, t1, frame, nbytes, detail, explicit))


class Span:
    """Times a named phase (``with trace_zone(name, frame=3):``).

    ``frame``: the frame's index in the run; ``nbytes``: the bytes it
    moves (the report prints GB/s); ``detail``: a short note for the trace
    (``build.load``'s library and whether nvcc ran). Each may be set on the
    span inside the ``with``."""

    __slots__ = ("name", "frame", "nbytes", "detail", "_t0", "_range")

    def __init__(self, name: str, frame: Optional[int] = None, nbytes: int = 0,
                 detail: Optional[str] = None):
        self.name = name
        self.frame = frame
        self.nbytes = nbytes
        self.detail = detail

    def __enter__(self) -> "Span":
        self._range = _open_range(self.name) if _autograd_profiler._is_profiler_enabled else None
        self._t0 = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = now_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _add(self.name, self._t0, t1, self.frame, self.nbytes, self.detail)
        return False


trace_zone = Span


class QuietSpan(Span):
    """A span that never opens a profiler range: for the steps inside a hot
    path's span, where a range costs more than the step. Under a profiler
    recording the card alone, the four ranges of kernel B1's spans cost
    ~15 µs a call, their table updates ~2 µs."""

    __slots__ = ()

    def __enter__(self) -> "QuietSpan":
        self._range = None
        self._t0 = now_ns()
        return self


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


OFF = _Off()  # the span of a hot path while no profiler runs


def profiling() -> bool:
    """Whether a torch profiler runs: hot paths (kernel B1's wrapper) check
    it once a call and record their spans only then, else use ``OFF``."""
    return _autograd_profiler._is_profiler_enabled


def record(name: str, t0: int, t1: int, frame: Optional[int] = None, nbytes: int = 0) -> None:
    """Adds a span of explicit ``now_ns()`` times, on the calling thread's
    row of the log: a wait started on another thread."""
    _add(name, t0, t1, frame, nbytes, None, explicit=True)


def _summed() -> Dict[str, List[int]]:
    """name -> [total ns, count, bytes] over every thread's table."""
    out: Dict[str, List[int]] = {}
    with _lock:
        tables = list(_tables)
    for _, table in tables:
        for name, z in list(table.items()):
            acc = out.setdefault(name, [0, 0, 0])
            for i in range(3):
                acc[i] += z[i]
    return {k: v for k, v in out.items() if v[1]}


def zone_totals() -> Dict[str, Tuple[float, int]]:
    """{name: (seconds, count)} of every span since the last reset."""
    return {k: (v[0] * 1e-9, v[1]) for k, v in _summed().items()}


def span_log() -> List[SpanRecord]:
    """The newest ``LOG_MAX`` spans since the last reset, in the order they ended."""
    return [SpanRecord(*r) for r in list(_log)]


def reset_zones() -> None:
    """Empty the zone totals and the span log, so that the next report
    covers what follows only."""
    with _lock:
        for _, table in _tables:
            table.clear()
        _tables[:] = [(t, table) for t, table in _tables if t.is_alive()]
        _log.clear()
    anchor()


def zone_report() -> str:
    """Per-phase wall-time summary, the console analog of Tracy zones:
    total, calls and, for a span that moves data, its bytes and rate."""
    rows = _summed()
    if not rows:
        return ""
    lines = ["--- phase timings ---"]
    for name, (ns, n, nbytes) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        line = f"{name:>22s}: {ns * 1e-6:9.1f} ms total / {n:5d} calls"
        if nbytes:
            rate = f"{nbytes / ns:.2f} GB/s" if ns else "-"
            line += f", {nbytes / 1e6:.1f} MB at {rate}"
        lines.append(line)
    return "\n".join(lines)


def _all_threads_config():
    """The profiler option that records every thread's host events, or
    None where this torch lacks it."""
    config = getattr(torch._C._profiler, "_ExperimentalConfig", None)
    try:
        return config(profile_all_threads=True) if config is not None else None
    except TypeError:
        return None


def start_trace(trace_dir: str) -> None:
    """Start a torch.profiler trace of the host's threads and, when
    present, the GPU."""
    global _profiler, _trace_dir, _trace_start_ns
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    kw = {}
    config = _all_threads_config()
    if config is not None:
        kw["experimental_config"] = config
    anchor()
    _profiler = torch.profiler.profile(activities=activities, **kw)
    _trace_start_ns = now_ns()
    _profiler.__enter__()
    _trace_dir = trace_dir


def stop_trace() -> Optional[Path]:
    """Stop the trace, write it as ``trace.json`` in the trace directory
    with the span log merged in, and return its path."""
    global _profiler, _trace_dir
    if _profiler is None:
        return None
    _profiler.__exit__(None, None, None)
    stop = now_ns()
    out = Path(_trace_dir) / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    _profiler.export_chrome_trace(str(out))
    _profiler = None
    _trace_dir = None
    data = json.loads(out.read_text())
    spans = [s for s in span_log() if s.t1 >= _trace_start_ns and s.t0 <= stop]
    merge_spans(data, spans)
    out.write_text(json.dumps(data))
    return out


def _args(s: SpanRecord) -> dict:
    args = {"frame": s.frame, "bytes": s.nbytes or None, "detail": s.detail}
    return {k: v for k, v in args.items() if v is not None}


def merge_spans(data: dict, spans: List[SpanRecord], slack_us: float = 1000.0) -> None:
    """Writes ``spans`` into a profiler trace (its JSON object), in place:
    a span's tags go into the ``args`` of its range (same thread and name,
    the nearest start within ``slack_us``); a span without a recorded
    range becomes a complete event on its thread's ``tid``; an
    explicit-time span becomes an async event."""
    events = data["traceEvents"]
    base = int(data.get("baseTimeNanoseconds", 0))
    ranges: Dict[tuple, list] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op"):
            ranges[(e.get("tid"), e.get("name"))].append(e)
    pid = os.getpid()
    for k, s in enumerate(spans):
        ts, dur, args = trace_ts(s.t0, base), (s.t1 - s.t0) / 1000.0, _args(s)
        if s.explicit:
            common = {"cat": "span", "name": s.name, "id": k, "pid": pid, "tid": s.tid}
            events.append({**common, "ph": "b", "ts": ts, "args": args})
            events.append({**common, "ph": "e", "ts": ts + dur})
            continue
        near = [e for e in ranges.get((s.tid, s.name), ())
                if abs(float(e["ts"]) - ts) <= slack_us and "span" not in e.get("args", {})]
        if near:
            hit = min(near, key=lambda e: abs(float(e["ts"]) - ts))
            hit.setdefault("args", {}).update(args, span=True)
        else:
            events.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                           "tid": s.tid, "ts": ts, "dur": dur, "args": {**args, "span": True}})


anchor()
