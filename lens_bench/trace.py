"""Traced slices of a run: ``torch.profiler`` over the card and the host.

``Traced`` profiles what runs inside it and reduces the profiler's trace
to a ``Summary``:

- ``window_s``: the slice's length; ``busy_s``: the union of the card's
  kernels, copies and fills inside it;
- device operations by name, with their seconds and counts;
- the idle gaps between device operations, each labelled by the host
  events (annotations, operators, CUDA runtime calls, on the threads the
  profiler records) that were open at the gap's middle.

Recording the host's events costs host time at every operator, and that
time lands in the very gaps it labels. So a slice that measures
``busy_s`` and ``window_s`` in a loop of short calls profiles the card
alone (``host=False``: its window is the host clock's between two
synchronisations of the card, and its gaps go unlabelled), and the labels
come from a separate, shorter slice with the host's events
(``LoopSlices``). A slice with ``host=True`` spans one annotation of the
benchmark's own (``WINDOW``), closed after the card is synchronised.

Only the benchmark's files read a trace; the program is profiled, never
asked.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "lens_bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    # name -> (seconds, count), inside the window
    device_ops: Dict[str, Tuple[float, int]]
    # category ("kernel", "gpu_memcpy", "gpu_memset") -> name -> (seconds, count)
    by_category: Dict[str, Dict[str, Tuple[float, int]]]
    # label -> (seconds, gaps)
    idle: Dict[str, Tuple[float, int]]

    def ops(self, pattern: str, category: Optional[str] = None) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose full name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        pool = self.by_category.get(category, {}) if category else self.device_ops
        hits = [v for k, v in pool.items() if rx.search(k)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[short(k), s] for k, (s, _) in top],
                "idle_gaps": [[f"{k} [{n} gaps]", s] for k, (s, n) in gaps]}


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 160 characters;
    other names (a copy's, which says pageable or pinned) as they are."""
    if name.endswith(")") and ("::" in name or "<" in name):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[:160]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[dict], window_s: Optional[float] = None) -> Summary:
    """The ``Summary`` of a Chrome trace's events (times in microseconds).

    Without ``window_s`` the window is the trace's ``WINDOW`` span, and the
    gaps in it are labelled by the host events. With ``window_s`` (a slice
    of the card alone, timed on the host) every device operation of the
    trace counts, and no gap is labelled."""
    if window_s is None:
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
        if not spans:
            raise ValueError(f"the trace holds no {WINDOW} span")
        w0 = float(spans[0]["ts"])
        w1 = w0 + float(spans[0]["dur"])
    else:
        w0, w1 = float("-inf"), float("inf")
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b, e["cat"], e.get("name", "?")))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
            host.append((a, b, e.get("name", "?")))
    by_category: Dict[str, Dict[str, List[float]]] = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b, cat, name in device:
        for acc in (ops[name], by_category[cat][name]):
            acc[0] += (b - a) * 1e-6
            acc[1] += 1
    busy = _union([(a, b) for a, b, _, _ in device])
    idle: Dict[str, Tuple[float, int]] = {}
    if window_s is None:
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        idle = _label_gaps(gaps, host)
        window_s = (w1 - w0) * 1e-6
    return Summary(
        window_s=window_s,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops={k: (v[0], int(v[1])) for k, v in ops.items()},
        by_category={c: {k: (v[0], int(v[1])) for k, v in d.items()}
                     for c, d in by_category.items()},
        idle=idle,
    )


def _label_gaps(gaps, host) -> Dict[str, Tuple[float, int]]:
    """label -> (seconds, count) of ``gaps``, labelled by the outermost and
    innermost host events open at each gap's middle."""
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    if not gaps:
        return {}
    starts = np.array([a for a, _, _ in host], dtype=np.float64)
    ends = np.array([b for _, b, _ in host], dtype=np.float64)
    lengths = ends - starts
    names = [n for _, _, n in host]
    for g0 in range(0, len(gaps), 256):
        chunk = gaps[g0:g0 + 256]
        mids = np.array([(a + b) / 2 for a, b in chunk])
        inside = (starts[None, :] <= mids[:, None]) & (ends[None, :] >= mids[:, None])
        for (a, b), row in zip(chunk, inside):
            idx = np.nonzero(row)[0]
            if idx.size == 0:
                label = "host: no traced event"
            else:
                outer = names[idx[np.argmax(lengths[idx])]]
                inner = names[idx[np.argmin(lengths[idx])]]
                label = outer if outer == inner else f"{outer} > {inner}"
            out[label][0] += (b - a) * 1e-6
            out[label][1] += 1
    return {k: (v[0], int(v[1])) for k, v in out.items()}


class Traced:
    """Profiles the card (when ``cuda``) inside a ``with``, and the host's
    events too with ``host`` (on the CPU, always); ``summary`` holds the
    reduced trace after it closes."""

    def __init__(self, cuda: bool, host: bool = True):
        self.cuda = cuda
        self.host = host or not cuda
        self.summary: Optional[Summary] = None
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host else []
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._span = None
        self._t0 = 0.0
        self._window_s: Optional[float] = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._prof.__enter__()
        if self.host:
            self._span = torch.profiler.record_function(WINDOW)
            self._span.__enter__()
        else:
            self._sync()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            self._sync()
            if self.host:
                self._span.__exit__(*exc)
            else:
                self._window_s = time.perf_counter() - self._t0
        finally:
            self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    data = json.load(f)
            finally:
                os.unlink(path)
            events = data["traceEvents"] if isinstance(data, dict) else data
            self.summary = summarize(events, self._window_s)
        return False


class LoopSlices:
    """The traced part of a closed loop of calls: after ``skip`` calls,
    ``measured`` calls profiled on the card alone (busy, window, device
    operations), then ``labelled`` calls (at least 1) profiled with the
    host's events, whose idle gaps label the summary's. ``at(calls)`` is
    called before each call and once after the loop, with the calls made
    so far; ``summary`` is set once the last slice has closed."""

    def __init__(self, cuda: bool, skip: int, measured: int, labelled: int):
        if measured < 1 or labelled < 1:
            raise ValueError("a traced loop needs measured and labelled calls")
        self.cuda = cuda
        self.marks = (skip, skip + measured, skip + measured + labelled)
        self.summary: Optional[Summary] = None
        self._open: Optional[Traced] = None
        self._measured: Optional[Summary] = None

    @property
    def end(self) -> int:
        return self.marks[2]

    def at(self, calls: int) -> None:
        if calls == self.marks[0] and self._open is None and self._measured is None:
            self._open = Traced(self.cuda, host=False).__enter__()
        elif calls == self.marks[1] and self._measured is None and self._open is not None:
            self._open.__exit__(None, None, None)
            self._measured = self._open.summary
            self._open = Traced(self.cuda, host=True).__enter__()
        elif calls == self.marks[2] and self._measured is not None and self._open is not None:
            self._open.__exit__(None, None, None)
            self.summary = dataclasses.replace(self._measured, idle=self._open.summary.idle)
            self._open = None


def warm_profiler(cuda: bool) -> None:
    """An empty profiled slice of each kind, so that the profiler's own
    start-up (CUPTI) falls into set-up and not into a traced slice."""
    for host in (False, True):
        with Traced(cuda, host):
            pass
