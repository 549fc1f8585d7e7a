"""Reducing a profiler trace to busy and idle time, operations and gaps."""

from __future__ import annotations

import pytest
import torch

from lens_bench import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summary_of_a_made_up_trace():
    events = [
        _x(trace.WINDOW, "user_annotation", 100, 100),
        _x("k<1, false>(float*)", "kernel", 90, 20),    # clipped to [100, 110]
        _x("k<1, false>(float*)", "kernel", 105, 20),   # overlaps: union [100, 125]
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 150, 10),
        _x("k<1, false>(float*)", "kernel", 250, 10),   # outside the window
        _x("aten::to", "cpu_op", 120, 40),              # open over the gap [125, 150]
        _x("cudaStreamSynchronize", "cuda_runtime", 130, 10),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.ops(r"k<1, false>", "kernel") == (pytest.approx(30e-6), 2)
    assert s.ops(r"HtoD|DtoH", "gpu_memcpy") == (pytest.approx(10e-6), 1)
    assert s.idle["aten::to > cudaStreamSynchronize"] == (pytest.approx(25e-6), 1)
    assert s.idle["host: no traced event"] == (pytest.approx(40e-6), 1)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k<1, false>", pytest.approx(30e-6)]
    assert len(b["idle_gaps"]) == 2


def test_a_slice_of_the_card_alone_counts_every_device_operation():
    events = [
        _x("k<1, false>(float*)", "kernel", 90, 20),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 150, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 80, 5),
    ]
    s = trace.summarize(events, window_s=100e-6)
    assert s.window_s == 100e-6
    assert s.busy_s == pytest.approx(30e-6)
    assert s.idle == {}


def test_loop_slices_measure_then_label():
    slices = trace.LoopSlices(cuda=False, skip=2, measured=3, labelled=2)
    calls = 0
    while calls < slices.end + 1:
        slices.at(calls)
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        calls += 1
    slices.at(calls)
    s = slices.summary
    assert s is not None and s.window_s > 0 and s.busy_s == 0
    assert s.idle  # the labelled slice's gaps
    with pytest.raises(ValueError):
        trace.LoopSlices(cuda=False, skip=0, measured=3, labelled=0)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([_x("aten::to", "cpu_op", 0, 1)])


def test_traced_on_the_cpu_reads_no_device_time():
    with trace.Traced(cuda=False) as t:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert t.summary.busy_s == 0 and t.summary.window_s > 0


def test_short_drops_the_argument_list():
    assert trace.short("void ns::k<2, (f)1>(float const*, int)") == "void ns::k<2, (f)1>"
    assert trace.short("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH (Device -> Pageable)"
