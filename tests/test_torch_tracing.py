"""The port's spans (``utils/tracing.py``): the zone table, the span log,
profiler ranges only while a profiler runs, one clock with the profiler's
trace, ``--trace-dir`` over every thread, and the spans of the pipeline,
of ``process_batch`` and of kernel B1's wrapper.

All on the CPU. B1's spans of a real launch are checked on the card by
``tests/test_torch_remap_kernel.py``'s ``gpu`` test.
"""

import contextlib
import json
import threading
import types

import numpy as np
import pytest
import torch

from image_lens_reproject_torch import cli, pipeline
from image_lens_reproject_torch.io import exr
from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.utils import tracing

F = np.float32
CPU = torch.profiler.ProfilerActivity.CPU
HEADLINE = [
    "--no-configs", "64,32", "--i-equirectangular", "full",
    "--rectilinear", "35,36", "--output-resolution", "48,27",
    "--rotation", "20,5,0", "--exposure", "1", "--reinhard", "4", "--bc",
]
DISPATCH = ("dispatch.stack", "dispatch.h2d", "dispatch.remap", "dispatch.d2h")


@pytest.fixture(autouse=True)
def _fresh_zones():
    tracing.reset_zones()
    yield
    tracing.reset_zones()


def _trace_of(prof, tmp_path):
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def _ranges(data, name):
    return [e for e in data["traceEvents"] if e.get("ph") == "X" and e.get("name") == name]


def _frames(directory, n=2):
    directory.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        exr.write_exr(str(directory / f"f{i}.exr"), rng.uniform(0, 2, (32, 64, 3)).astype(F))
    return directory


def _opts(**kw):
    return pipeline.PipelineOptions(
        input_lens=L.full_equirectangular(), output_lens=L.Rectilinear(35.0, 36.0, 27.0),
        out_width=48, out_height=27, interp="bilinear", device="cpu", **kw)


def test_a_span_without_a_profiler_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError("a range was opened with no profiler running")

    monkeypatch.setattr(tracing, "_open_range", no_range)
    with tracing.trace_zone("probe", frame=4, nbytes=96):
        pass
    with tracing.trace_zone("probe"):
        pass
    seconds, calls = tracing.zone_totals()["probe"]
    assert calls == 2 and seconds >= 0
    assert [(s.name, s.frame, s.nbytes) for s in tracing.span_log()] == [
        ("probe", 4, 96), ("probe", None, 0)]


def test_the_profiling_flag_follows_the_profiler():
    assert not tracing.profiling()
    with tracing.OFF:
        pass
    assert tracing.zone_totals() == {} and tracing.span_log() == []
    with torch.profiler.profile(activities=[CPU]):
        assert tracing.profiling()
    assert not tracing.profiling()


def test_ranges_appear_nested_under_a_profiler(tmp_path):
    with torch.profiler.profile(activities=[CPU]) as prof:
        with tracing.trace_zone("outer"):
            with tracing.trace_zone("inner"):
                torch.ones(8).sum()
    data = _trace_of(prof, tmp_path)
    (outer,), (inner,) = _ranges(data, "outer"), _ranges(data, "inner")
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_a_quiet_span_counts_but_opens_no_range(tmp_path):
    with torch.profiler.profile(activities=[CPU]) as prof:
        with tracing.trace_zone("loud"):
            with tracing.QuietSpan("quiet", frame=2):
                pass
    data = _trace_of(prof, tmp_path)
    assert len(_ranges(data, "loud")) == 1 and _ranges(data, "quiet") == []
    assert tracing.zone_totals()["quiet"][1] == 1
    tracing.merge_spans(data, tracing.span_log())
    (quiet,) = _ranges(data, "quiet")
    (loud,) = _ranges(data, "loud")
    assert quiet["args"]["frame"] == 2 and quiet["tid"] == loud["tid"]


def test_record_takes_a_wait_begun_on_another_thread():
    t0 = tracing.now_ns()
    seen = {}

    def worker():
        seen["tid"] = threading.get_native_id()
        tracing.record("queue.wait", t0, tracing.now_ns(), frame=7)

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    (rec,) = tracing.span_log()
    assert (rec.name, rec.frame, rec.explicit, rec.tid) == ("queue.wait", 7, True, seen["tid"])
    assert rec.t0 == t0 <= rec.t1
    assert tracing.zone_totals()["queue.wait"][1] == 1


def test_a_span_lies_on_its_range_in_the_trace(tmp_path):
    with torch.profiler.profile(activities=[CPU]) as prof:
        with tracing.trace_zone("clocked"):
            torch.ones(1024).sum()
    data = _trace_of(prof, tmp_path)
    (rng,) = _ranges(data, "clocked")
    (span,) = tracing.span_log()
    base = int(data.get("baseTimeNanoseconds", 0))
    start, end = tracing.trace_ts(span.t0, base), tracing.trace_ts(span.t1, base)
    # within 1 ms of the range's [ts, ts + dur]
    assert rng["ts"] - 1000 <= start <= rng["ts"] + rng["dur"] + 1000
    assert rng["ts"] - 1000 <= end <= rng["ts"] + rng["dur"] + 1000


def _cli_trace(tmp_path, monkeypatch=None, all_threads=True):
    if not all_threads:
        monkeypatch.setattr(tracing, "_all_threads_config", lambda: None)
    src = _frames(tmp_path / "in")
    trace = tmp_path / "trace"
    assert cli.main(HEADLINE + ["-i", str(src), "-o", str(tmp_path / "out"), "--exr",
                                "--device", "cpu", "-j", "2", "--trace-dir", str(trace)]) == 0
    return json.loads((trace / "trace.json").read_text())["traceEvents"]


def _tagged(events, name):
    return {e["args"]["frame"]: e for e in events
            if e.get("ph") == "X" and e.get("name") == name and "frame" in e.get("args", {})}


@pytest.mark.parametrize("all_threads", [True, False])
def test_trace_dir_holds_every_thread_with_frame_tags(tmp_path, monkeypatch, all_threads):
    """With the profiler's all-threads option, or without it from the span
    log: decode and encode on the pool threads, each frame tagged, and
    the dispatch spans inside their frame's ``device_dispatch``."""
    events = _cli_trace(tmp_path, monkeypatch, all_threads)
    dispatch = _tagged(events, "device_dispatch")
    assert set(dispatch) == {0, 1}
    main_tid = dispatch[0]["tid"]
    for name in ("decode", "encode"):
        tagged = _tagged(events, name)
        assert set(tagged) == {0, 1}
        assert all(e["tid"] != main_tid for e in tagged.values())
    for name in DISPATCH:
        for frame, e in _tagged(events, name).items():
            outer = dispatch[frame]
            assert e["tid"] == main_tid
            assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    queued = [e for e in events if e.get("name") == "encode.queued" and e.get("ph") == "b"]
    assert sorted(e["args"]["frame"] for e in queued) == [0, 1]


def test_process_batch_records_each_dispatch_span_once_with_its_bytes():
    images = [np.random.default_rng(i).uniform(0, 2, (32, 64, 3)).astype(F) for i in range(2)]
    pipeline.process_batch(images, _opts(), frame=5)
    totals, log = tracing.zone_totals(), tracing.span_log()
    for name in ("device_dispatch",) + DISPATCH:
        assert totals[name][1] == 1, name
    assert {s.name: s.nbytes for s in log if s.nbytes} == {
        "dispatch.stack": 2 * 32 * 64 * 3 * 4, "dispatch.h2d": 2 * 32 * 64 * 3 * 4,
        "dispatch.d2h": 2 * 27 * 48 * 3 * 4}
    assert {s.frame for s in log} == {5}


@pytest.mark.parametrize("ordering", ["overlap", "serial"])
def test_each_frame_waits_once_for_decode_and_once_for_an_encoder(tmp_path, ordering):
    src = _frames(tmp_path / "in", n=3)
    paths = pipeline.discover_files(str(src))
    stats = pipeline.run_pipeline(paths, str(tmp_path / "out"),
                                  _opts(store_exr=True, num_threads=2, ordering=ordering))
    assert stats.done == 3 and not stats.failed
    by_name = {}
    for s in tracing.span_log():
        by_name.setdefault(s.name, []).append(s.frame)
    for name in ("dispatch.wait_decode", "encode.queued", "decode", "encode",
                 "device_dispatch"):
        assert sorted(by_name[name]) == [0, 1, 2], name
    assert by_name["pipeline.drain"] == [None]


@pytest.mark.parametrize("profiled", [False, True])
def test_b1_spans_only_while_a_profiler_runs(profiled):
    """B1's wrapper off the CPU: here a meta tensor, which its checks
    refuse; the wrapper's span is recorded only under a profiler."""
    batch = torch.empty((1, 8, 16, 3), device="meta")
    kw = dict(in_lens=L.full_equirectangular(), out_lens=L.Rectilinear(35.0, 36.0, 27.0),
              out_h=4, out_w=8)
    with torch.profiler.profile(activities=[CPU]) if profiled else contextlib.nullcontext():
        with pytest.raises(ValueError, match="unsupported device"):
            B1.remap_tonemap(batch, None, **kw)
    b1 = {k: n for k, (_, n) in tracing.zone_totals().items() if k.startswith("b1.")}
    assert b1 == ({"b1.wrapper": 1} if profiled else {})


def test_the_report_prints_each_copy_s_bytes_and_rate():
    with tracing.trace_zone("dispatch.h2d", nbytes=2_000_000):
        pass
    with tracing.trace_zone("decode"):
        pass
    lines = tracing.zone_report().splitlines()
    assert lines[0] == "--- phase timings ---"
    copy = next(line for line in lines if line.strip().startswith("dispatch.h2d:"))
    assert "2.0 MB at" in copy and copy.endswith("GB/s")
    assert "MB" not in next(line for line in lines if line.strip().startswith("decode:"))


def test_reset_empties_every_thread_s_totals_and_the_log():
    def elsewhere():
        with tracing.trace_zone("elsewhere"):
            pass

    th = threading.Thread(target=elsewhere)
    th.start()
    th.join()
    with tracing.trace_zone("here"):
        pass
    assert set(tracing.zone_totals()) == {"elsewhere", "here"}
    tracing.reset_zones()
    assert tracing.zone_totals() == {} and tracing.span_log() == [] and tracing.zone_report() == ""


def test_merge_tags_ranges_and_adds_the_unrecorded_spans():
    base = 1_000_000_000
    t0 = 5_000_000 - tracing._offset_ns + base  # trace_ts(t0, base) == 5000 us
    span = tracing.SpanRecord("decode", 11, t0, t0 + 2_000_000, 3, 0, None, False)
    other = tracing.SpanRecord("encode", 12, t0, t0 + 1_000_000, 3, 0, None, False)
    wait = tracing.SpanRecord("encode.queued", 12, t0, t0 + 500_000, 3, 0, None, True)
    data = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "decode", "tid": 11, "ts": 5000.3,
         "dur": 1999.0, "args": {}}]}
    tracing.merge_spans(data, [span, other, wait])
    ev = data["traceEvents"]
    assert ev[0]["args"]["frame"] == 3 and len(_ranges(data, "decode")) == 1
    (enc,) = _ranges(data, "encode")
    assert (enc["tid"], enc["ts"], enc["dur"], enc["args"]["frame"]) == (12, 5000.0, 1000.0, 3)
    assert [e["ph"] for e in ev if e["name"] == "encode.queued"] == ["b", "e"]


SPAN_READERS = [
    ("h2d_ms.dir", {"dispatch.stack": (0.004, 2), "dispatch.h2d": (0.002, 2)}, 3.0),
    ("d2h_ms.dir", {"dispatch.d2h": (0.010, 2)}, 5.0),
    ("decode_wait_ms.dir", {"dispatch.wait_decode": (0.001, 2)}, 0.5),
    ("encode_queue_ms.dir", {"encode.queued": (0.5, 2)}, 250.0),
]


@pytest.mark.parametrize("metric,zones,want", SPAN_READERS)
def test_the_benchmark_reads_the_dispatch_and_queue_spans(metric, zones, want):
    from lens_bench import cells

    read = cells.reader(metric)
    ctx = types.SimpleNamespace(result=types.SimpleNamespace(zones=zones, frames=2))
    assert read(ctx) == pytest.approx(want)
    assert read(types.SimpleNamespace(result=types.SimpleNamespace(zones={}, frames=2))) is None


def test_the_benchmark_reads_b1_s_wrapper_host_time():
    from lens_bench import cells

    read = cells.reader("launch_host_us.remap")
    assert read(None) is None
    for _ in range(4):
        with tracing.trace_zone("b1.wrapper"):
            with tracing.trace_zone("b1.rotation"):
                pass
    totals = tracing.zone_totals()
    want = 1e6 * (totals["b1.wrapper"][0] - totals["b1.rotation"][0]) / 4
    assert read(None) == pytest.approx(want) and want > 0
