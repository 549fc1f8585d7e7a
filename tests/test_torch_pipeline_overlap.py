"""The port's pipeline stages overlap (decode threads -> device dispatch ->
encode threads), as the reference's CTPL per-image fan-out does
(src/main.cpp:536-660).

A CPU test host cannot show that with real codecs (every stage competes
for the same cores), so the stages are stubbed with GIL-releasing sleeps,
which is what file IO and an asynchronous device dispatch look like to
the host thread, and the wall clock must come in well under the serial
sum of the stages. This pins the orchestration (prefetch, hand-off,
encode futures), whatever the host's core count. The last test reads the
same overlap from the pipeline's own spans.
"""

import time
from pathlib import Path

import numpy as np
import pytest

from image_lens_reproject_torch import pipeline
from image_lens_reproject_torch.io.image import DataLayout, ImageBuffer
from image_lens_reproject_torch.models.lens import Rectilinear
from image_lens_reproject_torch.ops import remap_fused
from image_lens_reproject_torch.utils import tracing

N_FRAMES = 6
DECODE_S = 0.08
DEVICE_S = 0.08
ENCODE_S = 0.08


def _opts():
    lens = Rectilinear(35.0, 36.0, 36.0)
    return pipeline.PipelineOptions(
        input_lens=lens, output_lens=lens, out_width=16, out_height=16,
        interp="bilinear", store_exr=True, num_threads=4, batch_size=1, device="cpu",
    )


def _paths(n=N_FRAMES):
    return [Path(f"/nonexistent/frame{i:03d}.exr") for i in range(n)]


def _image():
    return np.zeros((16, 16, 3), np.float32)


def test_stages_overlap(tmp_path, monkeypatch):
    def fake_read(path):
        time.sleep(DECODE_S)
        return ImageBuffer(_image(), DataLayout.RGB)

    def fake_process(images, opts, frame=None):
        time.sleep(DEVICE_S)  # asynchronous device dispatch and fetch stand-in
        return [i.copy() for i in images]

    def fake_write(out, layout, opts, out_png, out_exr, frame=None):
        time.sleep(ENCODE_S)

    monkeypatch.setattr(pipeline, "read_image", fake_read)
    monkeypatch.setattr(pipeline, "process_batch", fake_process)
    monkeypatch.setattr(pipeline, "write_outputs", fake_write)

    stats = pipeline.run_pipeline(_paths(), str(tmp_path / "out"), _opts())

    assert stats.done == N_FRAMES and not stats.failed
    serialized = N_FRAMES * (DECODE_S + DEVICE_S + ENCODE_S)
    # The pipelined floor is ~N * DEVICE_S plus one decode and one encode:
    # at least ~35 % saved over the serial sum shows decode and encode ran
    # beside the device stage.
    assert stats.wall_seconds < 0.65 * serialized, (
        f"pipeline did not overlap: wall={stats.wall_seconds:.2f}s "
        f"vs serialized {serialized:.2f}s")


def test_failures_do_not_stall_overlap(tmp_path, monkeypatch):
    """A decode failure mid-stream is isolated and the rest still pipeline."""

    def fake_read(path):
        time.sleep(DECODE_S)
        if "frame002" in path.name:
            raise IOError("corrupt frame")
        return ImageBuffer(_image(), DataLayout.RGB)

    monkeypatch.setattr(pipeline, "read_image", fake_read)
    monkeypatch.setattr(
        pipeline, "process_batch",
        lambda images, opts, frame=None: (time.sleep(DEVICE_S), [i.copy() for i in images])[1])
    monkeypatch.setattr(pipeline, "write_outputs", lambda *a, **k: time.sleep(ENCODE_S))

    stats = pipeline.run_pipeline(_paths(), str(tmp_path / "out"), _opts())
    assert stats.done == N_FRAMES - 1
    assert stats.failed == ["frame002.exr"]
    serialized = N_FRAMES * (DECODE_S + DEVICE_S + ENCODE_S)
    assert stats.wall_seconds < 0.65 * serialized


def test_serial_ordering(tmp_path, monkeypatch):
    """ordering='serial' completes each frame before the next decode
    starts, and the choice is recorded on the stats."""
    events = []

    def fake_read(path):
        events.append(("decode", path.name))
        return ImageBuffer(_image(), DataLayout.RGB)

    def fake_write(out, layout, opts, out_png, out_exr, frame=None):
        events.append(("write", out_png.stem))

    monkeypatch.setattr(pipeline, "read_image", fake_read)
    monkeypatch.setattr(pipeline, "process_batch",
                        lambda images, opts, frame=None: [i.copy() for i in images])
    monkeypatch.setattr(pipeline, "write_outputs", fake_write)

    opts = _opts()
    opts.ordering = "serial"
    stats = pipeline.run_pipeline(_paths(4), str(tmp_path / "out"), opts)
    assert stats.done == 4 and not stats.failed
    assert stats.ordering == "serial"
    # strict alternation: decode_i, write_i, decode_{i+1}, ...
    assert events == [
        ev for i in range(4)
        for ev in (("decode", f"frame{i:03d}.exr"), ("write", f"frame{i:03d}"))
    ]


def test_bad_ordering_rejected(tmp_path):
    opts = _opts()
    opts.ordering = "speedy"
    with pytest.raises(ValueError, match="ordering"):
        pipeline.run_pipeline([], str(tmp_path / "out"), opts)


@pytest.mark.parametrize("ordering", ["overlap", "serial"])
def test_the_spans_show_the_next_decode_beside_the_dispatch(tmp_path, monkeypatch, ordering):
    """From the pipeline's own spans: under ``overlap`` frame n + 1's
    ``decode`` overlaps frame n's ``device_dispatch``; under ``serial`` it
    never does. The device stand-in sleeps inside the real
    ``process_batch``, so the spans are the pipeline's own; one decode
    thread, so that decodes run one after another, frame n + 1's while
    frame n is dispatched."""

    def fake_read(path):
        time.sleep(DECODE_S)
        return ImageBuffer(_image(), DataLayout.RGB)

    def slow_remap(batch, rotation, **kw):
        time.sleep(DEVICE_S)
        return batch

    monkeypatch.setattr(pipeline, "read_image", fake_read)
    monkeypatch.setattr(remap_fused, "remap_tonemap_batch", slow_remap)
    monkeypatch.setattr(pipeline, "write_outputs", lambda *a, **k: None)
    opts = _opts()
    opts.ordering, opts.num_threads = ordering, 1
    tracing.reset_zones()
    stats = pipeline.run_pipeline(_paths(4), str(tmp_path / "out"), opts)
    assert stats.done == 4 and not stats.failed
    spans = {(s.name, s.frame): s for s in tracing.span_log()}
    tracing.reset_zones()

    def overlaps(n):
        d, nxt = spans[("device_dispatch", n)], spans[("decode", n + 1)]
        return nxt.t0 < d.t1 and d.t0 < nxt.t1

    got = [overlaps(n) for n in range(3)]
    assert all(got) if ordering == "overlap" else not any(got)
