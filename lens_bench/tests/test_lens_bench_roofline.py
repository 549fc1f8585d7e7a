"""The bound's arithmetic against cases counted by hand."""

from __future__ import annotations

import pytest
import torch

from lens_bench import roofline


def test_bound_takes_the_longer_of_bytes_and_instructions():
    assert roofline.bound_s(3.35e12, 0) == (1.0, "bytes")
    assert roofline.bound_s(0, 33.5e12) == (1.0, "operations")
    assert roofline.bound_s(3.35e12, 2 * 33.5e12) == (2.0, "operations")


def test_distinct_counts_each_value_once():
    idx = [torch.tensor([0, 1, 1, 5]), torch.tensor([[5, 7], [0, 0]])]
    assert roofline.distinct(8, idx) == 4
    assert roofline.distinct(8, []) == 0


def test_counts_by_hand():
    # 10 texels and 6 pixels of 3 channels, 4 bytes a value; bilinear:
    # 4 taps, a multiply and an add each, per pixel and channel.
    assert roofline.counts(10, 3, 6, "bilinear") == (4 * 3 * 16, 2 * 6 * 3 * 4)
    assert roofline.counts(10, 3, 6, "bicubic", n_samples=2) == (4 * 3 * 16, 2 * 6 * 3 * 16 * 4)
    assert roofline.counts(1, 4, 1, "nearest") == (32, 8)


def _halving(interp):
    # A 4 x 4 rectilinear view of an 8 x 8 rectilinear source through the
    # same lens: output pixel i sits at source 2 i + 0.5 on each axis.
    lens = {"type": "rectilinear", "focal_length": 35.0, "sensor_width": 36.0,
            "sensor_height": 36.0}
    return {"src_h": 8, "src_w": 8, "out_h": 4, "out_w": 4, "channels": 3, "interp": interp,
            "in_lens": lens, "out_lens": lens, "rotation_deg": [0.0, 0.0, 0.0]}


@pytest.mark.parametrize("interp,texels", [
    ("nearest", 16),   # trunc(2 i + 1): one texel a pixel, all different
    ("bilinear", 64),  # trunc(2 i + 0.5) and the next: every texel
    ("bicubic", 64),   # 2 i - 1 .. 2 i + 2, clamped: every texel
])
def test_footprint_by_hand(interp, texels):
    assert roofline.footprint(_halving(interp), "cpu", rows_per_block=3) == (texels, 16)


def test_bound_of_a_frame():
    cfg = _halving("nearest")
    seconds, binds = roofline.remap_bound_s(cfg, "cpu")
    assert binds == "bytes" and seconds == pytest.approx(4 * 3 * (16 + 16) / 3.35e12)
