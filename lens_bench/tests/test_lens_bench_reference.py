"""The frozen reference against the program's plain path on the CPU.

The reference follows the plain path's float32 operations in their order,
so on the CPU the two agree to the bit at shapes without vector tails and
within a few ulps elsewhere; the control (bfloat16 pixel arithmetic) is
rejected by every configuration's limits.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from lens_bench import frames, program
from lens_bench.compare import Checks, frame_numbers, limits_of
from lens_bench.reference import projections as P
from lens_bench.reference import remap as ref

from .conftest import CELLS, tiny
from lens_bench import cells

LENSES = {
    "rectilinear": {"type": "rectilinear", "focal_length": 24.0, "sensor_width": 36.0,
                    "sensor_height": 27.0},
    "fisheye_equidistant": {"type": "fisheye_equidistant", "fov": math.pi,
                            "sensor_width": 36.0, "sensor_height": 36.0},
    "fisheye_equisolid": {"type": "fisheye_equisolid", "focal_length": 12.0, "fov": math.pi,
                          "sensor_width": 36.0, "sensor_height": 36.0},
    "fisheye_stereographic": {"type": "fisheye_stereographic", "focal_length": 10.0,
                              "fov": math.pi, "sensor_width": 36.0, "sensor_height": 36.0},
    "equirectangular": {"type": "equirectangular", "longitude_min": -math.pi,
                        "longitude_max": math.pi, "latitude_min": -math.pi / 2,
                        "latitude_max": math.pi / 2},
}


def _cfg(in_lens, out_lens, interp, n_samples=1, rotation=(12.0, -7.0, 3.0)):
    return {"src_h": 24, "src_w": 40, "channels": 3, "out_h": 16, "out_w": 32,
            "in_lens": LENSES[in_lens], "out_lens": LENSES[out_lens], "interp": interp,
            "n_samples": n_samples, "rotation_deg": list(rotation), "exposure_ev": 0.5,
            "reinhard": 3.0}


def _port(src, cfg):
    from image_lens_reproject_torch.ops.cuda import remap_kernel

    return remap_kernel.remap_tonemap_plain(src, ref.rotation_of(cfg), **program.remap_kwargs(cfg))


def _same(got, want):
    nums = frame_numbers(got, want)
    assert nums["nan_mismatch"] == 0 and nums["max_abs"] <= 1e-6, nums


@pytest.mark.parametrize("in_lens", sorted(LENSES))
@pytest.mark.parametrize("out_lens", sorted(LENSES))
def test_every_lens_pair_as_the_plain_path(in_lens, out_lens):
    cfg = _cfg(in_lens, out_lens, "bilinear")
    src = frames.make(1, cfg["src_h"], cfg["src_w"], 3, seed=7, device="cpu")
    _same(ref.remap(src, cfg, rows_per_block=5), _port(src, cfg))


@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("n_samples", [1, 2])
def test_samplers_and_supersamples_as_the_plain_path(interp, n_samples):
    cfg = _cfg("equirectangular", "rectilinear", interp, n_samples)
    src = frames.make(2, cfg["src_h"], cfg["src_w"], 3, seed=8, device="cpu")
    _same(ref.remap(src, cfg), _port(src, cfg))


@pytest.mark.parametrize("name", ["headline.resident", "fisheye_pano.resident"])
def test_the_configurations_as_the_plain_path(name):
    cfg = tiny(cells.load_cell(name)).config
    src = frames.make(2, cfg["src_h"], cfg["src_w"], cfg["channels"], seed=9, device="cpu")
    _same(ref.remap(src, cfg, rows_per_block=7), _port(src, cfg))


def test_rotation_as_the_program_s():
    from image_lens_reproject_torch import rotation_matrix_degrees

    for angles in [(20.0, 5.0, 0.0), (30.0, 10.0, 5.0), (-170.0, 89.0, -33.0)]:
        assert np.array_equal(P.rotation_matrix_degrees(*angles), rotation_matrix_degrees(*angles))
    assert ref.rotation_of({"rotation_deg": [0.0, 0.0, 0.0]}) is None


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_every_configuration_s_limits(name):
    cfg = tiny(cells.load_cell(name)).config
    src = frames.make(2, cfg["src_h"], cfg["src_w"], cfg["channels"], seed=12, device="cpu")
    checks = Checks(limits_of(cfg))
    assert checks.frame(ref.remap(src, cfg), ref.remap(src, cfg))
    assert not checks.frame(ref.remap(src, cfg, dtype=torch.bfloat16), ref.remap(src, cfg))
    assert checks.values["p999_abs"] > 10 * cfg["accuracy"]["p999_abs"]


def test_frames_are_the_seed_s():
    a = frames.make(2, 8, 12, 3, seed=2**31 + 5, device="cpu")
    assert torch.equal(a, frames.make(2, 8, 12, 3, seed=2**31 + 5, device="cpu"))
    assert not torch.equal(a, frames.make(2, 8, 12, 3, seed=2**31 + 6, device="cpu"))
    assert 0.05 < float(a.min()) and float(a.max()) < 0.95
