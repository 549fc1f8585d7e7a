"""The system under test: the entry points of ``image_lens_reproject_torch``
that the cells drive, and nothing else of it.

The benchmark hands the program its inputs and lenses built from the
configuration file, and reads back its outputs, its tracing zones and its
kernel names. The package is imported at the first call, never when this
module is.
"""

from __future__ import annotations

import importlib

import numpy as np

PACKAGE = "image_lens_reproject_torch"
LENS_CLASSES = {
    "rectilinear": "Rectilinear",
    "fisheye_equidistant": "FisheyeEquidistant",
    "fisheye_equisolid": "FisheyeEquisolid",
    "fisheye_stereographic": "FisheyeStereographic",
    "equirectangular": "Equirectangular",
}


def module(name: str = ""):
    return importlib.import_module(PACKAGE + (f".{name}" if name else ""))


def lens(spec: dict):
    """The program's lens for a configuration's lens dict."""
    params = {k: v for k, v in spec.items() if k != "type"}
    return getattr(module(), LENS_CLASSES[spec["type"]])(**params)


def remap_kwargs(cfg: dict) -> dict:
    """``remap_tonemap_batch``'s keyword arguments for the configuration."""
    return dict(in_lens=lens(cfg["in_lens"]), out_lens=lens(cfg["out_lens"]),
                out_h=cfg["out_h"], out_w=cfg["out_w"], interp=cfg["interp"],
                n_samples=cfg.get("n_samples", 1),
                exposure=2.0 ** cfg.get("exposure_ev", 0.0), reinhard=cfg.get("reinhard", 1.0))


def remap_batch():
    """The exported fused remap entry point, ``remap_tonemap_batch``."""
    return module().remap_tonemap_batch


def pipeline_options(cfg: dict, rotation, device: str):
    """``PipelineOptions`` of the configuration, for ``process_batch``."""
    kw = remap_kwargs(cfg)
    return module("pipeline").PipelineOptions(
        input_lens=kw["in_lens"], output_lens=kw["out_lens"], out_width=cfg["out_w"],
        out_height=cfg["out_h"], interp=cfg["interp"], n_samples=kw["n_samples"],
        rotation=None if rotation is None else np.asarray(rotation, dtype=np.float32),
        exposure=kw["exposure"], reinhard=kw["reinhard"], device=device)


def process_batch():
    return module("pipeline").process_batch


def cli_main():
    return module("cli").main


def tracing():
    return module("utils.tracing")
