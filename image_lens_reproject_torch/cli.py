"""Command-line interface of the PyTorch port — mirror of the JAX package's CLI.

Reference: src/main.cpp:144-379 (cxxopts option groups), 15-95 (lens-string
parsers), 380-534 (config round-trip driver). Same flags, same semantics,
same mutual-exclusion validation, same error strings where they matter:

  --input-cfg/--output-cfg | --no-configs W,H
  -i/--input-dir | --single        -o/--output-dir     --exr --png
  --filter-prefix --filter-suffix
  -s/--samples  --nn --bl --bc     --scale | --output-resolution W,H
  --i-rectilinear --i-equisolid --i-equidistant --i-equirectangular
  --no-reproject --rectilinear --equisolid --equidistant --equirectangular
  --rotation pan,pitch,roll(deg)   --exposure EV  --reinhard MAX
  --skip-if-exists  -j/--parallel  --dry-run

Framework extensions (not in the reference, clearly marked in --help):
  --batch-size N    images per device dispatch
  --i-stereographic / --stereographic   stereographic fisheye lens
  --json-log        machine-readable JSON progress lines
  --trace-dir DIR   write a torch.profiler trace (Tracy-zone analog)
  --pure-torch      run the plain PyTorch path in place of the CUDA kernel
  --device cuda|cpu the device the remap runs on (default cuda; without a
                    GPU, cuda is an error, not a silent move to the CPU)
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .models.lens import (
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    Rectilinear,
    full_equirectangular,
)
from .models.rotation import is_identity, rotation_matrix_degrees
from .ops import dispatch
from .pipeline import PipelineOptions, discover_files, run_pipeline
from .utils import config as config_mod
from .utils import tracing


class CliError(Exception):
    """Usage error -> printed message + exit code 1 (reference style)."""


def parse_rectilinear(lstr: str, res_x: float, res_y: float) -> Rectilinear:
    """--rectilinear focal_len,sensor_width (src/main.cpp:15-29)."""
    parts = lstr.split(",")
    if len(parts) < 2:
        raise CliError("Error: Required format for --rectilinear focal_len,sensor_width")
    focal_length = float(parts[0])
    sensor_width = float(parts[1])
    sensor_height = float(res_y) / float(res_x) * sensor_width
    return Rectilinear(focal_length, sensor_width, sensor_height)


def parse_equisolid(lstr: str, res_x: float, res_y: float) -> FisheyeEquisolid:
    """--equisolid focal_len,sensor_width,fov (src/main.cpp:31-47); fov in degrees -> radians? No:
    the reference stores the CLI value as-is; Blender configs carry radians. We pass through."""
    parts = lstr.split(",")
    if len(parts) < 3:
        raise CliError("Error: Required format for --equisolid focal_len,sensor_width,fov")
    focal_length = float(parts[0])
    sensor_width = float(parts[1])
    fov = float(parts[2])
    sensor_height = float(res_y) / float(res_x) * sensor_width
    return FisheyeEquisolid(focal_length, fov, sensor_width, sensor_height)


def parse_stereographic(lstr: str, res_x: float, res_y: float) -> FisheyeStereographic:
    """--stereographic focal_len,sensor_width,fov (framework extension —
    enum-only in the reference, src/config.hpp:11)."""
    parts = lstr.split(",")
    if len(parts) < 3:
        raise CliError("Error: Required format for --stereographic focal_len,sensor_width,fov")
    focal_length = float(parts[0])
    sensor_width = float(parts[1])
    fov = float(parts[2])
    sensor_height = float(res_y) / float(res_x) * sensor_width
    return FisheyeStereographic(focal_length, fov, sensor_width, sensor_height)


def parse_equidistant(lstr: str, res_x: float, res_y: float) -> FisheyeEquidistant:
    """--equidistant fov; hardcoded 36x36 sensor (src/main.cpp:49-56)."""
    return FisheyeEquidistant(fov=float(lstr), sensor_width=36.0, sensor_height=36.0)


def parse_equirectangular(lstr: str, res_x: float, res_y: float) -> Equirectangular:
    """--equirectangular lmin,lmax,latmin,latmax | full (src/main.cpp:58-95)."""
    if lstr == "full":
        return full_equirectangular()
    parts = lstr.split(",")
    if len(parts) != 4:
        raise CliError(f"Error: expected 4 arguments for equirectangular, got {len(parts)}.")
    lon_min, lon_max, lat_min, lat_max = (float(p) for p in parts)
    return Equirectangular(
        longitude_min=lon_min,
        longitude_max=lon_max,
        latitude_min=lat_min,
        latitude_max=lat_max,
    )


def parse_rotation(rot_str: str) -> np.ndarray:
    """--rotation pan,pitch,roll in degrees (src/main.cpp:312-325).

    Mirrors C atof leniency: missing fields parse as 0.
    """
    parts = (rot_str.split(",") + ["0", "0", "0"])[:3]

    def atof(s: str) -> float:
        try:
            return float(s)
        except ValueError:
            return 0.0

    return rotation_matrix_degrees(atof(parts[0]), atof(parts[1]), atof(parts[2]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="image-lens-reproject-torch",
        description=(
            "Reprojection tool for producing a variation of lens\n"
            "configurations based on one reference image given a\n"
            "known lens configuration.  (PyTorch + CUDA port)"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    g = p.add_argument_group("Input/output")
    g.add_argument("--input-cfg", metavar="json-file", help="Input JSON file containing lens and camera settings of the input images.")
    g.add_argument("--output-cfg", metavar="json-file", help="Output JSON file containing lens and camera settings of the output images.")
    g.add_argument("--no-configs", metavar="width,height", help="Work without reading and writing config files. Requires the input lens through the -i-... flags and the input resolution here.")
    g.add_argument("-i", "--input-dir", metavar="file", help="Input directory containing images to reproject.")
    g.add_argument("--single", metavar="file", help="A single input file to convert.")
    g.add_argument("-o", "--output-dir", metavar="file", help="Output directory to put the reprojected images.")
    g.add_argument("--exr", action="store_true", help="Output EXR files. Color and depth.")
    g.add_argument("--png", action="store_true", help="Output PNG files. Color only.")

    g = p.add_argument_group("Filter files")
    g.add_argument("--filter-prefix", default="", metavar="prefix", help="Only include files starting with")
    g.add_argument("--filter-suffix", default="", metavar="suffix", help="Only include files ending with")

    g = p.add_argument_group("Sampling")
    g.add_argument("-s", "--samples", type=int, default=1, metavar="number", help="Number of samples per dimension for interpolating")
    g.add_argument("--nn", action="store_true", help="Nearest neighbor interpolation")
    g.add_argument("--bl", action="store_true", help="Bilinear interpolation")
    g.add_argument("--bc", action="store_true", help="Bicubic interpolation (default)")
    g.add_argument("--scale", type=float, default=1.0, metavar="percentage", help="Output scale, as a fraction of the input size.")
    g.add_argument("--output-resolution", metavar="width,height", help="A fixed output resolution. Overwrites the behavior of the 'scale' parameter.")

    g = p.add_argument_group("Input optics")
    g.add_argument("--i-rectilinear", metavar="focal_length,sensor_width")
    g.add_argument("--i-equisolid", metavar="focal_length,sensor_width,fov")
    g.add_argument("--i-equidistant", metavar="fov")
    g.add_argument("--i-stereographic", metavar="focal_length,sensor_width,fov", help="(extension)")
    g.add_argument("--i-equirectangular", metavar="long_min,long_max,lat_min,lat_max (radians)")

    g = p.add_argument_group("Output optics")
    g.add_argument("--no-reproject", action="store_true", help="Do not reproject at all.")
    g.add_argument("--rectilinear", metavar="focal_length,sensor_width")
    g.add_argument("--equisolid", metavar="focal_length,sensor_width,fov")
    g.add_argument("--equidistant", metavar="fov")
    g.add_argument("--stereographic", metavar="focal_length,sensor_width,fov", help="(extension)")
    g.add_argument("--equirectangular", metavar="longitude_min,longitude_max,latitude_min,latitude_max")
    g.add_argument("--rotation", default="0.0", metavar="pan,pitch,roll (degrees)", help="Specify a rotation")

    g = p.add_argument_group("Color processing")
    g.add_argument("--exposure", type=float, default=0.0, metavar="EV", help="Exposure compensation in stops (EV).")
    g.add_argument("--reinhard", type=float, default=1.0, metavar="max", help="Reinhard tonemapping with given maximum value.")

    g = p.add_argument_group("Runtime")
    g.add_argument("--skip-if-exists", action="store_true", help="Skip if the output file already exists.")
    g.add_argument("-j", "--parallel", type=int, default=1, metavar="threads", help="Number of parallel images to process.")
    g.add_argument("--dry-run", action="store_true", help="Do not actually reproject images. Only produce config.")

    g = p.add_argument_group("Device runtime (framework extensions)")
    g.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device the remap runs on. cuda runs the CUDA kernel and "
                        "fails without a GPU; cpu runs the plain PyTorch path.")
    g.add_argument("--batch-size", type=int, default=1, metavar="N", help="Images per device dispatch.")
    g.add_argument("--trace-dir", metavar="dir", help="Write a torch.profiler trace here.")
    g.add_argument("--pure-torch", action="store_true", help="Run the plain PyTorch path in place of the CUDA kernel.")
    g.add_argument("--json-log", action="store_true", help="Machine-readable JSON progress lines.")
    g.add_argument("--ordering", choices=("overlap", "serial"), default="overlap",
                   help="Stage ordering: 'overlap' pipelines decode/device/"
                        "encode across host threads; 'serial' completes each "
                        "frame before the next.")
    return p


def _parse_wh(arg: str, what: str) -> Tuple[int, int]:
    parts = arg.split(",")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        raise CliError(f"Error: Specify both width and height, separated by a comma in {what}.")
    return int(parts[0]), int(parts[1])


def _resolve_input_lens(args, ires_x: int, ires_y: int) -> LensSpec:
    found = []
    if args.i_rectilinear:
        found.append(parse_rectilinear(args.i_rectilinear, ires_x, ires_y))
    if args.i_equisolid:
        found.append(parse_equisolid(args.i_equisolid, ires_x, ires_y))
    if args.i_equidistant:
        found.append(parse_equidistant(args.i_equidistant, ires_x, ires_y))
    if args.i_stereographic:
        found.append(parse_stereographic(args.i_stereographic, ires_x, ires_y))
    if args.i_equirectangular:
        found.append(parse_equirectangular(args.i_equirectangular, ires_x, ires_y))
    if len(found) > 1:
        raise CliError(
            "Error: only specify one input lens type: [--i-rectilinear, "
            "--i-equisolid, --i-equidistant, --i-stereographic, "
            "--i-equirectangular]."
        )
    if not found:
        raise CliError("Error: No input lens specified (use --i-... flags with --no-configs).")
    return found[0]


def _resolve_output_lens(args, ores_x: int, ores_y: int, input_lens: LensSpec) -> LensSpec:
    found = []
    if args.rectilinear:
        found.append(parse_rectilinear(args.rectilinear, ores_x, ores_y))
    if args.equisolid:
        found.append(parse_equisolid(args.equisolid, ores_x, ores_y))
    if args.equidistant:
        found.append(parse_equidistant(args.equidistant, ores_x, ores_y))
    if args.stereographic:
        found.append(parse_stereographic(args.stereographic, ores_x, ores_y))
    if args.equirectangular:
        found.append(parse_equirectangular(args.equirectangular, ores_x, ores_y))
    if args.no_reproject:
        found.append(input_lens)
    if len(found) > 1:
        raise CliError(
            "Error: only specify one output lens type: [--rectilinear, "
            "--equisolid, --equidistant, --stereographic, "
            "--equirectangular, --no-reproject]."
        )
    if not found:
        raise CliError("Error: No output lens specified.")
    return found[0]


def _check_device(device: str) -> None:
    """--device cuda needs a GPU: fail rather than carry on on the CPU."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda (the default) but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain PyTorch path on the CPU"
        )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except CliError as e:
        print(str(e))
        return 1


def _run(args) -> int:
    # Input source validation (src/main.cpp:280-293).
    if args.input_dir and args.single:
        raise CliError("Error: cannot specify both --input-dir and --single.")
    if not args.input_dir and not args.single:
        raise CliError("Error: No input specified.")
    if not args.output_dir:
        raise CliError("Error: No output directory specified.")

    if not args.exr and not args.png:
        raise CliError(
            "Error: Did not specify any output format.\n"
            "Choose --png or --exr. (both are possible)."
        )

    # Interpolation (src/main.cpp:359-376): default bicubic. On conflicting
    # flags the reference prints the error + help but CONTINUES with the
    # last flag it processed (nn -> bl -> bc order) — match that verbatim.
    n_interp = sum([args.nn, args.bl, args.bc])
    if n_interp > 1:
        print("Cannot specify more than one interpolation method.\n")
        build_parser().print_help()
    interp = "nearest" if args.nn else "bicubic"
    if args.bl:
        interp = "bilinear"
    if args.bc:
        interp = "bicubic"

    # Output resolution: --output-resolution > --scale (src/main.cpp:297-310).
    # The reference's `scale` stays 0.0 whenever --output-resolution is
    # given (only the else-branch reads the flag, main.cpp:308-310), so the
    # --no-reproject plain-copy fast path (scale==1.0) never fires then and
    # the image is resampled to the requested W,H.
    ores_x = ores_y = 0
    scale = 0.0
    if args.output_resolution:
        ores_x, ores_y = _parse_wh(args.output_resolution, "output-resolution")
    else:
        scale = args.scale

    rotation = parse_rotation(args.rotation)
    if is_identity(rotation):
        rotation = None  # identical results, skips the fused 3x3 multiply

    exposure = math.pow(2.0, args.exposure)
    reinhard = args.reinhard

    # Lens resolution: --no-configs vs config JSON (src/main.cpp:386-443).
    out_cfg = None
    if args.no_configs:
        ires_x, ires_y = _parse_wh(args.no_configs, "no-configs")
        input_lens = _resolve_input_lens(args, ires_x, ires_y)
    else:
        if not args.input_cfg or not args.output_cfg:
            raise CliError("Error: need --input-cfg and --output-cfg (or --no-configs).")
        cfg = config_mod.load_config(args.input_cfg)
        out_cfg = dict(cfg)  # unknown keys pass through (src/main.cpp:437)
        import json as _json

        print("Found camera config: " + _json.dumps(cfg["camera"], indent=1))
        ires_x = int(cfg["resolution"][0])
        ires_y = int(cfg["resolution"][1])
        input_lens = config_mod.extract_lens_info_from_config(cfg)

    if ores_x == 0 and ores_y == 0:
        ores_x = int(ires_x * scale)
        ores_y = int(ires_y * scale)

    output_lens = _resolve_output_lens(args, ores_x, ores_y, input_lens)

    print(f"Creating directory: {args.output_dir}")
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)

    # Config round-trip (src/main.cpp:497-529).
    if out_cfg is not None:
        config_mod.store_lens_info_in_config(output_lens, out_cfg)
        out_cfg.setdefault("resolution", [0, 0])
        out_cfg["resolution"][0] = ores_x
        out_cfg["resolution"][1] = ores_y
        config_mod.filter_frames(out_cfg, args.filter_prefix, args.filter_suffix)
        print(f"Saving output config: {args.output_cfg}")
        config_mod.save_config(args.output_cfg, out_cfg)

    if args.dry_run:
        print("Dry-run. Exiting.")
        return 0

    _check_device(args.device)

    if args.trace_dir:
        tracing.start_trace(args.trace_dir)

    # Unconditional: a run without --pure-torch must reset a switch left
    # set by a previous in-process invocation (tests, library embedding).
    dispatch.set_pure_torch(args.pure_torch)

    opts = PipelineOptions(
        input_lens=input_lens,
        output_lens=output_lens,
        out_width=ores_x,
        out_height=ores_y,
        interp=interp,
        n_samples=args.samples,
        rotation=rotation,
        exposure=exposure,
        reinhard=reinhard,
        store_png=args.png,
        store_exr=args.exr,
        skip_if_exists=args.skip_if_exists,
        do_reproject=not args.no_reproject,
        scale=scale,
        num_threads=args.parallel,
        batch_size=args.batch_size,
        json_log=args.json_log,
        device=args.device,
        ordering=args.ordering,
    )

    if args.input_dir:
        paths = discover_files(args.input_dir, args.filter_prefix, args.filter_suffix)
    else:
        paths = [Path(args.single)]

    try:
        run_pipeline(paths, args.output_dir, opts)
    finally:
        if args.trace_dir:
            tracing.stop_trace()
    report = tracing.zone_report()
    if report:
        print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
