"""Blender-style JSON camera config extract / store / round-trip.

Reference: src/config.cpp:7-106 and the config-driver portion of main
(src/main.cpp:429-529). Unknown keys pass through verbatim (the output
config starts as a copy of the input JSON), ``frames[]`` is filtered by
prefix/suffix, and the lens block is rewritten.

Replicated quirks (SURVEY.md §2.1):
* storing an equirectangular lens writes ``panorama_type: "RECTILINEAR"``
  (src/config.cpp:98) — the reference's own extractor would not re-read it;
* storing a rectilinear lens synthesizes a 4x4 projection_matrix with
  invented near=0.1 / far=100 planes (src/config.cpp:69-83);
* a PERSP camera with ``lens_unit: FOV`` derives
  ``f = sensor_w / tan(angle/2)`` and prints the same warning
  (src/config.cpp:41-48).
"""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Dict

from ..models.lens import (
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    Rectilinear,
)


def extract_lens_info_from_config(cfg: Dict[str, Any]) -> LensSpec:
    """Parse a Blender-addon camera JSON into a LensSpec.

    Mirrors src/config.cpp:7-56 including its failure modes:
    raises ValueError (the analog of std::invalid_argument) on unknown
    camera_type / lens_unit; an unknown PANO panorama_type falls through
    and produces an error here too (the reference would return an
    uninitialized LensInfo — undefined behavior we do not reproduce).
    """
    camera_cfg = cfg["camera"]
    camera_type = camera_cfg["type"]

    sensor_width = float(cfg["sensor_size"][0])
    sensor_height = float(cfg["sensor_size"][1])

    if camera_type == "PANO":
        pano_type = camera_cfg["panorama_type"]
        if pano_type == "FISHEYE_EQUIDISTANT":
            return FisheyeEquidistant(
                fov=float(camera_cfg["fisheye_fov"]),
                sensor_width=sensor_width,
                sensor_height=sensor_height,
            )
        if pano_type == "FISHEYE_EQUISOLID":
            # The reference code reads "fisheye_lens" (src/config.cpp:26)
            # but its own README template documents the key as "lens"
            # (README.md equisolid example) — that template would crash
            # the reference. Accept both, code-key first.
            if "fisheye_lens" in camera_cfg:
                focal = float(camera_cfg["fisheye_lens"])
            else:
                focal = float(camera_cfg["lens"])
            return FisheyeEquisolid(
                focal_length=focal,
                fov=float(camera_cfg["fisheye_fov"]),
                sensor_width=sensor_width,
                sensor_height=sensor_height,
            )
        if pano_type == "FISHEYE_STEREOGRAPHIC":
            # Framework extension: the reference's enum names this type but
            # has no JSON mapping (src/config.hpp:11); we use the natural
            # Blender-style keys.
            return FisheyeStereographic(
                focal_length=float(camera_cfg["fisheye_lens"]),
                fov=float(camera_cfg["fisheye_fov"]),
                sensor_width=sensor_width,
                sensor_height=sensor_height,
            )
        if pano_type == "EQUIRECTANGULAR" or (
            # Gap-fix: the store quirk labels equirect output
            # panorama_type "RECTILINEAR" (src/config.cpp:98); the
            # reference cannot re-read its own output (uninitialized
            # LensInfo, UB). Accept it when the lat/long keys identify it,
            # so chained reprojections work.
            pano_type == "RECTILINEAR" and "longitude_min" in camera_cfg
        ):
            return Equirectangular(
                latitude_min=float(camera_cfg["latitude_min"]),
                latitude_max=float(camera_cfg["latitude_max"]),
                longitude_min=float(camera_cfg["longitude_min"]),
                longitude_max=float(camera_cfg["longitude_max"]),
                sensor_width=sensor_width,
                sensor_height=sensor_height,
            )
        raise ValueError(f"Unknown panorama_type: {pano_type}")

    if camera_type == "PERSP":
        lens_unit = camera_cfg["lens_unit"]
        if lens_unit == "MILLIMETERS":
            focal_length = float(camera_cfg["focal_length"])
        elif lens_unit == "FOV":
            angle = float(camera_cfg["angle"])
            print(
                "Warning: relying on 'angle' is unsafe. Angle is assumed "
                "to be based on the width of the sensor.",
                file=sys.stderr,
            )
            focal_length = sensor_width / math.tan(0.5 * angle)
        else:
            raise ValueError("Unknown lens_unit")
        return Rectilinear(
            focal_length=focal_length,
            sensor_width=sensor_width,
            sensor_height=sensor_height,
        )

    raise ValueError("Unknown camera_type")


def store_lens_info_in_config(lens: LensSpec, out_cfg: Dict[str, Any]) -> None:
    """Write a LensSpec into a config dict in place (src/config.cpp:58-106)."""
    out_cfg["camera"] = {}
    out_cfg.setdefault("sensor_size", [0.0, 0.0])
    out_cfg["sensor_size"][0] = lens.sensor_width
    out_cfg["sensor_size"][1] = lens.sensor_height
    cam = out_cfg["camera"]

    if isinstance(lens, Rectilinear):
        cam["type"] = "PERSP"
        cam["lens_unit"] = "MILLIMETERS"
        cam["focal_length"] = lens.focal_length
        # Synthesized projection matrix with invented near/far planes
        # (src/config.cpp:69-83).
        near, far = 0.1, 100.0
        proj = [[0.0] * 4 for _ in range(4)]
        proj[0][0] = 2.0 * lens.focal_length / lens.sensor_width
        proj[1][1] = 2.0 * lens.focal_length / lens.sensor_height
        proj[2][2] = -(far + near) / (far - near)
        proj[2][3] = -2.0 * far * near / (far - near)
        proj[3][2] = -1.0
        cam["projection_matrix"] = proj
    elif isinstance(lens, FisheyeEquisolid):
        cam["type"] = "PANO"
        cam["panorama_type"] = "FISHEYE_EQUISOLID"
        cam["fisheye_lens"] = lens.focal_length
        cam["fisheye_fov"] = lens.fov
    elif isinstance(lens, FisheyeStereographic):
        cam["type"] = "PANO"
        cam["panorama_type"] = "FISHEYE_STEREOGRAPHIC"
        cam["fisheye_lens"] = lens.focal_length
        cam["fisheye_fov"] = lens.fov
    elif isinstance(lens, FisheyeEquidistant):
        cam["type"] = "PANO"
        cam["panorama_type"] = "FISHEYE_EQUIDISTANT"
        cam["fisheye_fov"] = lens.fov
    elif isinstance(lens, Equirectangular):
        cam["type"] = "PANO"
        # Reference quirk (src/config.cpp:98): writes "RECTILINEAR" as the
        # panorama_type of an equirectangular lens. Replicated for
        # byte-level config parity.
        cam["panorama_type"] = "RECTILINEAR"
        cam["latitude_min"] = lens.latitude_min
        cam["latitude_max"] = lens.latitude_max
        cam["longitude_min"] = lens.longitude_min
        cam["longitude_max"] = lens.longitude_max
    else:
        raise ValueError("Unsupported lens type.")


def filter_frames(out_cfg: Dict[str, Any], filter_prefix: str, filter_suffix: str) -> None:
    """Filter the optional frames[] list in place (src/main.cpp:505-523)."""
    if "frames" not in out_cfg:
        return
    kept = []
    for frame in out_cfg["frames"]:
        name = frame["name"]
        if len(name) < len(filter_prefix) or len(name) < len(filter_suffix):
            continue
        if filter_prefix and not name.startswith(filter_prefix):
            continue
        if filter_suffix and not name.endswith(filter_suffix):
            continue
        kept.append(frame)
    out_cfg["frames"] = kept


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)


def save_config(path: str, cfg: Dict[str, Any]) -> None:
    """Write with indent=2, like the reference's dump(2) (src/main.cpp:527)."""
    with open(path, "w") as f:
        f.write(json.dumps(cfg, indent=2))
