"""image_lens_reproject_torch — the PyTorch + CUDA port of image_lens_reproject_tpu.

Reprojects images between lens models (rectilinear, fisheye, equirect)
with rotation, supersampling, interpolation and exposure/Reinhard
tonemapping. The JAX package beside it is the reference this port is held
against; this package never imports it nor JAX.

Layout (same module names as the JAX package):
    models/    lens specs, pixel<->ray projection math, rotation
    ops/       plain-PyTorch remap, samplers, color; ops/cuda/ holds the
               wrappers of the hand-written kernels in csrc/
    io/        EXR / PNG / JPEG codecs (host side)
    utils/     Blender JSON config, tracing, native codec loader
    pipeline   batch orchestrator (discovery, decode, device dispatch, encode)
    cli        argparse CLI mirroring the JAX package's flags
"""

from .models.lens import (  # noqa: F401
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    LensType,
    Rectilinear,
    full_equirectangular,
)
from .models.rotation import rotation_matrix, rotation_matrix_degrees  # noqa: F401
from .ops.remap_fused import remap_tonemap, remap_tonemap_batch  # noqa: F401

__version__ = "0.1.0"
