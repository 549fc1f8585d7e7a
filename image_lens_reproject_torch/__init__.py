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
    parallel/  (batch, rows) device mesh, sharded remap step, multi-process start-up
    pipeline   batch orchestrator (discovery, decode, device dispatch, encode)
    cli        argparse CLI mirroring the JAX package's flags

The top-level names follow the JAX package's, with two kinds of exception.
PyTorch runs eagerly, so the ``_jit`` names (``post_process_jit``,
``remap_jit``, ``remap_batch_jit``) have no counterpart. The JAX package's
``remap_tonemap_planned`` takes the TPU window prepass's ``scalars`` and
``bad`` arrays; the port has no prepass, and its ``remap_tonemap_planned``
takes a ``make_plan`` plan instead.
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
from .ops.color import post_process  # noqa: F401
from .ops.plan import make_plan  # noqa: F401
from .ops.remap import remap_image  # noqa: F401
from .ops.remap_fused import (  # noqa: F401
    remap_tonemap,
    remap_tonemap_batch,
    remap_tonemap_planned,
    remap_tonemap_planned_batch,
)

__version__ = "0.1.0"

__all__ = [
    "Equirectangular",
    "FisheyeEquidistant",
    "FisheyeEquisolid",
    "FisheyeStereographic",
    "LensSpec",
    "LensType",
    "Rectilinear",
    "full_equirectangular",
    "rotation_matrix",
    "rotation_matrix_degrees",
    "post_process",
    "remap_image",
    "make_plan",
    "remap_tonemap",
    "remap_tonemap_batch",
    "remap_tonemap_planned",
    "remap_tonemap_planned_batch",
]
