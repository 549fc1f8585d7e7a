"""The reprojection remap in plain PyTorch: the port's plain path.

PyTorch port of the JAX package's ``ops/remap.py`` (reference
src/reproject.cpp:273-346): a dense coordinate field (pixel -> ray ->
rotate -> source pixel) followed by a gather-interpolate. It runs on any
device; the CPU tests run it, and it is the plain version that kernel B1
(``csrc/remap_kernel.cu``) is held against on the card.

Supersampling (reference src/reproject.cpp:294-341): n x n stratified
sub-pixel offsets ``(ss+1)/(n+1) - 0.5``, off_x outer and off_y inner,
summed and then multiplied by 1/n².
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models import projections
from ..models.lens import LensSpec, wrap_mode_for_input
from . import sampling

Tensor = torch.Tensor


def supersample_offsets(n_samples: int) -> List[float]:
    """Stratified sub-pixel offsets (reference src/reproject.cpp:295, 298), float32-rounded."""
    return [float(np.float32((ss + 1.0) / (n_samples + 1.0) - 0.5)) for ss in range(n_samples)]


def rotation_tensor(rotation, device: torch.device) -> Optional[Tensor]:
    """A (3, 3) rotation (numpy or tensor) as float32 on ``device``; None stays None."""
    if rotation is None:
        return None
    r = torch.as_tensor(rotation, dtype=torch.float32, device=device)
    if r.shape != (3, 3):
        raise ValueError(f"rotation must be (3, 3), got {tuple(r.shape)}")
    return r


def source_coords(
    in_lens: LensSpec,
    out_lens: LensSpec,
    in_h: int,
    in_w: int,
    scx: Tensor,
    scy: Tensor,
    rotation: Optional[Tensor],
    out_h: int,
    out_w: int,
):
    """Output-pixel-centered coords -> top-left-aligned source coords.

    The straight-line pipeline of the reference's inner loop body
    (src/reproject.cpp:300-324): unproject, rotate, project, shift.
    """
    vx, vy, vz = projections.target_to_vec(out_lens, float(out_w), float(out_h), scx, scy)
    if rotation is not None:
        r = rotation
        nx = r[0, 0] * vx + r[0, 1] * vy + r[0, 2] * vz
        ny = r[1, 0] * vx + r[1, 1] * vy + r[1, 2] * vz
        nz = r[2, 0] * vx + r[2, 1] * vy + r[2, 2] * vz
        vx, vy, vz = nx, ny, nz
    sx, sy = projections.vec_to_source(in_lens, float(in_w), float(in_h), vx, vy, vz)
    sx = (sx - 0.5) + float(np.float32(in_w * 0.5))
    sy = (sy - 0.5) + float(np.float32(in_h * 0.5))
    return sx, sy


def remap_batch(
    batch: Tensor,
    rotation,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
) -> Tensor:
    """Reproject ``(..., H_in, W_in, C)`` to ``(..., out_h, out_w, C)``.

    The leading dims are a batch: one coordinate field serves all of its
    images. ``rotation`` is a (3, 3) float32 matrix or None to skip the
    rotate stage (the reference multiplies by identity; results are equal).
    """
    device = batch.device
    in_h, in_w = int(batch.shape[-3]), int(batch.shape[-2])
    wrap = wrap_mode_for_input(in_lens)
    rot = rotation_tensor(rotation, device)

    # Pixel centers, image centered on (0, 0) (src/reproject.cpp:287-288).
    cx = (torch.arange(out_w, dtype=torch.float32, device=device) + 0.5) - float(
        np.float32(out_w * 0.5)
    )
    cy = (torch.arange(out_h, dtype=torch.float32, device=device) + 0.5) - float(
        np.float32(out_h * 0.5)
    )
    cx = cx[None, :]
    cy = cy[:, None]

    offsets = supersample_offsets(n_samples)
    acc = None
    for off_x in offsets:
        for off_y in offsets:
            sx, sy = source_coords(
                in_lens, out_lens, in_h, in_w, cx + off_x, cy + off_y, rot, out_h, out_w
            )
            tap = sampling.sample(batch, sx, sy, interp, wrap)
            acc = tap if acc is None else acc + tap
    return acc * float(np.float32(1.0 / (n_samples * n_samples)))


def remap_image(src: Tensor, rotation, **kwargs) -> Tensor:
    """Reproject one ``(H_in, W_in, C)`` image to ``(out_h, out_w, C)``; see remap_batch."""
    if src.ndim != 3:
        raise ValueError(f"remap_image takes (H, W, C), got {tuple(src.shape)}")
    return remap_batch(src, rotation, **kwargs)
