"""Fused remap + tonemap: the port's entry points for the remap.

``remap_tonemap_batch`` sends a CUDA tensor to kernel B1 and a CPU tensor to
the plain path (``ops/cuda/remap_kernel.py`` makes that choice from the
tensor's device). With ``dispatch.set_pure_torch(True)`` (CLI
``--pure-torch``) the plain path runs on whatever device the tensor lies.
"""

from __future__ import annotations

import torch

from ..models.lens import LensSpec
from . import dispatch
from .cuda import remap_kernel


def remap_tonemap_batch(
    batch: torch.Tensor,
    rotation,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C), remap + optional tonemap."""
    fn = (
        remap_kernel.remap_tonemap_plain
        if dispatch.pure_torch_forced()
        else remap_kernel.remap_tonemap
    )
    return fn(
        batch, rotation, in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
        interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
    )


def remap_tonemap(src: torch.Tensor, rotation, **kwargs) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C); see remap_tonemap_batch."""
    if src.ndim != 3:
        raise ValueError(f"remap_tonemap takes (H, W, C), got {tuple(src.shape)}")
    return remap_tonemap_batch(src.unsqueeze(0).contiguous(), rotation, **kwargs)[0]
