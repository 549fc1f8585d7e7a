"""Fused remap + tonemap: the port's entry points for the remap.

``remap_tonemap_batch`` sends a CUDA tensor to kernel B1 and a CPU tensor to
the plain path (``ops/cuda/remap_kernel.py`` makes that choice from the
tensor's device). ``remap_tonemap_planned_batch`` is the planned path of
``--rescue`` / ``--split``: the same output, filled list by list from a
plan of ``ops/plan.py`` by kernel B2 and B1's list mode, over the whole
frame or over a band of its rows (a mesh position's, from a band's plan).
``remap_tonemap`` and ``remap_tonemap_planned`` take one image. With
``dispatch.set_pure_torch(True)`` (CLI ``--pure-torch``) the plain versions
run on whatever device the tensor lies.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.lens import LensSpec
from . import dispatch, remap
from . import plan as plan_mod
from .cuda import remap_kernel, rescue_kernel


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
    row_offset: int = 0,
    row_count: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, W, C) -> (B, row_count, out_w, C), remap + optional tonemap.

    ``row_offset`` / ``row_count`` give a band of the ``out_h x out_w``
    frame's rows (B1's band mode); the defaults give the full frame.
    ``rotation``: None, one (3, 3) rotation, or a ``(V, 3, 3)`` stack, the
    view axis, which gives the full frame's ``(B, V, out_h, out_w, C)``:
    view v bit for bit the call with ``rotation[v]``, all views in one
    launch of B1 (a host stack by value; band mode refuses a stack).
    """
    fn = (
        remap_kernel.remap_tonemap_plain
        if dispatch.pure_torch_forced()
        else remap_kernel.remap_tonemap
    )
    return fn(
        batch, rotation, in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
        interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
        row_offset=row_offset, row_count=row_count,
    )


def remap_tonemap(src: torch.Tensor, rotation, **kwargs) -> torch.Tensor:
    """(H, W, C) -> (row_count, out_w, C), or (V, out_h, out_w, C) for a
    rotation stack; see remap_tonemap_batch."""
    if src.ndim != 3:
        raise ValueError(f"remap_tonemap takes (H, W, C), got {tuple(src.shape)}")
    return remap_tonemap_batch(src.unsqueeze(0).contiguous(), rotation, **kwargs)[0]


def remap_tonemap_planned_batch(
    batch: torch.Tensor,
    rotation,
    plan: plan_mod.Plan,
    *,
    misses: torch.Tensor,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
) -> torch.Tensor:
    """``remap_tonemap_batch``'s output, sub-tile list by sub-tile list.

    Named after the JAX package's ``remap_fused.remap_tonemap_planned_batch``.
    Kernel B2 fills the plan's rescue list, B2's split mode its split list
    (each in one launch a size class) and B1's list mode its direct list. Every pixel is computed once, by
    the same float32 operations as B1's, so the output equals
    ``remap_tonemap_batch``'s bit for bit. A plan of a band of rows
    (``Plan.band``) gives ``(B, band rows, out_w, C)``, equal to
    ``remap_tonemap_batch(row_offset, row_count)`` of that band, rows past
    ``out_h`` included. Reads outside a window add to ``misses`` (from
    ``rescue_kernel.new_misses``), which the caller must check once the
    output is back: a nonzero count means wrong pixels. A rotation stack
    (the view axis) raises ``ValueError``: a plan is made for one rotation.
    """
    remap.refuse_views(rotation, "the planned path")
    row_offset, row_count = plan.band
    plan_mod.check(plan, batch, out_h, out_w, row_offset, row_count)
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w,
              interp=interp, n_samples=n_samples, exposure=exposure, reinhard=reinhard,
              row_offset=row_offset, row_count=row_count)
    pure = dispatch.pure_torch_forced()
    windows = rescue_kernel.remap_windows_plain if pure else rescue_kernel.remap_windows
    direct = remap_kernel.remap_tonemap_list_plain if pure else remap_kernel.remap_tonemap_list
    out = torch.empty((batch.shape[0], row_count, out_w, batch.shape[3]), dtype=torch.float32,
                      device=batch.device)
    if plan.rescue.shape[0]:
        windows(batch, rotation, out, plan.rescue, split=False, misses=misses,
                classes=plan.rescue_classes, **kw)
    if plan.split.shape[0]:
        windows(batch, rotation, out, plan.split, split=True, misses=misses,
                classes=plan.split_classes, **kw)
    if plan.direct.shape[0]:
        direct(batch, rotation, out, plan.direct, **kw)
    return out


def remap_tonemap_planned(src: torch.Tensor, rotation, plan: plan_mod.Plan, **kwargs):
    """(H, W, C) -> (band rows, out_w, C); see remap_tonemap_planned_batch.

    The counterpart of the JAX package's one-image
    ``remap_fused.remap_tonemap_planned``, whose TPU prepass arrays a
    ``make_plan`` plan replaces.
    """
    if src.ndim != 3:
        raise ValueError(f"remap_tonemap_planned takes (H, W, C), got {tuple(src.shape)}")
    return remap_tonemap_planned_batch(src.unsqueeze(0).contiguous(), rotation, plan,
                                       **kwargs)[0]
