"""The sharded remap step over a (batch, rows) mesh.

PyTorch port of the JAX package's ``parallel/batch.py``. A batch of source
images, cut over the mesh's positions, is reprojected and tonemapped into
a batch of outputs cut the same way. Each position computes a band of
output rows of its batch shard's images; the only communication is a
gather of source row bands along the ``rows`` axis, because a lens remap
reads the source anywhere (for a full-360 equirect input the horizontal
wrap lets any band read any source column), so the source is gathered
rather than halo-exchanged.

In one process the positions run one after another (their launches are
asynchronous, so positions on different cards overlap), and the gather is
``torch.cat`` of copies to the position's device. A mesh that spans
processes (``distributed.global_mesh``) gathers with ``dist.all_gather``
over each batch row's process group, and each process runs its own
position.

A position computes its band with B1's band mode, or, given the band's
plan (``band_plans``, the counterpart of JAX's ``size_rescue_cap``: one
plan a band of the rows axis, made at the band's rows), with the planned
path inside the band: kernel B2 on the band's rescue list and B1's list
mode on its direct list, as JAX runs K2 at each band's ``row0``. The two
give the same pixels bit for bit. As in JAX, a band takes no split list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.lens import LensSpec
from ..ops import plan as plan_mod
from ..ops import remap, remap_fused
from .mesh import ROWS_AXIS, Index, Mesh, Position, input_slices, output_slices


@dataclasses.dataclass
class ShardedBatch:
    """A ``(B, H, W, C)`` array laid over a mesh (JAX's sharded ``jax.Array``).

    ``shards[pos]`` is this process's position ``pos``'s part,
    ``global[slices[pos]]``, on the position's device.
    """

    shape: Tuple[int, int, int, int]
    mesh: Mesh
    slices: Dict[Position, Index]
    shards: Dict[Position, torch.Tensor]

    def assemble(self) -> torch.Tensor:
        """The whole array on the host. A mesh that spans processes gathers
        every position's part from its process first (every rank must call)."""
        if self.mesh.ranks is None:
            parts = self.shards
        else:
            parts = self._gather_parts()
        out = torch.empty(self.shape, dtype=next(iter(parts.values())).dtype)
        for pos, idx in self.slices.items():
            out[idx] = parts[pos].cpu()
        return out

    def _gather_parts(self) -> Dict[Position, torch.Tensor]:
        """Every position's part, from the process that holds it: each
        part padded to the largest slice, ``dist.all_gather`` over all ranks,
        then cut back to its slice."""
        positions = self.mesh.positions()
        if dist.get_world_size() != len(positions):
            raise ValueError(f"a {len(positions)}-position mesh over "
                             f"{dist.get_world_size()} processes")
        rows = {pos: idx[1].stop - idx[1].start for pos, idx in self.slices.items()}
        (mine,) = self.mesh.local_positions()
        local = self.shards[mine]
        padded = local.new_zeros((local.shape[0], max(rows.values())) + tuple(local.shape[2:]))
        padded[:, :rows[mine]] = local
        gathered = [torch.empty_like(padded) for _ in positions]
        dist.all_gather(gathered, padded)
        return {(i, j): gathered[self.mesh.ranks[i][j]][:, :rows[(i, j)]] for i, j in positions}


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> ShardedBatch:
    """Cut a host or device ``(B, H, W, C)`` batch into its ``(B/b, H/r, W, C)``
    pieces, each on its position's device (JAX's ``input_sharding``); in a
    mesh that spans processes, this process's pieces only."""
    slices = input_slices(mesh, batch.shape)
    shards = {(i, j): batch[slices[(i, j)]].to(mesh.devices[i][j]).contiguous()
              for i, j in mesh.local_positions()}
    return ShardedBatch(tuple(int(d) for d in batch.shape), mesh, slices, shards)


def _gather_rows(sharded: ShardedBatch, mesh: Mesh, i: int, j: int) -> torch.Tensor:
    """Batch shard i's whole source at position (i, j): its row bands from
    every position of batch row i, in row order."""
    device = mesh.devices[i][j]
    n_rows = mesh.shape[ROWS_AXIS]
    if mesh.ranks is None:
        bands = [sharded.shards[(i, k)].to(device) for k in range(n_rows)]
    elif n_rows == 1:
        bands = [sharded.shards[(i, j)]]
    else:
        local = sharded.shards[(i, j)]
        bands = [torch.empty_like(local) for _ in range(n_rows)]
        dist.all_gather(bands, local, group=mesh.row_groups[i])
    return bands[0] if n_rows == 1 else torch.cat(bands, dim=1)


def sharded_remap_step(
    sharded: ShardedBatch,
    rotation,
    *,
    mesh: Mesh,
    in_lens: LensSpec,
    out_lens: LensSpec,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    exposure: float = 1.0,
    reinhard: float = 1.0,
    in_h: Optional[int] = None,
    plans: Optional[Dict[Position, plan_mod.Plan]] = None,
    misses: Optional[Dict[Position, torch.Tensor]] = None,
) -> ShardedBatch:
    """(B, H, W, C) sharded batch -> (B, out_h, out_w, C) sharded outputs.

    B must divide by the mesh's ``batch`` axis and H by its ``rows`` axis.
    ``out_h`` need not divide: position (i, j) computes output rows
    ``[j * band, (j + 1) * band)`` with ``band = ceil(out_h / rows)`` for
    its whole local batch, and its part is cut at ``out_h``. Without
    ``plans``, in one launch of B1's band mode; with ``plans`` (from
    ``band_plans``), through the planned path inside the band, reads
    outside a window adding to ``misses[(i, j)]`` (a
    ``rescue_kernel.new_misses`` counter on the position's device, which
    the caller checks). Either way bit for bit the same pixels (the plain
    versions for a CPU tensor or under ``--pure-torch``). A source batch
    row-padded for the rows axis (the pipeline pads with edge-replicated
    rows for transport only) is cut back to ``in_h`` after the gather, so
    the lens geometry sees the true height. A rotation stack (the view
    axis) raises ``ValueError``: a position computes a band of rows.
    """
    remap.refuse_views(rotation, "the mesh step (sharded_remap_step)")
    if sharded.mesh != mesh:
        raise ValueError("the batch is sharded over another mesh")
    if (plans is None) != (misses is None):
        raise ValueError("plans and misses go together")
    band = -(-out_h // mesh.shape[ROWS_AXIS])
    if in_h is None:
        in_h = sharded.shape[1]
    out_shape = (sharded.shape[0], out_h, out_w, sharded.shape[3])
    slices = output_slices(mesh, out_shape)
    shards = {}
    for i, j in mesh.local_positions():
        full = _gather_rows(sharded, mesh, i, j)
        if full.shape[1] != in_h:
            full = full[:, :in_h].contiguous()
        kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w, interp=interp,
                  n_samples=n_samples, exposure=exposure, reinhard=reinhard)
        if plans is None:
            out = remap_fused.remap_tonemap_batch(full, rotation, row_offset=j * band,
                                                  row_count=band, **kw)
        else:
            plan = plans[(i, j)]
            plan_mod.check(plan, full, out_h, out_w, j * band, band)
            out = remap_fused.remap_tonemap_planned_batch(full, rotation, plan,
                                                          misses=misses[(i, j)], **kw)
        rows = slices[(i, j)][1]
        shards[(i, j)] = out[:, :rows.stop - rows.start]
    return ShardedBatch(out_shape, mesh, slices, shards)


def band_plans(
    mesh: Mesh,
    *,
    in_lens: LensSpec,
    out_lens: LensSpec,
    in_h: int,
    in_w: int,
    channels: int,
    out_h: int,
    out_w: int,
    interp: str = "bicubic",
    n_samples: int = 1,
    rotation=None,
) -> Dict[Position, plan_mod.Plan]:
    """The plan of each position's band, for ``sharded_remap_step(plans=...)``.

    The counterpart of JAX's ``size_rescue_cap``, which makes one prepass
    a band of the rows axis at ``row0 = r * band``: band j is planned at
    its own rows ``[j * band, (j + 1) * band)``, ``band = ceil(out_h /
    rows)``, with ``split=False`` (JAX's mesh step takes no split list).
    A plan's lists are tensors on the device it is made on, so each plan is
    made on its position's device, once for each (band, device): positions
    of one band on one device share it. A mesh that spans processes plans
    only this process's positions.
    """
    band = -(-out_h // mesh.shape[ROWS_AXIS])
    made: Dict[tuple, plan_mod.Plan] = {}
    plans = {}
    for i, j in mesh.local_positions():
        device = mesh.devices[i][j]
        if (j, device) not in made:
            made[(j, device)] = plan_mod.make_plan(
                rotation, in_lens=in_lens, out_lens=out_lens, in_h=in_h, in_w=in_w,
                channels=channels, out_h=out_h, out_w=out_w, interp=interp,
                n_samples=n_samples, split=False, device=device, row_offset=j * band,
                row_count=band)
        plans[(i, j)] = made[(j, device)]
    return plans
