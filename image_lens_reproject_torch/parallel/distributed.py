"""Multi-process initialization and the mesh that spans processes.

PyTorch port of the JAX package's ``parallel/distributed.py``: one process
per device, joined by ``torch.distributed`` (NCCL between cards, gloo when
the caller asks for the CPU), and a global mesh with one position per
rank. The one-call entry point for a multi-process run:

    from image_lens_reproject_torch.parallel import distributed
    distributed.init()                  # no-op outside torchrun
    mesh = distributed.global_mesh(rows=2)

``init`` reads torchrun's environment (``MASTER_ADDR``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) where the JAX package read the TPU pod's;
explicit arguments support a cluster started by hand.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

_TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
    timeout: float = 300.0,
) -> bool:
    """Join the process group when running multi-process; else no-op.

    With ``coordinator_address`` (``host:port``) the group is the one
    given by the arguments; without it, torchrun's environment, unless
    ``ILR_DISTRIBUTED=0``. ``device="cuda"`` joins with NCCL and makes
    ``cuda:LOCAL_RANK`` this process's device; ``"cpu"`` joins with gloo.
    ``timeout`` (seconds) bounds the wait for the coordinator and every
    collective. Returns True if more than one process is in the group.
    A coordinator that cannot be joined returns False, as in the JAX
    package, with its error printed to stderr.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None
    env = all(v in os.environ for v in _TORCHRUN_ENV)
    if not (explicit or (env and os.environ.get("ILR_DISTRIBUTED", "1") != "0")):
        return False
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if explicit:
        method = f"tcp://{coordinator_address}"
        world = int(num_processes if num_processes is not None else 1)
        rank = int(process_id if process_id is not None else 0)
    else:
        method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device == "cuda":
        torch.cuda.set_device(local_rank())
    try:
        dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=method,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
    except (RuntimeError, ValueError, OSError) as e:
        print(f"distributed.init: cannot join the process group at {method} as rank "
              f"{rank} of {world}: {e}", file=sys.stderr)
        return False
    return dist.get_world_size() > 1


def local_rank() -> int:
    """This process's device index on its host (torchrun's ``LOCAL_RANK``; 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def global_mesh(batch: Optional[int] = None, rows: Optional[int] = None) -> Mesh:
    """Mesh over every process's device, one position per rank: position
    (i, j) is rank ``i * rows + j``. Every rank must call it, in the same
    order: it creates each batch row's process group, which
    ``dist.new_group`` requires of all ranks. Without a process group it is
    a one-position mesh of this process's device."""
    gloo = dist.is_initialized() and dist.get_backend() == "gloo"
    mine = torch.device("cpu") if gloo else torch.device("cuda", local_rank())
    if not dist.is_initialized():
        return make_mesh(devices=[mine], batch=batch, rows=rows)
    world = dist.get_world_size()
    devices = [None] * world
    dist.all_gather_object(devices, str(mine))
    shape = make_mesh(devices=devices, batch=batch, rows=rows)
    b, r = len(shape.devices), len(shape.devices[0])
    ranks = tuple(tuple(i * r + j for j in range(r)) for i in range(b))
    groups = tuple(dist.new_group(ranks=list(row)) for row in ranks)
    return Mesh(shape.devices, ranks=ranks, row_groups=groups)


def world_size() -> int:
    """The processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a batch dimension split evenly over the processes."""
    per = global_batch // world_size()
    start = process_index() * per
    return slice(start, start + per)
