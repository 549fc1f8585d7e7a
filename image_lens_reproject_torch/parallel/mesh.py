"""Device mesh construction and the slices each mesh position holds.

PyTorch port of the JAX package's ``parallel/mesh.py``. The reference's
only scaling axis is image count on a CPU thread pool (src/main.cpp:
536-660); here the axes are:

* ``batch`` — data parallelism: images of a batch spread across devices;
* ``rows``  — intra-image spatial parallelism: the *output pixel grid* of
  each image is split into horizontal bands across devices (the equirect
  wraparound is handled by gathering full source rows).

A ``Mesh`` is a ``batch x rows`` grid of ``torch.device``s. Where JAX's
``NamedSharding`` lays an array over the mesh, ``input_slices`` and
``output_slices`` give each position its slices of a ``(B, H, W, C)``
array. A mesh built directly may name one device several times (as
JAX's tests name 8 virtual CPU devices); ``pipeline._resolve_mesh``
counts distinct devices, so the CLI never builds one. A mesh that spans
processes (``distributed.global_mesh``) also records each position's
rank and each batch row's process group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

BATCH_AXIS = "batch"
ROWS_AXIS = "rows"

Position = Tuple[int, int]
Index = Tuple[slice, slice]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``batch x rows`` grid of devices: ``devices[i][j]`` is position (i, j).

    ``ranks[i][j]``, when set, is the process that holds position (i, j),
    and ``row_groups[i]`` the process group of batch row i's positions
    (the group its source bands are gathered over).
    """

    devices: Tuple[Tuple[torch.device, ...], ...]
    ranks: Optional[Tuple[Tuple[int, ...], ...]] = None
    row_groups: Optional[tuple] = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {BATCH_AXIS: len(self.devices), ROWS_AXIS: len(self.devices[0])}

    def positions(self):
        """Every position (i, j), batch row by batch row."""
        b, r = self.shape[BATCH_AXIS], self.shape[ROWS_AXIS]
        return [(i, j) for i in range(b) for j in range(r)]

    def local_positions(self):
        """The positions this process holds: all of them in a one-process
        mesh, else those of this process's rank."""
        if self.ranks is None:
            return self.positions()
        rank = torch.distributed.get_rank()
        return [(i, j) for i, j in self.positions() if self.ranks[i][j] == rank]


def visible_devices(kind: str = "cuda"):
    """Every CUDA device of this process, or ``[cpu]`` for ``kind="cpu"``
    (the counterpart of ``jax.devices()``). Raises when there is no CUDA
    device: a CPU mesh is asked for, never fallen back to."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"kind must be 'cuda' or 'cpu', got {kind!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device visible; pass kind='cpu' for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    batch: Optional[int] = None,
    rows: Optional[int] = None,
) -> Mesh:
    """Build a (batch, rows) mesh over the given (or all visible CUDA) devices.

    With no explicit split, favors the batch axis (throughput) and keeps
    rows = 1; pass ``rows > 1`` to split each image's output rows.
    """
    devices = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devices)
    if batch is None and rows is None:
        batch, rows = n, 1
    elif batch is None:
        batch = n // rows
    elif rows is None:
        rows = n // batch
    if batch * rows != n or batch < 1 or rows < 1:
        raise ValueError(f"mesh {batch}x{rows} != {n} devices")
    return Mesh(tuple(tuple(devices[i * rows:(i + 1) * rows]) for i in range(batch)))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def input_slices(mesh: Mesh, shape) -> Dict[Position, Index]:
    """Each position's (batch, rows) slices of a ``(B, H, W, C)`` source:
    batch shard i's rows band j (JAX's ``input_sharding``). B must divide
    by the batch axis and H by the rows axis."""
    b, r = mesh.shape[BATCH_AXIS], mesh.shape[ROWS_AXIS]
    n, h = int(shape[0]), int(shape[1])
    if n % b or h % r:
        raise ValueError(f"a ({n}, {h}, ...) batch does not split over a {b}x{r} mesh")
    nb, band = n // b, h // r
    return {(i, j): (slice(i * nb, (i + 1) * nb), slice(j * band, (j + 1) * band))
            for i, j in mesh.positions()}


def output_slices(mesh: Mesh, shape) -> Dict[Position, Index]:
    """Each position's slices of a ``(B, out_h, out_w, C)`` output (JAX's
    ``output_sharding`` after the step's crop): batch shard i's rows
    ``[j * band, (j + 1) * band)`` with ``band = ceil(out_h / rows)``, cut
    at ``out_h`` (empty where a band starts past it)."""
    b, r = mesh.shape[BATCH_AXIS], mesh.shape[ROWS_AXIS]
    n, out_h = int(shape[0]), int(shape[1])
    if n % b:
        raise ValueError(f"a batch of {n} does not split over {b} batch shards")
    nb, band = n // b, -(-out_h // r)
    return {(i, j): (slice(i * nb, (i + 1) * nb),
                     slice(min(j * band, out_h), min((j + 1) * band, out_h)))
            for i, j in mesh.positions()}
