"""The ``--pure-torch`` switch.

By default a CUDA tensor goes to kernel B1 and a CPU tensor to the plain
path. With the switch set, the plain path (``ops/remap.py``) runs on
whatever device the tensor lies on: the way to debug the kernel on the
card, as ``--pure-xla`` is in the JAX package.
"""

from __future__ import annotations

_pure_torch = False


def set_pure_torch(value: bool) -> None:
    global _pure_torch
    _pure_torch = bool(value)


def pure_torch_forced() -> bool:
    return _pure_torch
