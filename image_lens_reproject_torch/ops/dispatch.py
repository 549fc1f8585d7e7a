"""The ``--pure-torch``, ``--rescue`` and ``--split`` switches.

By default a CUDA tensor goes to kernel B1 and a CPU tensor to the plain
path. With ``--pure-torch`` set, the plain path (``ops/remap.py``) runs on
whatever device the tensor lies on: the way to debug the kernels on the
card, as ``--pure-xla`` is in the JAX package.

``--rescue`` and ``--split`` select the planned path
(``remap_fused.remap_tonemap_planned_batch``), after the JAX package's
``ops/dispatch.py``. There auto meant "on with on-chip verification
markers"; the port keeps no markers, so auto means off. As in JAX, split
takes effect only when rescue is on (the pipeline asks for both).
"""

from __future__ import annotations

from typing import Optional

_pure_torch = False
_rescue_override: Optional[bool] = None  # None = auto
_split_override: Optional[bool] = None  # None = auto


def set_pure_torch(value: bool) -> None:
    global _pure_torch
    _pure_torch = bool(value)


def pure_torch_forced() -> bool:
    return _pure_torch


def set_rescue_override(value: Optional[bool]) -> None:
    """CLI --rescue on|off|auto -> True|False|None."""
    global _rescue_override
    _rescue_override = value


def rescue_enabled() -> bool:
    """Should the pipeline take the planned path (kernel B2's sub-tile lists)?"""
    return bool(_rescue_override)


def set_split_override(value: Optional[bool]) -> None:
    """CLI --split on|off|auto -> True|False|None."""
    global _split_override
    _split_override = value


def split_enabled() -> bool:
    """Should the plan give B2's split mode its list? Read only with rescue on."""
    return bool(_split_override)
