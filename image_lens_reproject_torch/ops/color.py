"""Color post-processing: exposure compensation + extended Reinhard tonemap.

Reference: src/reproject.cpp:421-437 (``post_process``). Applied per pixel
on at most the first 3 channels (alpha / depth are untouched,
``min(channels, 3)``). Kernel B1 (``csrc/remap_kernel.cu``) fuses the same
arithmetic into its epilogue; this is its plain version.

The exposure argument is a *linear* multiplier; the CLI converts stops to
linear via 2^EV (reference src/main.cpp:327). The tonemap is extended
Reinhard: v' = v (1 + v / max²) / (1 + v) with ``max`` the --reinhard
white point (src/reproject.cpp:430).
"""

from __future__ import annotations

import numpy as np
import torch


def needed(exposure: float, reinhard: float) -> bool:
    """The reference's guard (src/main.cpp:601-603): skip when both are 1."""
    return exposure != 1.0 or reinhard != 1.0


def post_process(img: torch.Tensor, exposure: float, reinhard: float) -> torch.Tensor:
    """Apply exposure + extended Reinhard to the first min(C, 3) channels.

    ``img``: (..., C) float32. Returns a new tensor.
    """
    ch = min(int(img.shape[-1]), 3)
    v = img[..., :ch] * float(np.float32(exposure))
    inv_max2 = float(np.float32(1.0 / (reinhard * reinhard)))
    v = v * (1.0 + v * inv_max2) / (1.0 + v)
    if ch == img.shape[-1]:
        return v
    return torch.cat([v, img[..., ch:]], dim=-1)
