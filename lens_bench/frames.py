"""Seeded source frames, made on the device in a few large calls.

A frame is smooth structure (per channel 0.5 plus a sum of three plane
waves, 0.4 in all) plus seeded per-pixel noise of 1 % amplitude
(+/- 0.01). The noise matters: the cost of the EXR ZIP codec depends on
content, and smooth sums of sines alone make zlib unusually slow. The
waves' frequencies and amplitudes are one fixed set, dealt out to frames
and channels in an order drawn from the seed; the seed also draws their
phases and the noise. So every seed gives the same sizes and the same
kind of content, and the codec's work varies little from seed to seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WAVES = 3
NOISE = 0.01


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    return g


def make(n: int, h: int, w: int, c: int, seed: int, device) -> torch.Tensor:
    """(n, h, w, c) float32 frames on ``device`` from ``seed``."""
    g = generator(seed, device)
    fixed = np.random.default_rng(0).random((n * c * WAVES, 3))
    order = torch.randperm(n * c * WAVES, generator=g, device=device).cpu().numpy()
    phases = torch.rand(n * c * WAVES, generator=g, device=device,
                        dtype=torch.float64).cpu().numpy()
    params = np.concatenate([fixed[order], phases[:, None]], 1).reshape(n, c, WAVES, 4).tolist()
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=device)
    yy = torch.linspace(0.0, 1.0, h, device=device, dtype=torch.float32)[:, None]
    xx = torch.linspace(0.0, 1.0, w, device=device, dtype=torch.float32)[None, :]
    for i in range(n):
        for ch in range(c):
            acc = torch.full((h, w), 0.5, dtype=torch.float32, device=device)
            for k in range(WAVES):
                fx, fy, amp, phase = params[i][ch][k]
                acc += (0.4 / WAVES) * (0.5 + 0.5 * amp) * torch.sin(
                    (2 * math.pi) * ((0.5 + 3.5 * fx) * xx + (0.5 + 3.5 * fy) * yy) + 6.3 * phase)
            out[i, :, :, ch] = acc
        noise = torch.rand((h, w, c), generator=g, device=device, dtype=torch.float32)
        out[i] += NOISE * (2.0 * noise - 1.0)
    return out
