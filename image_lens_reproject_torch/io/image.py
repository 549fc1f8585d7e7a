"""Host-side image container and channel layouts.

Re-design of the reference's ``Image`` struct + ``DataLayout`` enum
(src/reproject.hpp:7-14): an interleaved float32 (H, W, C) numpy array
plus a layout tag. The lens is NOT stored on the image (unlike the
reference) — lens specs are static jit arguments and travel separately.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class DataLayout(enum.Enum):
    """Channel layouts (reference src/reproject.hpp:7).

    RGBZ packs depth Z in slot 3; RGBAZ packs alpha in 3, depth in 4.
    """

    RGB = 3
    RGBA = 4
    RGBZ = -4  # 4 channels, slot 3 is Z
    RGBAZ = 5

    @property
    def num_channels(self) -> int:
        return abs(self.value)




@dataclasses.dataclass
class ImageBuffer:
    """Interleaved float32 pixel buffer (H, W, C) + layout tag."""

    data: np.ndarray
    layout: DataLayout

    @property
    def height(self) -> int:
        return int(self.data.shape[0])

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def channels(self) -> int:
        return int(self.data.shape[2])

    def __post_init__(self):
        if self.data.ndim != 3:
            raise ValueError(f"ImageBuffer data must be (H, W, C); got {self.data.shape}")
        if self.data.dtype != np.float32:
            self.data = self.data.astype(np.float32)
