"""BASELINE remap configurations 1-4 at their published widths.

The four single-frame configurations of the JAX package's benchmark
(``bench/baseline_configs.py:141-158``, ``BASELINE.json``), as this
package's lenses and remap keyword arguments. Config 3 is the headline: a
full equirectangular 4K frame to a rectilinear 4K view, bicubic, rotated,
with exposure and extended Reinhard; ``chip_smoke.py`` also drives it
through the CLI. Kept here, not imported from ``bench/``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import math

from .models import lens as L
from .models.rotation import rotation_matrix_degrees

# The headline (config 3): source and output shapes, rotation (degrees),
# exposure in EV (a factor of 2 ** EXPOSURE_EV) and the Reinhard white point.
SRC_H, SRC_W, OUT_H, OUT_W = 1920, 3840, 2160, 3840
ROTATION = (20.0, 5.0, 0.0)
EXPOSURE_EV, REINHARD = 1.0, 4.0


def configs():
    """name -> (source shape (H, W, C), remap keyword arguments, rotation
    matrix or None)."""
    equisolid = L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)
    return {
        "1": ((1080, 1080, 3), dict(
            in_lens=L.FisheyeEquidistant(math.pi, 36.0, 36.0),
            out_lens=L.Rectilinear(35.0, 36.0, 36.0 * 1080 / 1920),
            out_h=1080, out_w=1920, interp="bilinear"), None),
        "2": ((2048, 2048, 3), dict(
            in_lens=equisolid, out_lens=L.full_equirectangular(),
            out_h=2048, out_w=4096, interp="bilinear"), rotation_matrix_degrees(30.0, 10.0, 5.0)),
        "3": ((SRC_H, SRC_W, 3), dict(
            in_lens=L.full_equirectangular(),
            out_lens=L.Rectilinear(35.0, 36.0, 36.0 * OUT_H / OUT_W),
            out_h=OUT_H, out_w=OUT_W, interp="bicubic",
            exposure=2.0 ** EXPOSURE_EV, reinhard=REINHARD), rotation_matrix_degrees(*ROTATION)),
        "4": ((2048, 2048, 4), dict(
            in_lens=L.Rectilinear(50.0, 36.0, 36.0), out_lens=equisolid,
            out_h=2048, out_w=2048, interp="bilinear"), None),
    }
