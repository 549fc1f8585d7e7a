from .lens import (  # noqa: F401
    Equirectangular,
    FisheyeEquidistant,
    FisheyeEquisolid,
    FisheyeStereographic,
    LensSpec,
    LensType,
    Rectilinear,
    from_reference,
    full_equirectangular,
    wrap_mode_for_input,
)
from .rotation import rotation_matrix, rotation_matrix_degrees  # noqa: F401
