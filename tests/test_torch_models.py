"""The port's lens specs and rotation against the JAX package's.

``models/lens.py`` and ``models/rotation.py`` are copies; ``from_reference``
carries a JAX-package lens across by class name and fields. Rotation
matrices cross as numpy arrays and must be equal bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from image_lens_reproject_tpu.models import lens as JL
from image_lens_reproject_tpu.models import rotation as JROT
from image_lens_reproject_torch.models import lens as TL
from image_lens_reproject_torch.models import rotation as TROT
from image_lens_reproject_torch.ops import remap as TR

REFERENCE_LENSES = [
    JL.Rectilinear(35.0, 36.0, 20.25),
    JL.FisheyeEquidistant(math.pi, 36.0, 36.0),
    JL.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0),
    JL.FisheyeStereographic(12.0, 3.0, 36.0, 24.0),
    JL.full_equirectangular(),
    JL.Equirectangular(-2.0, 1.5, -1.2, 1.0),
]


@pytest.mark.parametrize("ref", REFERENCE_LENSES, ids=lambda s: type(s).__name__)
def test_from_reference_carries_every_field(ref):
    got = TL.from_reference(ref)
    assert type(got).__module__ == TL.__name__
    assert type(got).__name__ == type(ref).__name__
    assert got.type.value == ref.type.value
    for name in ref.__dataclass_fields__:
        assert getattr(got, name) == getattr(ref, name)
    if isinstance(ref, JL.Equirectangular):
        assert TL.wrap_mode_for_input(got) == JL.wrap_mode_for_input(ref)
        assert got.longitude_span == ref.longitude_span


def test_from_reference_rejects_other_objects():
    with pytest.raises(ValueError, match="Not a lens spec"):
        TL.from_reference(object())


def test_full_equirectangular_equal():
    assert TL.full_equirectangular() == TL.from_reference(JL.full_equirectangular())


@pytest.mark.parametrize(
    "angles", [(0.0, 0.0, 0.0), (20.0, 5.0, 0.0), (30.0, 10.0, 0.0), (-45.0, 12.5, 7.0), (180.0, 0.0, 0.0)]
)
def test_rotation_bit_equal(angles):
    want = JROT.rotation_matrix_degrees(*angles)
    got = TROT.rotation_matrix_degrees(*angles)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert TROT.is_identity(got) == JROT.is_identity(want)
    t = TR.rotation_tensor(got, torch.device("cpu"))
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), want)


def test_rotation_tensor_checks_shape():
    assert TR.rotation_tensor(None, torch.device("cpu")) is None
    with pytest.raises(ValueError, match=r"\(3, 3\)"):
        TR.rotation_tensor(np.eye(4, dtype=np.float32), torch.device("cpu"))
