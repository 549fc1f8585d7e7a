"""Kernel B1's wrapper (ops/cuda/remap_kernel.py) against the JAX package's K1.

K1 is the JAX package's main Pallas tile kernel (``remap_kernel.remap_pallas``
-> the ``pallas_call`` of ``_remap_pallas_one``). On the CPU it runs in
interpret mode, as the JAX package's own kernel tests run it; B1's wrapper
runs its plain PyTorch version, because the tensor lies on the CPU. The
CUDA kernel itself has no CPU mode: the tests that launch it carry the
``gpu`` marker and skip without a card.

The JAX package is imported inside the tests that compare with it, so that
the ``gpu`` tests of this file also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_remap_kernel.py``.
"""

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import remap, remap_fused, sampling
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts

F = np.float32

EQUIRECT = L.full_equirectangular()
PARTIAL = L.Equirectangular(-2.0, 1.5, -1.2, 1.0)
RECT = L.Rectilinear(35.0, 36.0, 27.0)


def smooth(h, w, c, seed=0):
    """The smooth test image of tests/test_pallas_kernel.py."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=F), np.linspace(0, 1, w, dtype=F), indexing="ij"
    )
    return np.stack(
        [0.5 + 0.45 * np.sin(4 * a * xx + 3 * b * yy + p) for a, b, p in rng.uniform(0.5, 2, (c, 3))],
        -1,
    ).astype(F)


@pytest.fixture
def interpret_k1():
    from image_lens_reproject_tpu.ops.pallas import remap_kernel as RK

    RK.set_interpret(True)
    yield RK
    RK.set_interpret(False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA only and this machine has no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def launches():
    """The launch counts (``build.COUNTS``) set to 0 for the test and
    restored after it."""
    saved = COUNTS.copy()
    reset_counts()
    yield
    reset_counts()
    COUNTS.update(saved)


def _reference(spec):
    """The JAX package's lens equal to ``spec`` (the port's lens)."""
    from image_lens_reproject_tpu.models import lens as JL

    cls = getattr(JL, type(spec).__name__)
    return cls(**{k: getattr(spec, k) for k in spec.__dataclass_fields__})


def _bounds(got, want):
    # The bounds of tests/test_pallas_kernel.py::test_equirect_to_rect: K1
    # computes its inverse trig with polynomials, the port with libm, so
    # knife-edge taps may differ at isolated pixels. Where the fisheye fold
    # ring gives NaN (config 4), the NaN positions must agree and the
    # bounds hold on the rest.
    assert got.shape == want.shape
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    err = np.abs(np.where(nan, 0.0, got - want))
    assert np.quantile(err, 0.999) < 1e-4
    assert (err.max(axis=-1) > 1e-3).mean() < 1e-3


def test_plain_version_matches_k1_default_body(interpret_k1, launches):
    """Headline kernel configuration at test size: equirect -> rect, bicubic,
    rotation, exposure x2 and Reinhard 4, K1's default body."""
    import jax.numpy as jnp

    src = smooth(96, 192, 3, seed=1)
    rot = rotation_matrix_degrees(20.0, 5.0, -3.0)
    kw = dict(out_h=64, out_w=160, interp="bicubic", n_samples=1, exposure=2.0, reinhard=4.0)
    want = np.asarray(
        interpret_k1.remap_pallas(
            jnp.asarray(src), jnp.asarray(rot), in_lens=_reference(EQUIRECT),
            out_lens=_reference(RECT), scan_unroll=8, **kw,
        )
    )
    got = B1.remap_tonemap(
        torch.from_numpy(src)[None], rot, in_lens=EQUIRECT, out_lens=RECT, **kw
    )[0].numpy()
    _bounds(got, want)
    assert COUNTS["b1.frame"] == 0


def test_plain_version_matches_jax_plain_reference_ww2_size(launches):
    """The size of the ww2-body case of tests/test_ww2.py, cut to 128x256 ->
    64x128 and held against the JAX package's plain reference
    (``ops/remap.py`` + ``ops/color.py``), which K1's ww2 body equals."""
    import jax.numpy as jnp
    from image_lens_reproject_tpu.ops import color as JC
    from image_lens_reproject_tpu.ops import remap as JR

    src = np.random.default_rng(3).uniform(0, 2, (128, 256, 3)).astype(F)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    rect = L.Rectilinear(35.0, 36.0, 36.0)
    want = JR.remap_jit(
        jnp.asarray(src), jnp.asarray(rot), in_lens=_reference(EQUIRECT),
        out_lens=_reference(rect), out_h=64, out_w=128, interp="bicubic", n_samples=1,
    )
    want = np.asarray(JC.post_process(want, 2.0, 4.0))
    got = B1.remap_tonemap(
        torch.from_numpy(src)[None], rot, in_lens=EQUIRECT, out_lens=rect,
        out_h=64, out_w=128, interp="bicubic", exposure=2.0, reinhard=4.0,
    )[0].numpy()
    _bounds(got, want)
    assert COUNTS["b1.frame"] == 0


def test_cpu_tensor_takes_plain_version(launches):
    src = torch.from_numpy(smooth(24, 48, 4, seed=2))[None].repeat(2, 1, 1, 1)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=16, out_w=32, n_samples=2,
              exposure=2.0, reinhard=4.0)
    rot = rotation_matrix_degrees(10.0, 0.0, 0.0)
    got = B1.remap_tonemap(src, rot, **kw)
    want = B1.remap_tonemap_plain(src, rot, **kw)
    assert torch.equal(got, want)
    assert got.shape == (2, 16, 32, 4)
    assert COUNTS["b1.frame"] == 0


def test_pure_torch_switch_selects_plain_version(launches):
    from image_lens_reproject_torch.ops import dispatch

    src = torch.from_numpy(smooth(24, 48, 3, seed=4))[None]
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=16, out_w=32)
    dispatch.set_pure_torch(True)
    try:
        assert dispatch.pure_torch_forced()
        forced = remap_fused.remap_tonemap_batch(src, None, **kw)
    finally:
        dispatch.set_pure_torch(False)
    assert torch.equal(forced, remap_fused.remap_tonemap_batch(src, None, **kw))
    assert torch.equal(remap_fused.remap_tonemap(src[0], None, **kw), forced[0])
    assert COUNTS["b1.frame"] == 0


EQUIDIST = L.FisheyeEquidistant(math.pi, 36.0, 36.0)
EQUISOLID = L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)
STEREO = L.FisheyeStereographic(12.0, 3.0, 36.0, 24.0)
LENSES = [RECT, EQUIDIST, EQUISOLID, STEREO, EQUIRECT]
LENS_IDS = [type(s).__name__ for s in LENSES]


@pytest.mark.parametrize(
    "in_lens,out_lens,interp,covered",
    [
        (EQUIRECT, RECT, "bicubic", True),
        (PARTIAL, RECT, "bicubic", True),
        (EQUIRECT, RECT, "bilinear", True),
        (EQUIRECT, RECT, "nearest", True),
        (EQUIDIST, RECT, "bicubic", True),
        (EQUIRECT, EQUIRECT, "bicubic", True),
        (EQUIRECT, RECT, "lanczos", False),
    ],
)
def test_uncovered_names_the_combination(in_lens, out_lens, interp, covered):
    why = B1.uncovered(in_lens, out_lens, interp)
    if covered:
        assert why is None
    else:
        assert why is not None
        assert type(in_lens).__name__ in why or interp in why


def test_every_combination_k1_accepts_is_covered():
    """K1's gate admits any lens on either side and all three samplers."""
    for in_lens in LENSES + [PARTIAL]:
        for out_lens in LENSES + [PARTIAL]:
            for interp in ("nearest", "bilinear", "bicubic"):
                assert B1.uncovered(in_lens, out_lens, interp) is None


def test_launch_constants_are_float32_rounded():
    p = B1.params(
        (2, 96, 192, 3), in_lens=PARTIAL, out_lens=RECT, out_h=64, out_w=160,
        interp="bilinear", n_samples=3, exposure=2.0 ** 0.3, reinhard=4.0,
        rotation=rotation_matrix_degrees(20.0, 5.0, -3.0),
        aligned=True,
    )
    # The struct is 13 int32 fields, 19 float32 fields, 16 float32 offsets,
    # 4 int32 fields and 9 float32 rotation values for each of the 16 views
    # that go by value, with no padding, as in remap_device.cuh.
    assert ctypes.sizeof(B1.RemapParams) == (52 + 9 * B1.MAX_VIEWS_BY_VALUE) * 4
    assert (p.batch, p.in_h, p.in_w, p.channels, p.out_h, p.out_w) == (2, 96, 192, 3, 64, 160)
    assert (p.n_samples, p.wrap, p.has_rotation, p.tonemap) == (3, 0, 1, 1)
    assert (p.out_lens, p.in_lens, p.interp) == (0, 4, 1)
    assert p.out_k[0] == F(36.0 / (160.0 * 35.0))
    assert p.out_k[1] == F(27.0 / (64.0 * 35.0))
    assert p.in_k[1] == F(1.0 / 3.5)
    assert p.in_k[3] == F(-1.2)
    assert (p.out_half_w, p.out_half_h, p.in_half_w, p.in_half_h) == (80.0, 32.0, 96.0, 48.0)
    assert p.normalize == F(1.0 / 9.0)
    assert p.exposure == F(2.0 ** 0.3)
    assert p.inv_max2 == F(1.0 / 16.0)
    assert list(p.offsets)[:3] == [F((s + 1.0) / 4.0 - 0.5) for s in range(3)]
    assert (p.spec_channels, p.spec_samples) == (3, B1.ANY_SAMPLES)
    assert (p.row0, p.band_rows) == (0, 64)
    full = B1.params(
        (1, 8, 16, 1), in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4, interp="nearest",
        n_samples=1, exposure=1.0, reinhard=1.0, rotation=None, aligned=True,
    )
    assert (full.wrap, full.has_rotation, full.tonemap, full.interp) == (1, 0, 0, 0)


def test_band_fields_come_last_and_are_checked():
    """row0 and band_rows follow every field an older kernel reads (it reads
    a prefix of the struct), and only the by-value rotation follows them; a
    band may run past out_h, never be empty."""
    names = [name for name, _ in B1.RemapParams._fields_]
    assert names[-3:] == ["row0", "band_rows", "rotation"]
    assert B1.RemapParams.row0.offset == 50 * 4
    assert B1.RemapParams.rotation.offset == 52 * 4
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=30, out_w=16, interp="bicubic", n_samples=1,
              exposure=1.0, reinhard=1.0, rotation=None, aligned=True)
    p = B1.params((1, 8, 16, 3), row_offset=24, row_count=8, **kw)
    assert (p.row0, p.band_rows, p.out_h) == (24, 8, 30)
    for row_offset, row_count in ((-8, 8), (0, 0), (2**31 - 8, 8)):
        with pytest.raises(ValueError):
            B1.params((1, 8, 16, 3), row_offset=row_offset, row_count=row_count, **kw)


def _host_rotation(kind, seed):
    """A seeded float64 rotation (with bits that float32 rounds off), held as ``kind``."""
    angles = np.random.default_rng(seed).uniform(-180.0, 180.0, 3)
    r = rotation_matrix_degrees(*angles)
    return {"numpy-f64": lambda: r, "numpy-f32": lambda: r.astype(F),
            "numpy-f64-column-major": lambda: np.asfortranarray(r),
            "nested-list": r.tolist, "tuple-of-tuples": lambda: tuple(map(tuple, r)),
            "cpu-tensor-f64": lambda: torch.from_numpy(r),
            "cpu-tensor-f32": lambda: torch.from_numpy(r.astype(F))}[kind]()


HOST_ROTATIONS = ["numpy-f64", "numpy-f32", "numpy-f64-column-major", "nested-list",
                  "tuple-of-tuples", "cpu-tensor-f64", "cpu-tensor-f32"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", HOST_ROTATIONS)
def test_host_rotation_goes_by_value_with_torch_s_float32_bits(kind, seed):
    """A rotation on the host travels in the launch constants, row-major, with
    the float32 bits that ``torch.as_tensor(r, dtype=torch.float32)`` gives:
    the bits a CUDA tensor of it holds, which the kernel reads by pointer."""
    r = _host_rotation(kind, seed)
    want = torch.as_tensor(r, dtype=torch.float32).numpy().ravel()
    assert B1.rotation_code(r) == B1.ROTATION_BY_VALUE
    p = B1.params((1, 8, 16, 3), in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4,
                  interp="bicubic", n_samples=1, exposure=1.0, reinhard=1.0, rotation=r,
                  aligned=True)
    got, rest = np.array(p.rotation, dtype=F)[:9], np.array(p.rotation, dtype=F)[9:]
    assert p.has_rotation == B1.ROTATION_BY_VALUE and not rest.any()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(B1.host_rotation(r).ravel().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("kind,code", [
    ("none", B1.NO_ROTATION),
    ("numpy", B1.ROTATION_BY_VALUE),
    ("list", B1.ROTATION_BY_VALUE),
    ("cpu-tensor", B1.ROTATION_BY_VALUE),
    ("device-tensor", B1.ROTATION_ON_DEVICE),
])
def test_rotation_code_follows_where_the_rotation_lies(kind, code):
    """None, a host rotation (by value) or a tensor on a device (its pointer:
    reading it on the host would wait for the card). A ``meta`` tensor
    stands for a CUDA one: a tensor on a device that is not the CPU. Only a
    rotation by value fills the launch constants' nine values."""
    r = rotation_matrix_degrees(20.0, 5.0, 0.0)
    rotation = {"none": None, "numpy": r, "list": r.tolist(),
                "cpu-tensor": torch.from_numpy(r),
                "device-tensor": torch.empty((3, 3), device="meta")}[kind]
    assert B1.rotation_code(rotation) == code
    p = B1.params((1, 8, 16, 3), in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4,
                  interp="bicubic", n_samples=1, exposure=1.0, reinhard=1.0,
                  rotation=rotation, aligned=True)
    assert p.has_rotation == code
    assert any(p.rotation) == (code == B1.ROTATION_BY_VALUE)


@pytest.mark.parametrize("rotation", [
    np.eye(4), np.eye(3)[:2], list(range(9)), torch.eye(3)[None], [[1.0, 0.0], [0.0, 1.0]],
], ids=["numpy-4x4", "numpy-2x3", "flat-list", "cpu-tensor-1x3x3", "list-2x2"])
def test_host_rotation_of_another_shape_raises(rotation):
    with pytest.raises(ValueError, match=r"rotation must be \(3, 3\)"):
        B1.host_rotation(rotation)
    with pytest.raises(ValueError, match=r"rotation must be \(3, 3\)"):
        B1.params((1, 8, 16, 3), in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4,
                  interp="bicubic", n_samples=1, exposure=1.0, reinhard=1.0,
                  rotation=rotation, aligned=True)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 17])
def test_supersample_offsets_are_the_plain_paths(n):
    """The offsets B1 reads are the plain path's float32 offsets, the first
    16 of them; past 16 the kernel computes them as the host does."""
    p = B1.params(
        (1, 8, 16, 3), in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4, interp="bicubic",
        n_samples=n, exposure=1.0, reinhard=1.0, rotation=None, aligned=True,
    )
    want = remap.supersample_offsets(n)[:B1.MAX_OFFSETS]
    assert list(p.offsets)[:len(want)] == [F(v) for v in want]
    assert list(p.offsets)[len(want):] == [0.0] * (B1.MAX_OFFSETS - len(want))
    assert all(float(F(v)) == v for v in want)
    assert p.normalize == F(1.0 / (n * n))


@pytest.mark.parametrize(
    "shape,n,aligned,want",
    [
        ((1, 1920, 3840, 3), 1, True, (3, 1)),
        ((4, 1920, 3840, 3), 1, True, (3, 1)),
        ((1, 2048, 2048, 4), 1, True, (4, 1)),
        ((1, 2048, 2048, 4), 1, False, (B1.ANY_CHANNELS, 1)),
        ((1, 2048, 2048, 3), 2, True, (3, B1.ANY_SAMPLES)),
        ((2, 96, 192, 1), 1, True, (B1.ANY_CHANNELS, 1)),
        ((2, 96, 192, 5), 3, True, (B1.ANY_CHANNELS, B1.ANY_SAMPLES)),
        # The last C = 3 image whose offsets fit 32 bits, and the next one.
        ((1, 2**15, 21845, 3), 1, True, (3, 1)),
        ((1, 2**15, 21846, 3), 1, True, (B1.ANY_CHANNELS, 1)),
        ((1, 30000, 30000, 3), 1, True, (B1.ANY_CHANNELS, 1)),
        ((1, 2**14, 2**15, 4), 1, True, (B1.ANY_CHANNELS, 1)),
    ],
)
def test_specialisation_follows_the_shapes(shape, n, aligned, want):
    """The full frame's instance: C = 3, or C = 4 on an aligned source, with
    offsets inside an image in 32 bits only below 2**31 values; one
    supersample or any. The batch does not change it."""
    assert B1.specialisation(shape, n, aligned) == want
    fits = shape[1] * shape[2] * shape[3] < 2**31
    assert want[0] == B1.ANY_CHANNELS or fits
    p = B1.params(
        shape, in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4, interp="bicubic",
        n_samples=n, exposure=1.0, reinhard=1.0, rotation=None, aligned=aligned,
    )
    assert (p.spec_channels, p.spec_samples) == want



@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("c", [1, 3, 4, 5])
def test_list_mode_instance_follows_the_shapes(c, n, aligned):
    """List mode launches the frame's instance of its launch constants
    (``launch_setup`` -> ``params``): C = 3 whatever the alignment, C = 4
    only on a 16-byte aligned source, any other C the generic instance; one
    supersample or any."""
    shape = (4, 96, 192, c)
    want = (c if c == 3 or (c == 4 and aligned) else B1.ANY_CHANNELS,
            1 if n == 1 else B1.ANY_SAMPLES)
    assert B1.specialisation(shape, n, aligned) == want
    p = B1.params(shape, in_lens=EQUIRECT, out_lens=RECT, out_h=20, out_w=300, interp="bilinear",
                  n_samples=n, exposure=2.0, reinhard=4.0,
                  rotation=rotation_matrix_degrees(20.0, 5.0, 0.0), aligned=aligned)
    assert (p.spec_channels, p.spec_samples) == want


@pytest.mark.parametrize("shape", [(1, 2**15, 21846, 3), (2, 2**14, 2**15, 4)])
def test_list_mode_instance_above_2_31_values(shape):
    """An image of 2**31 values or more takes the generic instance (64-bit
    offsets) in list mode too, aligned or not."""
    for n in (1, 2):
        p = B1.params(shape, in_lens=EQUIRECT, out_lens=RECT, out_h=8, out_w=128,
                      interp="bicubic", n_samples=n, exposure=1.0, reinhard=1.0,
                      rotation=None, aligned=True)
        assert (p.spec_channels, p.spec_samples) == (B1.ANY_CHANNELS, 1 if n == 1 else
                                                     B1.ANY_SAMPLES)


@pytest.mark.parametrize("in_lens", [EQUIRECT, PARTIAL], ids=["wrap", "clamp"])
def test_list_plain_matches_jax_plain_reference_c4_n2(in_lens):
    """List mode's plain version at C = 4 and 2 x 2 supersamples, with the
    tonemap (colour only), against the JAX package's plain reference
    (``ops/remap.py`` + ``ops/color.py``) at the listed sub-tiles, clipped
    at the frame's edges, within the BASELINE budget; the other pixels are
    left as they were."""
    import jax.numpy as jnp
    from image_lens_reproject_tpu.ops import color as JC
    from image_lens_reproject_tpu.ops import remap as JR

    src = smooth(96, 192, 4, seed=6)
    rot = rotation_matrix_degrees(20.0, 5.0, -3.0)
    kw = dict(out_h=36, out_w=300, interp="bicubic", n_samples=2)
    want = JR.remap_jit(jnp.asarray(src), jnp.asarray(rot), in_lens=_reference(in_lens),
                        out_lens=_reference(RECT), **kw)
    want = np.asarray(JC.post_process(want, 2.0, 4.0))
    tiles = torch.tensor([[0, 0], [1, 2], [4, 1], [2, 1]], dtype=torch.int32)
    out = torch.full((1, 36, 300, 4), -7.0)
    before = COUNTS["b1.list"]
    B1.remap_tonemap_list(torch.from_numpy(src)[None], rot, out, tiles, in_lens=in_lens,
                          out_lens=RECT, exposure=2.0, reinhard=4.0, **kw)
    assert COUNTS["b1.list"] == before
    written = np.zeros((36, 300), dtype=bool)
    for ty, tx in tiles.tolist():
        written[ty * 8:ty * 8 + 8, tx * 128:tx * 128 + 128] = True
    got = out[0].numpy()
    assert (got[~written] == -7.0).all()
    err = np.abs(got[written] - want[written])
    assert np.isfinite(got[written]).all()
    assert err.max() < 1e-3 and np.quantile(err, 0.999) < 1e-4

def test_sources_build_the_frame_once_for_each_input_lens():
    frames = [u for u in B1.SOURCES if not isinstance(u, str)]
    assert [u[0] for u in frames] == ["remap_frame.cu"] * 5
    assert sorted(u[1] for u in frames) == sorted(
        (f"ILR_IN_LENS={code}",) for code in B1.LENS_CODES.values())


def _kernel_wrap(i, w):
    """csrc/remap_device.cuh::wrap_w in int32 numpy: one conditional add or
    subtract, then the exact floor modulo of the wrapped i + w only where
    that left [0, w); C's % truncates, as np.fmod does."""
    i = np.asarray(i, dtype=np.int32)
    w32 = np.int32(w)
    with np.errstate(over="ignore"):
        j = np.where(i < 0, i + w32, np.where(i >= w32, i - w32, i)).astype(np.int32)
        wrapped = (i.astype(np.uint32) + np.uint32(w)).astype(np.int32)
    exact = np.fmod(np.fmod(wrapped, w32) + w32, w32)
    return np.where((j < 0) | (j >= w32), exact, j)


@pytest.mark.parametrize("w", [2, 3, 7, 1081, 3840])
def test_kernel_wrap_equals_plain_wrap(w):
    """The kernel's wrap gives ops/sampling.py's floor-modulo wrap for every
    index in [-3W, 3W) and at the int32 saturation of non-finite
    coordinates."""
    ends = [-(2**31), -(2**31) + 1, -(2**31) + w, 2**31 - 1 - w, 2**31 - 2, 2**31 - 1]
    i = np.concatenate([np.arange(-3 * w, 3 * w), np.array(ends)]).astype(np.int64)
    want = sampling._wrap_w(torch.from_numpy(i), w).numpy()
    got = _kernel_wrap(i, w)
    np.testing.assert_array_equal(got, want)
    assert ((0 <= got) & (got < w)).all()


def _constants(lens, w, h, side):
    """Each constant of models/projections.py for ``lens``, as _f32(double expr)."""
    if isinstance(lens, L.Rectilinear):
        if side == "out":
            return [lens.sensor_width / (w * lens.focal_length),
                    lens.sensor_height / (h * lens.focal_length)]
        return [w * lens.focal_length / lens.sensor_width, h * lens.focal_length / lens.sensor_height]
    if isinstance(lens, L.FisheyeEquidistant):
        return [lens.fov / w] if side == "out" else [w / lens.fov]
    if isinstance(lens, L.Equirectangular):
        if side == "out":
            return [1.0 / w, lens.longitude_max - lens.longitude_min, lens.longitude_min,
                    1.0 / h, lens.latitude_max - lens.latitude_min, lens.latitude_min]
        return [lens.longitude_min, 1.0 / (lens.longitude_max - lens.longitude_min), w,
                lens.latitude_min, 1.0 / (lens.latitude_max - lens.latitude_min), h]
    f, sw = lens.focal_length, lens.sensor_width
    if side == "out":
        return [sw / w, 1.0 / (2.0 * f), sw / (f * w)]
    return [2.0 * f, w / sw, f * w / sw]


@pytest.mark.parametrize("side", ["in", "out"])
@pytest.mark.parametrize("lens", LENSES + [PARTIAL], ids=LENS_IDS + ["partial"])
def test_lens_constants_are_float32_rounded(lens, side):
    """Every lens type's launch constants, on either side, are the plain
    path's float32 operands: each rounded once from its double expression."""
    other = RECT if not isinstance(lens, L.Rectilinear) else EQUIRECT
    in_lens, out_lens = (lens, other) if side == "in" else (other, lens)
    p = B1.params(
        (1, 90, 170, 3), in_lens=in_lens, out_lens=out_lens, out_h=70, out_w=130,
        interp="bicubic", n_samples=1, exposure=1.0, reinhard=1.0, rotation=None,
        aligned=True,
    )
    w, h = (170.0, 90.0) if side == "in" else (130.0, 70.0)
    want = [F(v) for v in _constants(lens, w, h, side)]
    got = list(p.in_k if side == "in" else p.out_k)
    assert got[:len(want)] == want
    assert got[len(want):] == [0.0] * (6 - len(want))
    code = p.in_lens if side == "in" else p.out_lens
    assert code == B1.LENS_CODES[type(lens)]
    assert p.wrap == int(in_lens is EQUIRECT)


# BASELINE configs 1, 2 and 4 (bench/baseline_configs.py:141-158), shrunk:
# the lenses, sampler, rotation and channel count as published; the
# resolutions cut so that K1 runs in interpret mode in seconds.
SHRUNK_CONFIGS = {
    "1-equidistant-rect": (EQUIDIST, L.Rectilinear(35.0, 36.0, 36.0 * 54 / 96), 64, 64, 3,
                           54, 96, None),
    "2-equisolid-equirect": (EQUISOLID, EQUIRECT, 64, 64, 3, 48, 96, (30.0, 10.0, 5.0)),
    "4-rect-equisolid-rgbz": (L.Rectilinear(50.0, 36.0, 36.0), EQUISOLID, 64, 64, 4, 64, 64,
                              None),
}


@pytest.mark.parametrize("config", sorted(SHRUNK_CONFIGS))
def test_plain_version_matches_k1_baseline_configs(interpret_k1, launches, config):
    import jax.numpy as jnp

    in_lens, out_lens, in_h, in_w, c, out_h, out_w, rot = SHRUNK_CONFIGS[config]
    src = smooth(in_h, in_w, c, seed=5)
    rot = None if rot is None else rotation_matrix_degrees(*rot)
    kw = dict(out_h=out_h, out_w=out_w, interp="bilinear", n_samples=1)
    want = np.asarray(
        interpret_k1.remap_pallas(
            jnp.asarray(src), None if rot is None else jnp.asarray(rot),
            in_lens=_reference(in_lens), out_lens=_reference(out_lens), scan_unroll=8, **kw,
        )
    )
    got = B1.remap_tonemap(
        torch.from_numpy(src)[None], rot, in_lens=in_lens, out_lens=out_lens, **kw
    )[0].numpy()
    _bounds(got, want)
    assert COUNTS["b1.frame"] == 0


def test_library_name_keyed_on_sources(tmp_path, monkeypatch):
    from image_lens_reproject_torch.ops.cuda import build

    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k", ["k.cu"])
    assert first == build.library_path("k", ["k.cu"])
    (tmp_path / "k.cu").write_text("// two\n")
    assert build.library_path("k", ["k.cu"]) != first
    assert first.parent == build.BUILD_DIR


def test_library_name_keyed_on_another_source_dir(tmp_path):
    """A library built from another directory (an older version of a kernel)
    is keyed on that directory's sources and headers, not on csrc/'s."""
    from image_lens_reproject_torch.ops.cuda import build

    (tmp_path / "remap_kernel.cu").write_text("// an older B1\n")
    (tmp_path / "remap_device.cuh").write_text("// its header\n")
    old = build.library_path("old", ["remap_kernel.cu"], tmp_path)
    assert old != build.library_path("old", ["remap_kernel.cu"])
    assert old.parent == build.BUILD_DIR
    (tmp_path / "remap_device.cuh").write_text("// another header\n")
    assert build.library_path("old", ["remap_kernel.cu"], tmp_path) != old


def test_launch_constants_need_the_alignment():
    """The 16-byte-tap instance is never picked by default: the caller says
    whether the source is aligned."""
    with pytest.raises(TypeError):
        B1.specialisation((1, 2048, 2048, 4), 1)
    with pytest.raises(TypeError):
        B1.params((1, 8, 16, 4), in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4,
                  interp="bilinear", n_samples=1, exposure=1.0, reinhard=1.0,
                  rotation=None)


# --- on the card -----------------------------------------------------------


def _assert_bit_equal(got, want):
    """Equal shapes, NaN at the same places, max abs 0 on the rest."""
    assert got.shape == want.shape
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got[~nan], want[~nan])


def _cuda_case(cuda, *, in_lens, c, n_samples, rotation, exposure, reinhard, seed):
    src = torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 2, (2, 40, 80, c)).astype(F)
    ).to(cuda)
    kw = dict(in_lens=in_lens, out_lens=RECT, out_h=48, out_w=72, n_samples=n_samples,
              exposure=exposure, reinhard=reinhard)
    got = B1.remap_tonemap(src, rotation, **kw)
    want = B1.remap_tonemap_plain(src, rotation, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize(
    "in_lens,c,n_samples,rotation,exposure,reinhard",
    [
        (EQUIRECT, 3, 1, (20.0, 5.0, 0.0), 2.0, 4.0),
        (EQUIRECT, 1, 1, (20.0, 5.0, 0.0), 2.0, 4.0),
        (EQUIRECT, 5, 2, (180.0, 0.0, 0.0), 2.0, 4.0),
        (PARTIAL, 4, 1, None, 1.0, 1.0),
    ],
)
def test_kernel_matches_plain_version_on_card(cuda, launches, in_lens, c, n_samples,
                                              rotation, exposure, reinhard):
    rot = None if rotation is None else rotation_matrix_degrees(*rotation)
    got, want = _cuda_case(cuda, in_lens=in_lens, c=c, n_samples=n_samples, rotation=rot,
                           exposure=exposure, reinhard=reinhard, seed=c)
    assert COUNTS["b1.frame"] == 1
    assert got.shape == want.shape
    # Bit for bit: the same float32 operations in the same order, with the
    # same libm on both sides.
    _assert_bit_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("out_lens", LENSES, ids=LENS_IDS)
@pytest.mark.parametrize("in_lens", LENSES, ids=LENS_IDS)
def test_every_lens_pair_and_sampler_matches_plain_on_card(cuda, launches, in_lens, out_lens,
                                                           interp):
    src = torch.from_numpy(
        np.random.default_rng(11).uniform(0, 2, (2, 40, 80, 4)).astype(F)
    ).to(cuda)
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=36, out_w=68, interp=interp,
              n_samples=2, exposure=2.0, reinhard=4.0)
    rot = rotation_matrix_degrees(20.0, 5.0, -3.0)
    got = B1.remap_tonemap(src, rot, **kw)
    want = B1.remap_tonemap_plain(src, rot, **kw)
    torch.cuda.synchronize()
    assert COUNTS["b1.frame"] == 1
    assert got.shape == want.shape == (2, 36, 68, 4)
    _assert_bit_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples", [1, 2])
@pytest.mark.parametrize("c", [1, 3, 4, 5])
@pytest.mark.parametrize("in_lens", [EQUIRECT, PARTIAL], ids=["wrap", "clamp"])
def test_batch_of_four_equals_single_launches_on_card(cuda, launches, in_lens, c, n_samples):
    """One launch for four images (each pixel's coordinates computed once
    for all four) equals four one-image launches and the plain version."""
    src = torch.from_numpy(
        np.random.default_rng(c).uniform(0, 2, (4, 40, 80, c)).astype(F)
    ).to(cuda)
    kw = dict(in_lens=in_lens, out_lens=RECT, out_h=48, out_w=72, interp="bicubic",
              n_samples=n_samples, exposure=2.0, reinhard=4.0)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    got = B1.remap_tonemap(src, rot, **kw)
    singles = torch.cat([B1.remap_tonemap(src[i:i + 1], rot, **kw) for i in range(4)])
    want = B1.remap_tonemap_plain(src, rot, **kw)
    torch.cuda.synchronize()
    assert COUNTS["b1.frame"] == 5
    _assert_bit_equal(got, singles)
    _assert_bit_equal(got, want)



def _list_source(cuda, shape, aligned, seed):
    """A contiguous float32 source on the card, 16-byte aligned or 4 bytes past it."""
    n = int(np.prod(shape))
    flat = torch.empty(n + 4, device=cuda)
    src = flat[(0 if aligned else 1):][:n].view(shape)
    src.copy_(torch.from_numpy(np.random.default_rng(seed).uniform(0, 2, shape).astype(F)))
    assert (src.data_ptr() % 16 == 0) == aligned
    return src


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n_samples", [1, 2])
@pytest.mark.parametrize("c,aligned", [(3, True), (4, True), (4, False), (5, True)],
                         ids=["C3", "C4", "C4-unaligned", "C5"])
def test_list_mode_instances_match_plain_on_card(cuda, c, aligned, n_samples, batch):
    """Each list-mode instance (C = 3, C = 4, the generic one; one
    supersample or any) at batch 1 and 4, on sub-tiles inside the frame and
    clipped at its right and bottom edges: bit for bit with the plain
    version, and the other pixels untouched."""
    src = _list_source(cuda, (batch, 40, 80, c), aligned, seed=c + 10 * n_samples)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=36, out_w=300, interp="bicubic",
              n_samples=n_samples, exposure=2.0, reinhard=4.0)
    assert B1.specialisation(src.shape, n_samples, aligned) == (
        c if c == 3 or (c == 4 and aligned) else B1.ANY_CHANNELS,
        1 if n_samples == 1 else B1.ANY_SAMPLES)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    tiles = torch.tensor([[0, 0], [1, 2], [4, 1], [4, 2]], dtype=torch.int32, device=cuda)
    got = torch.full((batch, 36, 300, c), float("nan"), device=cuda)
    want = got.clone()
    before = COUNTS["b1.list"]
    B1.remap_tonemap_list(src, rot, got, tiles, **kw)
    B1.remap_tonemap_list_plain(src, rot, want, tiles, **kw)
    torch.cuda.synchronize()
    assert COUNTS["b1.list"] == before + 1
    _assert_bit_equal(got, want)
    # Written: one whole sub-tile, 44 columns of one, 4 rows of one, 4 x 44 of one.
    written = 1024 + 8 * 44 + 4 * 128 + 4 * 44
    assert int(torch.isnan(got[..., 0]).sum()) == batch * (36 * 300 - written)

@pytest.mark.gpu
def test_wrong_dtype_raises_on_card(cuda, launches):
    src = torch.zeros((1, 8, 16, 3), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        B1.remap_tonemap(src.double(), None, in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4)
    with pytest.raises(TypeError, match="float32"):
        B1.remap_tonemap(src.half(), None, in_lens=EQUIDIST, out_lens=RECT, out_h=4, out_w=4,
                         interp="bilinear")
    with pytest.raises(ValueError):
        B1.remap_tonemap(src[:, :, ::2], None, in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4)
    assert COUNTS["b1.frame"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n_rows", [4, 7])
def test_band_mode_equals_the_frame_on_card(cuda, batch, n_rows):
    """B1's bands (ceil(out_h / n_rows) rows each, the last running past
    out_h) equal its full frame's rows bit for bit, and each band its plain
    version; they count as band launches, not frame launches."""
    src = torch.from_numpy(
        np.random.default_rng(batch).uniform(0, 2, (batch, 48, 96, 3)).astype(F)
    ).to(cuda)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=50, out_w=72, interp="bicubic",
              n_samples=1, exposure=2.0, reinhard=4.0)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    frame = B1.remap_tonemap(src, rot, **kw)
    band = -(-50 // n_rows)
    saved = COUNTS["b1.frame"], COUNTS["b1.band"]
    bands = [B1.remap_tonemap(src, rot, row_offset=j * band, row_count=band, **kw)
             for j in range(n_rows)]
    plain = [B1.remap_tonemap_plain(src, rot, row_offset=j * band, row_count=band, **kw)
             for j in range(n_rows)]
    torch.cuda.synchronize()
    assert (COUNTS["b1.frame"], COUNTS["b1.band"]) == (saved[0], saved[1] + n_rows)
    for got, want in zip(bands, plain):
        _assert_bit_equal(got, want)
    _assert_bit_equal(torch.cat(bands, dim=1)[:, :50], frame)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n_samples", [1, 2])
@pytest.mark.parametrize("c,aligned", [(3, True), (4, False)], ids=["C3", "C4-unaligned"])
def test_list_band_mode_matches_plain_on_card(cuda, c, aligned, n_samples, batch):
    """List mode in a band of rows [12, 32) of a 36-row frame: sub-tile rows
    count from row 12, the third clipped at the band's 20 rows. Bit for bit
    with its plain version and with B1's band mode at those pixels; counted
    as a list band launch."""
    src = _list_source(cuda, (batch, 40, 80, c), aligned, seed=c + 10 * n_samples)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=36, out_w=300, interp="bicubic",
              n_samples=n_samples, exposure=2.0, reinhard=4.0, row_offset=12, row_count=20)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    tiles = torch.tensor([[0, 0], [1, 2], [2, 1]], dtype=torch.int32, device=cuda)
    got = torch.full((batch, 20, 300, c), float("nan"), device=cuda)
    want = got.clone()
    before = COUNTS["b1.list"], COUNTS["b1.list_band"]
    B1.remap_tonemap_list(src, rot, got, tiles, **kw)
    B1.remap_tonemap_list_plain(src, rot, want, tiles, **kw)
    band = B1.remap_tonemap(src, rot, **kw)
    torch.cuda.synchronize()
    assert (COUNTS["b1.list"], COUNTS["b1.list_band"]) == (before[0], before[1] + 1)
    _assert_bit_equal(got, want)
    written = ~torch.isnan(got[..., 0])
    assert int(written[0].sum()) == 1024 + 8 * 44 + 4 * 128
    _assert_bit_equal(got[written], band[written])


@pytest.mark.gpu
@pytest.mark.parametrize("activities", ["none", "card", "host"])
def test_wrapper_spans_only_while_a_profiler_runs_on_card(cuda, activities):
    """B1's ``b1.*`` spans, once each a call of either entry point (and
    ``b1.field`` in the frame's call alone), while a profiler runs (the
    card alone or the host too), and none without one; the wrapper's span
    holds the others."""
    from image_lens_reproject_torch.utils import tracing

    src = torch.from_numpy(np.random.default_rng(3).uniform(0, 2, (1, 40, 80, 3)).astype(F))
    src = src.to(cuda)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=36, out_w=256, interp="bicubic")
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    tiles = torch.tensor([[0, 0], [1, 1]], dtype=torch.int32, device=cuda)
    out = torch.zeros((1, 36, 256, 3), device=cuda)
    B1.remap_tonemap(src, rot, **kw)  # built and warm
    torch.cuda.synchronize()
    acts = {"none": [], "card": [torch.profiler.ProfilerActivity.CUDA],
            "host": [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]}
    tracing.reset_zones()
    with torch.profiler.profile(activities=acts[activities]) if acts[activities] else \
            contextlib.nullcontext():
        B1.remap_tonemap(src, rot, **kw)
        B1.remap_tonemap_list(src, rot, out, tiles, **kw)
        torch.cuda.synchronize()
    got = {k: n for k, (_, n) in tracing.zone_totals().items() if k.startswith("b1.")}
    names = ("b1.wrapper", "b1.rotation", "b1.params", "b1.launch")
    assert got == ({} if activities == "none" else dict({k: 2 for k in names}, **{"b1.field": 1}))
    spans = [s for s in tracing.span_log() if s.name.startswith("b1.")]
    wrappers = [s for s in spans if s.name == "b1.wrapper"]
    for wrapper, extra in zip(wrappers, (("b1.field",), ())):
        inner = [s for s in spans if s.name != "b1.wrapper" and wrapper.t0 <= s.t0 <= wrapper.t1]
        assert sorted(s.name for s in inner) == sorted(names[1:] + extra)
        assert all(s.t1 <= wrapper.t1 for s in inner)
    tracing.reset_zones()


ROTATION_MODES = ["frame", "band", "list", "list-band", "windows"]


def _rotation_case(cuda, in_lens):
    """A batch of two on the card, the launch arguments and a numpy rotation."""
    src = torch.from_numpy(
        np.random.default_rng(17).uniform(0, 2, (2, 40, 80, 3)).astype(F)).to(cuda)
    kw = dict(in_lens=in_lens, out_lens=RECT, out_h=36, out_w=300, interp="bicubic",
              n_samples=1, exposure=2.0, reinhard=4.0)
    return src, kw, rotation_matrix_degrees(20.0, 5.0, -3.0)


def _run_mode(mode, src, rotation, kw, extra):
    """One call of ``mode`` with ``rotation``: its output (lists and B2 write
    into a NaN-filled output)."""
    from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

    band = dict(row_offset=12, row_count=20) if mode in ("band", "list-band") else {}
    if mode in ("frame", "band"):
        return B1.remap_tonemap(src, rotation, **kw, **band)
    rows = band.get("row_count", kw["out_h"])
    out = torch.full((src.shape[0], rows, kw["out_w"], 3), float("nan"), device=src.device)
    if mode == "windows":
        plan, misses = extra
        B2.remap_windows(src, rotation, out, plan.rescue, split=False, misses=misses,
                         classes=plan.rescue_classes, **kw)
    else:
        B1.remap_tonemap_list(src, rotation, out, extra, **kw, **band)
    return out


def _mode_extra(mode, cuda, src, rotation, kw):
    """What ``mode`` needs besides the batch: list mode's sub-tiles, or B2's
    plan (every sub-tile's window fits: the whole list goes to B2) and its
    miss counter."""
    from image_lens_reproject_torch.ops import plan as P
    from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

    if mode == "windows":
        plan = P.make_plan(rotation, in_h=40, in_w=80, channels=3, split=False, device=cuda,
                           budget_bytes=64 * 1024,
                           **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w",
                                                 "interp", "n_samples")})
        assert len(plan.direct) == 0 and len(plan.rescue) == 5 * 3
        return plan, B2.new_misses(cuda)
    if mode == "list":
        return torch.tensor([[0, 0], [1, 2], [4, 1], [4, 2]], dtype=torch.int32, device=cuda)
    if mode == "list-band":
        return torch.tensor([[0, 0], [1, 2], [2, 1]], dtype=torch.int32, device=cuda)
    return None


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ROTATION_MODES)
@pytest.mark.parametrize("in_lens", LENSES, ids=LENS_IDS)
def test_rotation_by_value_equals_rotation_on_device_on_card(cuda, in_lens, mode):
    """Each input lens's instance, in B1's frame, band, list and list-band
    modes and in B2: a numpy rotation (by value in the launch constants)
    gives the output of the same rotation as a CUDA tensor (through its
    pointer) bit for bit, and each call counts once in its counter."""
    src, kw, rot = _rotation_case(cuda, in_lens)
    extra = _mode_extra(mode, cuda, src, rot, kw)
    on_card = torch.as_tensor(rot, dtype=torch.float32, device=cuda)
    keys = ("b1.rotation_by_value", "b1.rotation_on_device")
    before = tuple(COUNTS[k] for k in keys)
    by_value = _run_mode(mode, src, rot, kw, extra)
    assert tuple(COUNTS[k] for k in keys) == (before[0] + 1, before[1])
    on_device = _run_mode(mode, src, on_card, kw, extra)
    assert tuple(COUNTS[k] for k in keys) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    _assert_bit_equal(by_value, on_device)
    if mode == "windows":
        assert int(extra[1]) == 0
    assert not torch.isnan(by_value).all()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["frame", "list", "windows"])
def test_host_rotation_makes_no_synchronising_call_on_card(cuda, mode):
    """With a numpy rotation, ``remap_tonemap_batch``, B1's list mode and
    ``remap_windows`` queue their work and return without a synchronising
    call (torch's sync debug mode raises on one), and give the output they
    give outside that mode."""
    src, kw, rot = _rotation_case(cuda, EQUIRECT)
    extra = _mode_extra(mode, cuda, src, rot, kw)

    def call():
        if mode == "frame":
            return remap_fused.remap_tonemap_batch(src, rot, **kw)
        return _run_mode(mode, src, rot, kw, extra)

    want = call()  # built and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _assert_bit_equal(got, want)


@pytest.mark.gpu
def test_host_rotation_call_replays_in_a_cuda_graph_on_card(cuda):
    """``remap_tonemap_batch`` with a numpy rotation captures into a CUDA
    graph (the call queues no copy), and each replay equals the eager call
    on the batch as it then is, bit for bit."""
    src, kw, rot = _rotation_case(cuda, EQUIRECT)
    kw = dict(kw, out_h=48, out_w=72)
    eager = remap_fused.remap_tonemap_batch(src, rot, **kw)  # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = remap_fused.remap_tonemap_batch(src, rot, **kw)
    graph.replay()
    torch.cuda.synchronize()
    _assert_bit_equal(captured, eager)
    src.mul_(0.5)
    graph.replay()
    eager = remap_fused.remap_tonemap_batch(src, rot, **kw)
    torch.cuda.synchronize()
    _assert_bit_equal(captured, eager)
