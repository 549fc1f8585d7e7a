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

import ctypes
import math

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import remap_fused
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1

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
    """B1.LAUNCHES reset to 0 for the test and restored after it."""
    saved = B1.LAUNCHES
    B1.LAUNCHES = 0
    yield
    B1.LAUNCHES = saved


def _reference(spec):
    """The JAX package's lens equal to ``spec`` (the port's lens)."""
    from image_lens_reproject_tpu.models import lens as JL

    cls = getattr(JL, type(spec).__name__)
    return cls(**{k: getattr(spec, k) for k in spec.__dataclass_fields__})


def _bounds(got, want):
    # The bounds of tests/test_pallas_kernel.py::test_equirect_to_rect: K1
    # computes its inverse trig with polynomials, the port with libm, so
    # knife-edge taps may differ at isolated pixels.
    err = np.abs(got - want)
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
    assert B1.LAUNCHES == 0


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
    assert B1.LAUNCHES == 0


def test_cpu_tensor_takes_plain_version(launches):
    src = torch.from_numpy(smooth(24, 48, 4, seed=2))[None].repeat(2, 1, 1, 1)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=16, out_w=32, n_samples=2,
              exposure=2.0, reinhard=4.0)
    rot = rotation_matrix_degrees(10.0, 0.0, 0.0)
    got = B1.remap_tonemap(src, rot, **kw)
    want = B1.remap_tonemap_plain(src, rot, **kw)
    assert torch.equal(got, want)
    assert got.shape == (2, 16, 32, 4)
    assert B1.LAUNCHES == 0


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
    assert B1.LAUNCHES == 0


@pytest.mark.parametrize(
    "in_lens,out_lens,interp,covered",
    [
        (EQUIRECT, RECT, "bicubic", True),
        (PARTIAL, RECT, "bicubic", True),
        (EQUIRECT, RECT, "bilinear", False),
        (EQUIRECT, RECT, "nearest", False),
        (L.FisheyeEquidistant(math.pi, 36.0, 36.0), RECT, "bicubic", False),
        (EQUIRECT, EQUIRECT, "bicubic", False),
    ],
)
def test_uncovered_names_the_combination(in_lens, out_lens, interp, covered):
    why = B1.uncovered(in_lens, out_lens, interp)
    if covered:
        assert why is None
    else:
        assert why is not None
        assert type(in_lens).__name__ in why or interp in why


def test_launch_constants_are_float32_rounded():
    p = B1.params(
        (2, 96, 192, 3), in_lens=PARTIAL, out_lens=RECT, out_h=64, out_w=160,
        n_samples=3, exposure=2.0 ** 0.3, reinhard=4.0, has_rotation=True,
    )
    # The struct is 10 int32 and 15 float32 fields, with no padding, as in
    # remap_kernel.cu.
    assert ctypes.sizeof(B1.RemapParams) == 25 * 4
    assert (p.batch, p.in_h, p.in_w, p.channels, p.out_h, p.out_w) == (2, 96, 192, 3, 64, 160)
    assert (p.n_samples, p.wrap, p.has_rotation, p.tonemap) == (3, 0, 1, 1)
    assert p.ray_fx == F(36.0 / (160.0 * 35.0))
    assert p.ray_fy == F(27.0 / (64.0 * 35.0))
    assert p.inv_lon_span == F(1.0 / 3.5)
    assert p.lat_min == F(-1.2)
    assert p.normalize == F(1.0 / 9.0)
    assert p.exposure == F(2.0 ** 0.3)
    assert p.inv_max2 == F(1.0 / 16.0)
    full = B1.params(
        (1, 8, 16, 1), in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4,
        n_samples=1, exposure=1.0, reinhard=1.0, has_rotation=False,
    )
    assert (full.wrap, full.has_rotation, full.tonemap) == (1, 0, 0)


def test_library_name_keyed_on_sources(tmp_path, monkeypatch):
    from image_lens_reproject_torch.ops.cuda import build

    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k", ["k.cu"])
    assert first == build.library_path("k", ["k.cu"])
    (tmp_path / "k.cu").write_text("// two\n")
    assert build.library_path("k", ["k.cu"]) != first
    assert first.parent == build.BUILD_DIR


# --- on the card -----------------------------------------------------------


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
    assert B1.LAUNCHES == 1
    assert got.shape == want.shape
    # The BASELINE parity budget; B1 and the plain version differ only in
    # libm last-ulp differences between the fused kernel and PyTorch's ops.
    assert float((got - want).abs().max()) < 1e-3


@pytest.mark.gpu
def test_uncovered_combination_raises_on_card(cuda, launches):
    src = torch.zeros((1, 8, 16, 3), device=cuda)
    with pytest.raises(NotImplementedError, match="bilinear"):
        B1.remap_tonemap(src, None, in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4,
                         interp="bilinear")
    with pytest.raises(NotImplementedError, match="FisheyeEquidistant"):
        B1.remap_tonemap(src, None, in_lens=L.FisheyeEquidistant(math.pi, 36.0, 36.0),
                         out_lens=RECT, out_h=4, out_w=4)
    with pytest.raises(TypeError):
        B1.remap_tonemap(src.double(), None, in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4)
    with pytest.raises(ValueError):
        B1.remap_tonemap(src[:, :, ::2], None, in_lens=EQUIRECT, out_lens=RECT, out_h=4, out_w=4)
    assert B1.LAUNCHES == 0
