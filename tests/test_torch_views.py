"""The view axis: a ``(V, 3, 3)`` rotation stack through ``remap_tonemap_batch``.

A stack gives ``(B, V, out_h, out_w, C)``, view v the full frame under
rotation v. On the CPU the plain path computes it view by view; on the card
kernel B1's view mode computes every view in one launch. The cases here
hold each view to the call with that one rotation bit for bit, each face of
the cubemap8k configuration (``lens_bench/configs/cubemap8k.json``, cut to
a few pixels) to the benchmark's plain reference, the cube's faces to each
other, and the paths without a view axis to their refusal. The ``gpu``
cases launch the kernel and skip without a card:
``python -m pytest --noconftest -m gpu tests/test_torch_views.py``.
"""

import contextlib
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import plan as P
from image_lens_reproject_torch.ops import remap, remap_fused
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2
from image_lens_reproject_torch.ops.cuda.build import COUNTS
from image_lens_reproject_torch.parallel import batch as pbatch
from image_lens_reproject_torch.parallel import mesh as pmesh

ROOT = Path(__file__).resolve().parents[1]
CUBEMAP = json.loads((ROOT / "lens_bench/configs/cubemap8k.json").read_text())
FACES = dict(zip(CUBEMAP["view_names"], CUBEMAP["views_deg"]))
EQUIRECT = L.full_equirectangular()
FACE_LENS = L.Rectilinear(**{k: v for k, v in CUBEMAP["out_lens"].items() if k != "type"})
# The face centres' rays in this repository's frame: +x the equirect's
# right half, +y its lower half, the camera looking down -z.
CENTRES = {"right": (1, 0, 0), "left": (-1, 0, 0), "up": (0, -1, 0), "down": (0, 1, 0),
           "front": (0, 0, -1), "back": (0, 0, 1)}


def stack() -> np.ndarray:
    """The faces' rotations as one float32 (6, 3, 3), in the configuration's order."""
    return np.stack([rotation_matrix_degrees(*view) for view in FACES.values()])


def frames(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 2.0, (b, h, w, c)).astype(np.float32))


def kwargs(out=24, interp="bilinear", **extra):
    return dict(in_lens=EQUIRECT, out_lens=FACE_LENS, out_h=out, out_w=out, interp=interp,
                **extra)


def assert_bit_equal(got, want):
    """Equal shapes, NaN at the same places, max abs 0 on the rest."""
    assert got.shape == want.shape
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_plain_view_stack_equals_one_call_a_view(interp, c, batch):
    src = frames(batch, 64, 128, c, seed=c + 10 * batch)
    kw = kwargs(interp=interp, exposure=2.0, reinhard=4.0)
    views = stack()
    got = remap_fused.remap_tonemap_batch(src, views, **kw)
    assert got.shape == (batch, 6, 24, 24, c)
    for v in range(6):
        assert_bit_equal(got[:, v], remap_fused.remap_tonemap_batch(src, views[v], **kw))


def _reference_config(name):
    """cubemap8k cut to a 128 x 256 source and 48 x 48 faces, with one
    face's rotation, for ``lens_bench.reference.remap``."""
    return dict(CUBEMAP, src_h=128, src_w=256, out_h=48, out_w=48,
                rotation_deg=list(FACES[name]))


@pytest.mark.parametrize("name", list(FACES))
def test_each_face_matches_the_benchmark_reference(name):
    """Poles (up, down) and the seam (back) included, nothing masked."""
    from lens_bench.reference import remap as ref

    src = frames(2, 128, 256, 3, seed=5)
    got = remap_fused.remap_tonemap_batch(src, stack(), **kwargs(out=48))
    want = ref.remap(src, _reference_config(name))
    face = got[:, list(FACES).index(name)]
    assert torch.isfinite(face).all() and torch.isfinite(want).all()
    err = (face - want).abs().flatten()
    assert float(err.max()) < 1e-3
    assert float(torch.quantile(err, 0.999)) < 1e-4


def test_face_centres_point_along_the_axes():
    """Each face's rotation takes the camera's -z ray to its axis, and its
    centre lands where that axis lies in the 8K equirect: right at three
    quarters of the width, up at the top row, back at the seam."""
    in_h, in_w = CUBEMAP["src_h"], CUBEMAP["src_w"]
    want_source = {"right": (0.75 * in_w, 0.5 * in_h), "left": (0.25 * in_w, 0.5 * in_h),
                   "up": (None, 0.0), "down": (None, in_h), "front": (0.5 * in_w, 0.5 * in_h),
                   "back": (0.0, 0.5 * in_h)}
    for name in FACES:
        r = torch.as_tensor(rotation_matrix_degrees(*FACES[name]))
        ray = r @ torch.tensor([0.0, 0.0, -1.0])
        np.testing.assert_allclose(ray.numpy(), CENTRES[name], atol=1e-6)
        sx, sy = remap.source_coords(EQUIRECT, FACE_LENS, in_h, in_w, torch.zeros(1),
                                     torch.zeros(1), r, 1920, 1920)
        wx, wy = want_source[name]
        if wx is not None:
            dx = abs(float(sx) + 0.5 - wx) % in_w
            assert min(dx, in_w - dx) < 1.0, (name, float(sx))
        assert abs(float(sy) + 0.5 - wy) < 1.0, (name, float(sy))


def _edges(name, n=33):
    """{edge: (sx, sy)} of points along each edge of a 1920 x 1920 face,
    at the edge itself, in the 8K source (remap.source_coords)."""
    half = 960.0
    t = torch.linspace(-half, half, n)
    r = torch.as_tensor(rotation_matrix_degrees(*FACES[name]))
    out = {}
    for edge, (cx, cy) in {"left": (torch.full_like(t, -half), t),
                           "right": (torch.full_like(t, half), t),
                           "top": (t, torch.full_like(t, -half)),
                           "bottom": (t, torch.full_like(t, half))}.items():
        out[edge] = remap.source_coords(EQUIRECT, FACE_LENS, CUBEMAP["src_h"], CUBEMAP["src_w"],
                                        cx, cy, r, 1920, 1920)
    return out


def test_adjacent_faces_meet_within_half_a_source_pixel():
    """Every edge of every face meets exactly one edge of another face:
    the points along both map to source points within half a pixel of the
    8K source (across the seam too)."""
    in_w = CUBEMAP["src_w"]
    edges = {(f, e): xy for f in FACES for e, xy in _edges(f).items()}

    def apart(a, b):
        dx = (a[0] - b[0]).abs() % in_w
        return torch.maximum(torch.minimum(dx, in_w - dx), (a[1] - b[1]).abs()).max()

    for (f, e), xy in edges.items():
        matches = [(g, e2) for (g, e2), uv in edges.items() if g != f and min(
            float(apart(xy, uv)), float(apart(xy, (uv[0].flip(0), uv[1].flip(0))))) < 0.5]
        assert len(matches) == 1, (f, e, matches)
    assert len(edges) == 24


@pytest.mark.parametrize("kind", ["list", "cpu-tensor", "float64"])
def test_host_stacks_of_every_kind_give_the_same_bits(kind):
    views = stack()
    given = {"list": views.tolist(), "cpu-tensor": torch.from_numpy(views),
             "float64": views.astype(np.float64)}[kind]
    src = frames(1, 64, 128, 3, seed=1)
    kw = kwargs()
    assert_bit_equal(remap_fused.remap_tonemap_batch(src, given, **kw),
                     remap_fused.remap_tonemap_batch(src, views, **kw))
    np.testing.assert_array_equal(B1.host_rotations(given), views)


@pytest.mark.parametrize("shape", [(3,), (6, 3), (6, 3, 4), (0, 3, 3)],
                         ids=["3", "V-3", "V-3-4", "0-3-3"])
def test_a_stack_of_another_shape_raises(shape):
    src = frames(1, 64, 128, 3)
    with pytest.raises(ValueError):
        remap_fused.remap_tonemap_batch(src, np.zeros(shape, np.float32), **kwargs())
    with pytest.raises(ValueError):
        B1.host_rotations(np.zeros(shape, np.float32))


def _refused(mode, src, views, kw):
    """One call of ``mode`` with the stack ``views``, on the CPU."""
    if mode == "band":
        return remap_fused.remap_tonemap_batch(src, views, row_offset=8, row_count=8, **kw)
    if mode == "list":
        out = torch.zeros((1, kw["out_h"], kw["out_w"], 3))
        tiles = torch.tensor([[0, 0]], dtype=torch.int32)
        return B1.remap_tonemap_list(src, views, out, tiles, **kw)
    if mode == "windows":
        out = torch.zeros((1, kw["out_h"], kw["out_w"], 3))
        entries = torch.zeros((1, 6), dtype=torch.int32)
        return B2.remap_windows(src, views, out, entries, split=False,
                                misses=B2.new_misses("cpu"), **kw)
    if mode == "planned":
        plan = P.make_plan(None, in_h=64, in_w=128, channels=3, device="cpu",
                           **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w",
                                                 "interp")})
        return remap_fused.remap_tonemap_planned_batch(src, views, plan,
                                                       misses=B2.new_misses("cpu"), **kw)
    if mode == "plan":
        return P.make_plan(views, in_h=64, in_w=128, channels=3, device="cpu",
                           **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w",
                                                 "interp")})
    mesh = pmesh.make_mesh([torch.device("cpu")] * 2, 1, 2)
    return pbatch.sharded_remap_step(pbatch.shard_batch(src, mesh), views, mesh=mesh, **kw)


@pytest.mark.parametrize("mode", ["band", "list", "windows", "planned", "plan", "mesh"])
def test_paths_without_a_view_axis_refuse_a_stack(mode):
    src = frames(1, 64, 128, 3)
    with pytest.raises(ValueError, match="view axis"):
        _refused(mode, src, stack(), kwargs(out=32))


class _FakeViews:
    """Stands for B1's library: records each ``ilr_remap_views`` call."""

    def __init__(self):
        self.calls = []

    def ilr_remap_views(self, src, dst, rot, views, p, device, stream):
        self.calls.append((dst, rot, views, p._obj.has_rotation, bytes(p._obj.rotation)))
        return 0


class _CudaMeta(torch.Tensor):
    """A ``meta`` tensor that B1's launch setup takes for a CUDA one."""

    is_cuda = True


@pytest.mark.parametrize("views,where,by_value", [
    (6, "numpy", True), (16, "numpy", True), (40, "numpy", False), (40, "card", False),
])
def test_view_launches_are_counted_and_split_by_value(monkeypatch, views, where, by_value):
    """Every stack is one launch over every view of the output, counted in
    ``b1.views`` and ``b1.views_computed``. A host stack of up to
    ``MAX_VIEWS_BY_VALUE`` views goes in the launch constants, row-major a
    view with torch's float32 bits, and the launch passes no pointer; a
    larger host stack, or one on a device (a ``meta`` tensor stands for a
    CUDA one, and for the card the host stack is copied to), goes through
    its pointer. The wrapper runs whole, on a ``meta`` batch it takes for a
    CUDA one, with a recording library; a larger host stack's copy is seen
    by a spy on ``Tensor.to``, which holds the float32 values it copies
    (a ``meta`` tensor's pointer is 0: ``test_more_views_than_go_by_value_on_card``
    holds the pointer's values on the card)."""
    host = np.stack([rotation_matrix_degrees(9.0 * k, 4.0 * k - 50.0, k) for k in range(views)])
    given = torch.from_numpy(host).to("meta") if where == "card" else host.astype(np.float64)
    src = torch.Tensor._make_subclass(_CudaMeta, torch.empty((2, 8, 16, 3), device="meta"))
    lib = _FakeViews()
    stream = types.SimpleNamespace(cuda_stream=7)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(B1, "library", lambda: lib)
    rounded, real = [], B1.host_rotations
    monkeypatch.setattr(B1, "host_rotations", lambda r: rounded.append(real(r)) or rounded[-1])
    copies, real_to = [], torch.Tensor.to

    def to(self, *args, **kw):
        copies.append((self, real_to(self, *args, **kw)))
        return copies[-1][1]
    monkeypatch.setattr(torch.Tensor, "to", to)
    if where == "numpy" and not by_value:
        with pytest.raises(ValueError, match="do not fit"):
            B1.set_rotations(B1.RemapParams(), real(given))
    before = COUNTS["b1.views"], COUNTS["b1.views_computed"]
    out = B1.remap_tonemap(src, given, **kwargs(out=4))
    assert (COUNTS["b1.views"], COUNTS["b1.views_computed"]) == (before[0] + 1, before[1] + views)
    assert out.shape == (2, views, 4, 4, 3)
    ((dst, ptr, n, code, constants),) = lib.calls
    assert dst == out.data_ptr() and n == views
    if by_value:
        assert ptr is None and code == B1.ROTATION_BY_VALUE
        want = torch.as_tensor(given, dtype=torch.float32).numpy().tobytes()
        assert constants[:len(want)] == want and not any(constants[len(want):])
    else:
        assert ptr is not None and code == B1.ROTATION_ON_DEVICE and not any(constants)
        ((copied_from, copied),) = [c for c in copies if c[1].data_ptr() == ptr]
        assert copied.device == src.device and copied.dtype == torch.float32
        if where == "numpy":  # the host stack, copied to the batch's device as float32
            assert torch.equal(copied_from, torch.from_numpy(host.astype(np.float32)))
        else:
            assert copied_from is given
    # A host stack is rounded once, by value or before its copy to the card.
    assert [r.tobytes() for r in rounded] == ([host.tobytes()] if where == "numpy" else [])


def test_view_mode_builds_once_for_each_input_lens():
    """View mode is built in the frame's units: no sources of its own."""
    units = [u for u in B1.SOURCES if not isinstance(u, str)]
    assert [u[0] for u in units] == ["remap_frame.cu"] * 5
    assert sorted(u[1] for u in units) == sorted(
        (f"ILR_IN_LENS={code}",) for code in B1.LENS_CODES.values())
    assert B1.MAX_VIEWS_BY_VALUE >= 6


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_the_smoke_s_footprint_of_a_stack_is_the_union_of_its_views(interp):
    """``chip_smoke.remap_footprint`` of the six faces (the bound of its
    view phase) counts each texel any face reads once, as the benchmark's
    view roofline (``b1_roofline_pct.views``, from the reference) counts
    them, and every face's pixels."""
    import importlib.util

    import chip_smoke

    cpu = torch.device("cpu")
    cfg = dict(CUBEMAP, src_h=40, src_w=80, out_h=16, out_w=16, interp=interp)
    spec = importlib.util.spec_from_file_location(
        "views_roofline", ROOT / "lens_bench/metrics/b1_roofline_pct.views.py")
    roof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roof)
    got = chip_smoke.remap_footprint((40, 80), stack(), kwargs(out=16, interp=interp), cpu)
    assert got == roof.union_footprint(cfg, cpu)
    singles = [chip_smoke.remap_footprint((40, 80), r, kwargs(out=16, interp=interp), cpu)[0]
               for r in stack()]
    assert max(singles) < got[0] < sum(singles) and got[1] == 6 * 16 * 16


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA only and this machine has no CUDA device")
    return torch.device("cuda")


def _card_case(cuda, batch, c, interp, seed=3):
    """A batch on the card (a 200 x 400 source, 60 x 72 faces: blocks cut at
    both edges) and its launch arguments."""
    src = frames(batch, 200, 400, c, seed=seed).to(cuda)
    kw = dict(kwargs(interp=interp, exposure=2.0, reinhard=4.0), out_h=60, out_w=72)
    return src, kw


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["numpy", "cuda"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_view_launch_equals_one_launch_a_view_on_card(cuda, interp, c, batch, where):
    """One view-mode launch gives every view bit for bit as B1's full frame
    under that rotation, and as the plain path."""
    src, kw = _card_case(cuda, batch, c, interp)
    views = stack()
    given = views if where == "numpy" else torch.from_numpy(views).to(cuda)
    before = COUNTS["b1.views"], COUNTS["b1.views_computed"]
    got = remap_fused.remap_tonemap_batch(src, given, **kw)
    assert (COUNTS["b1.views"], COUNTS["b1.views_computed"]) == (before[0] + 1, before[1] + 6)
    for v in range(6):
        assert_bit_equal(got[:, v], remap_fused.remap_tonemap_batch(src, views[v], **kw))
    plain = B1.remap_tonemap_plain(src, views, **kw)
    torch.cuda.synchronize()
    assert_bit_equal(got, plain)


@pytest.mark.gpu
def test_the_8k_cubemap_on_card(cuda):
    """The cubemap8k configuration itself: 7680 x 3840 in, six 1920^2 faces,
    one launch, each face the single-rotation launch bit for bit."""
    src = frames(1, CUBEMAP["src_h"], CUBEMAP["src_w"], 3, seed=8).to(cuda)
    kw = kwargs(out=1920)
    views = stack()
    before = COUNTS["b1.views"], COUNTS["b1.views_computed"]
    got = remap_fused.remap_tonemap_batch(src, views, **kw)
    assert (COUNTS["b1.views"], COUNTS["b1.views_computed"]) == (before[0] + 1, before[1] + 6)
    for v in range(6):
        assert_bit_equal(got[:, v], remap_fused.remap_tonemap_batch(src, views[v], **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("where,launches", [("numpy", 1), ("cuda", 1)])
def test_more_views_than_go_by_value_on_card(cuda, where, launches):
    """20 views, more than go by value: one launch through a pointer, the
    host stack copied to the card first; every view bit for bit its single
    launch."""
    src, kw = _card_case(cuda, 2, 3, "bilinear")
    views = np.stack([rotation_matrix_degrees(18.0 * k, 7.0 * k - 60.0, 3.0 * k)
                      for k in range(20)])
    given = views if where == "numpy" else torch.from_numpy(views).to(cuda)
    before = COUNTS["b1.views"]
    got = remap_fused.remap_tonemap_batch(src, given, **kw)
    assert COUNTS["b1.views"] == before + launches
    for v in range(20):
        assert_bit_equal(got[:, v], remap_fused.remap_tonemap_batch(src, views[v], **kw))


@pytest.mark.gpu
def test_numpy_stack_makes_no_synchronising_call_on_card(cuda):
    src, kw = _card_case(cuda, 1, 3, "bilinear")
    want = remap_fused.remap_tonemap_batch(src, stack(), **kw)  # built and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = remap_fused.remap_tonemap_batch(src, stack(), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert_bit_equal(got, want)


@pytest.mark.gpu
def test_numpy_stack_call_replays_in_a_cuda_graph_on_card(cuda):
    src, kw = _card_case(cuda, 2, 4, "bicubic")
    views = stack()
    eager = remap_fused.remap_tonemap_batch(src, views, **kw)  # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = remap_fused.remap_tonemap_batch(src, views, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert_bit_equal(captured, eager)
    src.mul_(0.5)
    graph.replay()
    eager = remap_fused.remap_tonemap_batch(src, views, **kw)
    torch.cuda.synchronize()
    assert_bit_equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("profiled", [False, True])
def test_view_spans_only_while_a_profiler_runs_on_card(cuda, profiled):
    from image_lens_reproject_torch.utils import tracing

    src, kw = _card_case(cuda, 1, 3, "bilinear")
    remap_fused.remap_tonemap_batch(src, stack(), **kw)  # built and warm
    torch.cuda.synchronize()
    tracing.reset_zones()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext():
        remap_fused.remap_tonemap_batch(src, stack(), **kw)
        torch.cuda.synchronize()
    got = {k: n for k, (_, n) in tracing.zone_totals().items() if k.startswith("b1.")}
    names = ("b1.wrapper", "b1.rotation", "b1.params", "b1.views", "b1.launch")
    assert got == ({k: 1 for k in names} if profiled else {})
    tracing.reset_zones()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["band", "list", "windows"])
def test_card_paths_without_a_view_axis_refuse_a_stack_on_card(cuda, mode):
    src, kw = _card_case(cuda, 1, 3, "bilinear")
    kw = dict(kw, out_h=32, out_w=32)
    if mode == "band":
        call = lambda: B1.remap_tonemap(src, stack(), row_offset=8, row_count=8, **kw)  # noqa
    elif mode == "list":
        out = torch.zeros((1, 32, 32, 3), device=cuda)
        tiles = torch.tensor([[0, 0]], dtype=torch.int32, device=cuda)
        call = lambda: B1.remap_tonemap_list(src, stack(), out, tiles, **kw)  # noqa
    else:
        out = torch.zeros((1, 32, 32, 3), device=cuda)
        entries = torch.zeros((1, 6), dtype=torch.int32, device=cuda)
        call = lambda: B2.remap_windows(src, stack(), out, entries, split=False,  # noqa
                                        misses=B2.new_misses(cuda), **kw)
    with pytest.raises(ValueError, match="view axis"):
        call()
