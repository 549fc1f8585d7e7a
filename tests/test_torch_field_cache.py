"""Kernel B1's coordinate field (ops/cuda/remap_kernel.py): its key, its
cache and when the launch wrapper fills, reads or bypasses a field.

The first tests need no card. The key and the cache are host code; the
wrapper's choice of launches is driven on tensors of torch's ``meta``
device (shapes, no data) that the launch setup takes for CUDA tensors,
with B1's library replaced by a recorder of the C calls. The tests marked ``gpu``
hold the field path's outputs against the direct path's, and the field's
coordinates against the plain path's, bit for bit on the card
(``python -m pytest --noconftest -m gpu tests/test_torch_field_cache.py``).
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda.build import COUNTS, reset_counts

EQUIRECT = L.full_equirectangular()
RECT = L.Rectilinear(35.0, 36.0, 36.0)
ROT = rotation_matrix_degrees(20.0, 5.0, 0.0)
SHAPE = (1, 96, 192, 3)
KW = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=54, out_w=96, interp="bicubic", n_samples=1,
          exposure=2.0, reinhard=4.0)
CPU = torch.device("cpu")


def _params(shape=SHAPE, rotation=ROT, **kw):
    return B1.params(shape, rotation=rotation, aligned=True, **dict(KW, **kw))


def _key(p, device=CPU, stream=0):
    return B1.field_key(p, device, stream)


def _next_bit(p, name, index=None):
    """``p`` with float32 field ``name`` (element ``index``) one ulp up."""
    arr = getattr(p, name)
    value = arr[index] if index is not None else arr
    bumped = float(np.nextafter(np.float32(value), np.float32(np.inf)))
    if index is not None:
        arr[index] = bumped
    else:
        setattr(p, name, bumped)
    return p


def test_equal_values_give_equal_keys():
    """Two params built apart from equal values (the rotation a fresh
    array) key alike, and the key holds the device and the stream."""
    a = _params()
    b = _params(rotation=np.array(ROT, dtype=np.float64))
    assert _key(a) == _key(b)
    assert hash(_key(a)) == hash(_key(b))
    assert _key(a, stream=1) != _key(a)
    assert _key(a, device=torch.device("meta")) != _key(a)


@pytest.mark.parametrize("change", [
    "rotation 0", "rotation 4", "rotation 8", "out_k", "in_k", "in_half_w", "offset",
])
def test_the_last_bit_of_a_float_the_field_reads_changes_the_key(change):
    p = _params()
    name, _, index = change.partition(" ")
    bumped = {"rotation": lambda: _next_bit(_params(), "rotation", int(index or 0)),
              "out_k": lambda: _next_bit(_params(), "out_k", 0),
              "in_k": lambda: _next_bit(_params(), "in_k", 2),
              "in_half_w": lambda: _next_bit(_params(), "in_half_w"),
              "offset": lambda: _next_bit(_params(), "offsets", 0)}[name]()
    assert _key(bumped) != _key(p)


@pytest.mark.parametrize("change", [
    dict(row_offset=8, row_count=16), dict(row_offset=0, row_count=16), dict(out_w=97),
    dict(out_h=55), dict(out_lens=L.FisheyeEquidistant(3.0, 36.0, 36.0)),
    dict(in_lens=L.Equirectangular(-2.0, 1.5, -1.2, 1.0)), dict(rotation=None),
], ids=["row0", "band_rows", "out_w", "out_h", "out_lens", "in_lens", "no_rotation"])
def test_band_size_lens_and_rotation_change_the_key(change):
    assert _key(_params(**change)) != _key(_params())


@pytest.mark.parametrize("change", [
    dict(shape=(4,) + SHAPE[1:]), dict(shape=SHAPE[:3] + (5,)), dict(interp="nearest"),
    dict(exposure=1.0, reinhard=1.0),
], ids=["batch", "channels", "interp", "tonemap"])
def test_what_the_coordinates_do_not_read_leaves_the_key(change):
    """The batch, the channels, the sampler and the tonemap are the read
    instance's, not the field's: one field serves them all."""
    assert _key(_params(**change)) == _key(_params())


def _field(n_floats):
    return torch.empty(n_floats, dtype=torch.float32)


def _held(cache, key):
    field, answer = cache.lookup(key, 400)
    assert (field is not None) == (answer == B1.FIELD_READ)
    return field is not None


def test_cache_evicts_the_least_recently_used_to_fit_its_cap():
    cache = B1.FieldCache(cap_bytes=3 * 400, seen_keys=8)
    for k in "abc":
        cache.put(k, _field(100))
    assert cache.bytes == 1200 and len(cache) == 3
    assert _held(cache, "a")  # now the most recently used
    cache.put("d", _field(100))
    assert not _held(cache, "b")
    assert all(_held(cache, k) for k in "acd")
    cache.put("e", _field(200))  # drops the two least recently used
    assert [k for k in "acde" if _held(cache, k)] == ["d", "e"]
    assert cache.bytes == 1200
    cache.put("e", _field(50))  # replaced, counted once
    assert cache.bytes == 600 and len(cache) == 2


def test_cache_remembers_a_bounded_number_of_first_sightings():
    cache = B1.FieldCache(cap_bytes=1 << 20, seen_keys=2)
    bypass, fill = (None, B1.FIELD_BYPASS), (None, B1.FIELD_FILL)
    assert cache.lookup("a", 16) == bypass
    assert cache.lookup("a", 16) == fill
    assert cache.lookup("a", 16) == bypass  # forgotten once filled: a third call starts over
    for k in "bcd":
        assert cache.lookup(k, 16) == bypass
    assert cache.lookup("b", 16) == bypass  # pushed out by c and d
    assert cache.lookup("d", 16) == fill
    field = _field(4)
    cache.put("d", field)
    assert cache.lookup("d", 16) == (field, B1.FIELD_READ)


@pytest.mark.parametrize("nbytes,second", [(1024, B1.FIELD_FILL), (1025, B1.FIELD_BYPASS)],
                         ids=["at the cap", "over the cap"])
def test_cache_fills_no_field_over_its_cap(nbytes, second):
    """A key's second sighting fills its field only where the field fits
    the cap; one over it bypasses at every call, a third starting over."""
    cache = B1.FieldCache(cap_bytes=1024)
    assert [cache.lookup("a", nbytes)[1] for _ in range(3)] == [
        B1.FIELD_BYPASS, second, B1.FIELD_BYPASS]


def test_cache_keeps_its_accounting_under_threads():
    """Sixteen threads putting, reading and sighting keys in one small cache
    (switching every 10 µs): the bytes it counts are the bytes it holds,
    within the cap."""
    import sys
    import threading

    cache = B1.FieldCache(cap_bytes=40 * 4 * 8, seen_keys=8)
    errors = []

    def work(t):
        try:
            for i in range(300):
                key = (t + i) % 24
                if cache.lookup(key, 32 * (1 + key % 3))[1] == B1.FIELD_FILL:
                    cache.put(key, _field(8 * (1 + key % 3)))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    held = sum(f.numel() * f.element_size() for f in cache._fields.values())
    assert cache.bytes == held <= cache.cap_bytes
    assert len(cache._seen) <= cache.seen_keys


class FakeLibrary:
    """B1's C entry points, recording each call's name and returning 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ilr_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(name) or 0


class CudaMeta(torch.Tensor):
    """A ``meta`` tensor that B1's launch setup takes for a CUDA one."""

    is_cuda = True


@pytest.fixture
def fake_card(monkeypatch):
    """B1's wrapper on ``CudaMeta`` batches: the whole launch setup, on
    stream 7 and with no graph capturing, a recording library, an empty
    field cache and the launch counts at 0 (restored after the test)."""
    lib = FakeLibrary()
    stream = types.SimpleNamespace(cuda_stream=7)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(B1, "library", lambda: lib)
    monkeypatch.setattr(B1, "FIELDS", B1.FieldCache())
    saved = COUNTS.copy()
    reset_counts()
    yield lib
    reset_counts()
    COUNTS.update(saved)


def _meta(shape=SHAPE):
    return torch.Tensor._make_subclass(CudaMeta, torch.empty(shape, device="meta"))


def _counters():
    """The launch counts (bypasses, fills, hits) of the coordinate field."""
    return COUNTS["b1.field_bypass"], COUNTS["b1.field_fill"], COUNTS["b1.field_hit"]


def test_first_call_direct_second_fills_third_reads(fake_card):
    batch = _meta()
    for _ in range(3):
        out = B1.remap_tonemap(batch, ROT, **KW)
        assert out.shape == (1, 54, 96, 3)
    assert fake_card.calls == ["ilr_remap_frame", "ilr_coord_field", "ilr_remap_field",
                               "ilr_remap_field"]
    assert _counters() == (1, 1, 1)
    assert COUNTS["b1.frame"] == 3
    (field,) = B1.FIELDS._fields.values()
    assert field.shape == (54, 96, 2) and field.dtype == torch.float32
    assert B1.FIELDS.bytes == 8 * 54 * 96


def test_one_field_serves_other_batches_channels_samplers_and_tonemaps(fake_card):
    B1.remap_tonemap(_meta(), ROT, **KW)
    B1.remap_tonemap(_meta((4, 96, 192, 3)), ROT, **KW)
    B1.remap_tonemap(_meta((2, 96, 192, 5)), ROT, **dict(KW, interp="bilinear"))
    B1.remap_tonemap(_meta(), ROT, **dict(KW, exposure=1.0, reinhard=1.0))
    assert _counters() == (1, 1, 2)
    assert len(B1.FIELDS) == 1


def test_each_band_has_a_field_of_its_own(fake_card):
    for _ in range(3):
        for j in range(3):
            B1.remap_tonemap(_meta(), ROT, row_offset=18 * j, row_count=18, **KW)
    assert _counters() == (3, 3, 3)
    assert COUNTS["b1.band"] == 9
    assert sorted(f.shape for f in B1.FIELDS._fields.values()) == [(18, 96, 2)] * 3


def test_a_rotation_that_changes_every_call_never_fills(fake_card):
    for deg in range(6):
        B1.remap_tonemap(_meta(), rotation_matrix_degrees(float(deg), 5.0, 0.0), **KW)
    assert _counters() == (6, 0, 0)
    assert fake_card.calls == ["ilr_remap_frame"] * 6
    assert len(B1.FIELDS) == 0


def test_a_field_over_the_cap_is_never_made(fake_card, monkeypatch):
    monkeypatch.setattr(B1, "FIELDS", B1.FieldCache(cap_bytes=8 * 54 * 96 - 1))
    for _ in range(3):
        B1.remap_tonemap(_meta(), ROT, **KW)
    assert _counters() == (3, 0, 0)
    assert fake_card.calls == ["ilr_remap_frame"] * 3


def test_no_field_is_filled_or_read_while_a_graph_captures(fake_card, monkeypatch):
    """Under capture a field would be filled only at a replay, or could be
    evicted before one: a configuration's second call fills nothing, and
    a configuration already filled reads nothing, until capture ends (the
    third captured call was a first sighting again, so the next call
    fills)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    for _ in range(3):
        B1.remap_tonemap(_meta(), ROT, **KW)
    assert fake_card.calls == ["ilr_remap_frame"] * 3
    assert _counters() == (2, 0, 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    B1.remap_tonemap(_meta(), ROT, **KW)
    B1.remap_tonemap(_meta(), ROT, **KW)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    B1.remap_tonemap(_meta(), ROT, **KW)
    assert fake_card.calls[3:] == ["ilr_coord_field", "ilr_remap_field", "ilr_remap_field",
                                   "ilr_remap_frame"]
    assert _counters() == (2, 1, 1)


def _rotation_stack():
    return np.stack([rotation_matrix_degrees(float(d), 0.0, 0.0) for d in (0, 90, 180)])


@pytest.mark.parametrize("bypass", ["stack", "n_samples", "device_rotation", "list"])
def test_bypasses_take_their_own_launch_and_no_field(fake_card, bypass):
    """A rotation stack (view mode), n x n supersampling, a rotation on a
    device and list mode launch as they did, three calls in a row, and
    neither fill nor count a field."""
    batch = _meta()
    want = {"stack": "ilr_remap_views", "n_samples": "ilr_remap_frame",
            "device_rotation": "ilr_remap_frame", "list": "ilr_remap_list"}[bypass]
    for _ in range(3):
        if bypass == "stack":
            B1.remap_tonemap(batch, _rotation_stack(), **KW)
        elif bypass == "n_samples":
            B1.remap_tonemap(batch, ROT, **dict(KW, n_samples=2))
        elif bypass == "device_rotation":
            B1.remap_tonemap(batch, torch.as_tensor(ROT, dtype=torch.float32, device="meta"),
                             **KW)
        else:
            tiles = torch.zeros((2, 2), dtype=torch.int32, device="meta")
            out = torch.empty((1, 54, 96, 3), device="meta")
            B1.remap_tonemap_list(batch, ROT, out, tiles, **KW)
    assert fake_card.calls == [want] * 3
    assert _counters() == (0, 0, 0)
    assert len(B1.FIELDS) == 0


def test_field_eligibility_reads_the_launch_constants():
    """From the launch constants' supersample count and rotation code
    (``launch_mode``): a frame or band of one supersample whose rotation
    is not on the card may use a field."""
    read = B1.FIELD_READ
    for code in (B1.NO_ROTATION, B1.ROTATION_BY_VALUE):
        assert B1.launch_mode(None, False, False, 1, code, False, read) == read
        assert B1.launch_mode(None, False, True, 1, code, False, read) == read
    assert B1.launch_mode(None, False, False, 3, B1.ROTATION_BY_VALUE, False, read) == B1.FRAME
    assert B1.launch_mode(None, False, True, 1, B1.ROTATION_ON_DEVICE, False, read) == B1.BAND


def test_the_key_covers_every_byte_the_coordinates_read():
    """The key's byte ranges cover exactly the fields named, with only the
    first supersample offset and the first rotation (the frame's)."""
    covered = set()
    for a, b in B1.FIELD_RANGES:
        covered.update(range(a, b))
    for name in ("out_lens", "in_lens", "out_k", "in_k", "out_half_w", "out_half_h",
                 "in_half_w", "in_half_h", "out_w", "out_h", "row0", "band_rows",
                 "has_rotation"):
        f = getattr(B1.RemapParams, name)
        assert set(range(f.offset, f.offset + f.size)) <= covered, name
    for name in ("batch", "channels", "interp", "tonemap", "exposure", "inv_max2",
                 "normalize", "spec_channels", "spec_samples", "in_h", "in_w", "wrap"):
        f = getattr(B1.RemapParams, name)
        assert not set(range(f.offset, f.offset + f.size)) & covered, name
    off, rot = B1.RemapParams.offsets.offset, B1.RemapParams.rotation.offset
    assert set(range(off, off + 4)) <= covered and off + 4 not in covered
    assert set(range(rot, rot + 36)) <= covered and rot + 36 not in covered
    assert ctypes.sizeof(B1.RemapParams) > rot + 36


# --- on the card -----------------------------------------------------------

EQUIDIST = L.FisheyeEquidistant(np.pi, 36.0, 36.0)
EQUISOLID = L.FisheyeEquisolid(15.0, np.pi, 36.0, 36.0)
STEREO = L.FisheyeStereographic(12.0, 3.0, 36.0, 24.0)
LENSES = [RECT, EQUIDIST, EQUISOLID, STEREO, EQUIRECT]
LENS_IDS = [type(s).__name__ for s in LENSES]


@pytest.fixture
def cuda(monkeypatch):
    """The card, with an empty field cache and the launch counts at 0
    (restored after the test)."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA only and this machine has no CUDA device")
    monkeypatch.setattr(B1, "FIELDS", B1.FieldCache())
    saved = COUNTS.copy()
    reset_counts()
    yield torch.device("cuda")
    reset_counts()
    COUNTS.update(saved)


def _assert_bit_equal(got, want):
    """Equal shapes, NaN at the same places, the same float32 bits elsewhere."""
    assert got.shape == want.shape
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _source(cuda, shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 2, shape).astype(np.float32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 4, 5])
@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("in_lens", LENSES, ids=LENS_IDS)
def test_field_path_equals_the_direct_path_on_card(cuda, in_lens, interp, c):
    """Each read instance (input lens x sampler x C = 3 / 4 / generic), at
    the full frame and at a band, with a rotation and without: the second
    call (fill, then read) and the third (read) give the first's direct
    output and the plain version's bit for bit."""
    out_lens = LENSES[(LENSES.index(in_lens) + 1) % len(LENSES)]
    src = _source(cuda, (2, 40, 80, c), seed=c)
    n = 0
    for rotation in (rotation_matrix_degrees(20.0, 5.0, -3.0), None):
        for band in (dict(), dict(row_offset=12, row_count=20)):
            kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=36, out_w=300, interp=interp,
                      n_samples=1, exposure=2.0, reinhard=4.0, **band)
            direct, filled, read = (B1.remap_tonemap(src, rotation, **kw) for _ in range(3))
            want = B1.remap_tonemap_plain(src, rotation, **kw)
            torch.cuda.synchronize()
            n += 1
            assert _counters() == (n, n, n)
            for got in (filled, read):
                _assert_bit_equal(got, direct)
            _assert_bit_equal(direct, want)
    assert B1.specialisation(src.shape, 1, src.data_ptr() % 16 == 0)[0] == (
        c if c in (3, 4) else B1.ANY_CHANNELS)


@pytest.mark.gpu
def test_three_calls_count_one_fill_and_one_hit_on_card(cuda):
    src = _source(cuda, (1, 48, 96, 3), seed=1)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=50, out_w=72)
    rot = rotation_matrix_degrees(20.0, 5.0, 0.0)
    outs = [B1.remap_tonemap(src, rot, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert _counters() == (1, 1, 1)
    assert len(B1.FIELDS) == 1 and B1.FIELDS.bytes == 8 * 50 * 72
    for got in outs[1:]:
        _assert_bit_equal(got, outs[0])
    # The same configuration under a rotation that changes every call: no fill.
    for deg in range(4):
        B1.remap_tonemap(src, rotation_matrix_degrees(float(deg), 1.0, 0.0), **kw)
    assert _counters() == (5, 1, 1)


@pytest.mark.gpu
def test_a_second_stream_fills_its_own_field_on_card(cuda):
    """The stream is part of the key: a configuration whose field the
    default stream holds fills another on a side stream (its second call
    there), and both streams' outputs equal the direct path's."""
    src = _source(cuda, (1, 48, 96, 4), seed=2)
    kw = dict(in_lens=EQUIRECT, out_lens=RECT, out_h=50, out_w=72, interp="bilinear")
    rot = rotation_matrix_degrees(10.0, -5.0, 0.0)
    main = [B1.remap_tonemap(src, rot, **kw) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        there = [B1.remap_tonemap(src, rot, **kw) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert _counters() == (2, 2, 2)
    assert len(B1.FIELDS) == 2
    for got in main[1:] + there:
        _assert_bit_equal(got, main[0])


@pytest.mark.gpu
@pytest.mark.parametrize("rotated", [True, False], ids=["rotation", "none"])
@pytest.mark.parametrize("out_lens", LENSES, ids=LENS_IDS)
@pytest.mark.parametrize("in_lens", LENSES, ids=LENS_IDS)
def test_coord_field_holds_the_plain_source_coords_on_card(cuda, in_lens, out_lens, rotated):
    """``coord_field`` of a band (rows [5, 41) of a 40-row frame, past its
    end) holds ``ops/remap.py::source_coords`` of each pixel centre, the
    same float32 bits (NaN where it gives NaN)."""
    from image_lens_reproject_torch.ops import remap

    rot = rotation_matrix_degrees(20.0, 5.0, -3.0) if rotated else None
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=40, out_w=100, interp="bicubic",
              n_samples=1, exposure=1.0, reinhard=1.0, row_offset=5, row_count=36)
    p = B1.params((1, 48, 96, 3), rotation=rot, aligned=True, **kw)
    field = torch.full((36, 100, 2), float("nan"), device=cuda)
    lib = B1.library()
    rc = lib.ilr_coord_field(field.data_ptr(), ctypes.byref(p), cuda.index or 0,
                             torch.cuda.current_stream().cuda_stream)
    B1.build.raise_on_error(lib, rc, "coordinate field kernel")
    cx = remap.pixel_centres(torch.arange(100, device=cuda)[None, :], 100)
    cy = remap.pixel_centres(torch.arange(5, 41, device=cuda)[:, None], 40)
    sx, sy = remap.source_coords(in_lens, out_lens, 48, 96, cx + 0.0, cy + 0.0,
                                 remap.rotation_tensor(rot, cuda), 40, 100)
    torch.cuda.synchronize()
    _assert_bit_equal(field[..., 0], sx.expand(36, 100))
    _assert_bit_equal(field[..., 1], sy.expand(36, 100))
