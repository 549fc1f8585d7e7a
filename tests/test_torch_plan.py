"""The sub-tile plan of the planned path (ops/plan.py) and the planned path's plain versions.

On the CPU everything here runs the plain versions: the plan's lists and
windows, B2's plain version (B1 list mode's plain version plus the count
of reads outside their windows) and B1 list mode's plain version.

Shapes are chosen so that PyTorch's CPU kernels compute every element with
their vector code: they compute a loop's tail elements with scalar libm,
whose atan2 differs from the vector atan2 in the last bit, so a frame and
a list of sub-tiles agree bit for bit on the CPU only when neither has
such a tail (output widths a multiple of 32, fewer than 32768 elements per
op). On the card every element runs the same code.
"""

import math

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import plan as P
from image_lens_reproject_torch.ops import remap, remap_fused, sampling
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

F = np.float32
EQUIRECT = L.full_equirectangular()
EQUISOLID = L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)

# name: in_lens, out_lens, in_h, in_w, C, out_h, out_w, interp, rotation, n_samples
CASES = {
    "headline": (EQUIRECT, L.Rectilinear(35.0, 36.0, 36.0 * 40 / 256), 48, 96, 3, 40, 256,
                 "bicubic", (20.0, 5.0, 0.0), 1),
    "seam": (EQUIRECT, L.Rectilinear(35.0, 36.0, 36.0 * 40 / 256), 48, 96, 3, 40, 256,
             "bicubic", (180.0, 5.0, 0.0), 1),
    "partial-equirect-nearest": (L.Equirectangular(-2.0, 1.5, -1.2, 1.0),
                                 L.Rectilinear(20.0, 36.0, 24.0), 48, 96, 5, 36, 160, "nearest",
                                 (10.0, 0.0, 0.0), 2),
    "cfg1-equidistant-rect": (L.FisheyeEquidistant(math.pi, 36.0, 36.0),
                              L.Rectilinear(35.0, 36.0, 36.0 * 36 / 64), 64, 64, 3, 36, 192,
                              "bilinear", None, 1),
    "cfg2-equisolid-equirect": (EQUISOLID, EQUIRECT, 64, 64, 3, 44, 256, "bilinear",
                                (30.0, 10.0, 5.0), 1),
    "cfg4-rect-equisolid-rgbz": (L.Rectilinear(50.0, 36.0, 36.0), EQUISOLID, 64, 64, 4, 64, 128,
                                 "bilinear", None, 1),
}
# A budget small enough that each case has sub-tiles in more than one list.
SMALL_BUDGET = 4096
# cfg2 at a size where some sub-tiles' two halves fit where the whole does
# not, at half the default budget (the seam and polar-arc sub-tiles the
# JAX package's split rescue was made for).
SPLIT_CASE = (EQUISOLID, EQUIRECT, 256, 256, 3, 256, 512, "bilinear", (30.0, 10.0, 5.0), 1)
SPLIT_BUDGET = 48 * 1024


def _unpack(case):
    in_lens, out_lens, in_h, in_w, c, out_h, out_w, interp, rot, n = case
    rot = None if rot is None else rotation_matrix_degrees(*rot)
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w, interp=interp,
              n_samples=n)
    return rot, (in_h, in_w, c), kw


def _plan(case, budget=P.WINDOW_BUDGET_BYTES, split=True):
    rot, (in_h, in_w, c), kw = _unpack(case)
    return P.make_plan(rot, in_h=in_h, in_w=in_w, channels=c, split=split, budget_bytes=budget,
                       device="cpu", **kw)


def _source(case, batch=2, seed=0):
    _, (in_h, in_w, c), _ = _unpack(case)
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 2, (batch, in_h, in_w, c)).astype(F))


def _all_cases():
    cases = [(name, case, budget) for name, case in CASES.items()
             for budget in (P.WINDOW_BUDGET_BYTES, SMALL_BUDGET)]
    return cases + [("split", SPLIT_CASE, SPLIT_BUDGET)]


ALL = _all_cases()
ALL_IDS = [f"{name}-{budget}" for name, _, budget in ALL]


@pytest.mark.parametrize("name,case,budget", ALL, ids=ALL_IDS)
@pytest.mark.parametrize("split", [True, False])
def test_lists_partition_the_subtile_grid(name, case, budget, split):
    plan = _plan(case, budget, split)
    _, _, kw = _unpack(case)
    n_ty, n_tx = -(-kw["out_h"] // 8), -(-kw["out_w"] // 128)
    assert plan.grid == (n_ty, n_tx)
    assert plan.rescue.shape[1:] == (6,) and plan.split.shape[1:] == (10,)
    assert plan.direct.shape[1:] == (2,)
    assert all(t.dtype == torch.int32 for t in (plan.rescue, plan.split, plan.direct))
    count = torch.zeros(n_ty, n_tx, dtype=torch.int64)
    for lst in (plan.rescue, plan.split, plan.direct):
        count.index_put_((lst[:, 0].long(), lst[:, 1].long()), torch.ones(len(lst), dtype=torch.int64),
                         accumulate=True)
    assert (count == 1).all(), "every sub-tile in exactly one list"
    if not split:
        assert plan.split.shape[0] == 0
    # Windows within the budget, and the sizes B2 is launched with.
    floats = plan.rescue[:, 3].long() * plan.rescue[:, 5].long() * _unpack(case)[1][2]
    assert (floats <= budget // 4).all()
    assert plan.rescue_floats == (int(floats.max()) if len(floats) else 0)
    halves = plan.split[:, 2:].view(-1, 2, 4).long()
    half_floats = halves[..., 1] * halves[..., 3] * _unpack(case)[1][2]
    assert (half_floats <= budget // 8).all()
    assert plan.split_floats == (int(half_floats.sum(-1).max()) if len(half_floats) else 0)


def test_plan_defaults_to_the_card():
    """Plans are made where the kernels run unless a caller asks for the CPU."""
    import inspect

    for fn in (P.make_plan, P.windows):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_split_case_has_all_three_lists():
    sizes = _plan(SPLIT_CASE, SPLIT_BUDGET).sizes()
    assert sizes["rescue"] > 0 and sizes["split"] > 0 and sizes["direct"] > 0
    off = _plan(SPLIT_CASE, SPLIT_BUDGET, split=False).sizes()
    assert off["split"] == 0 and off["rescue"] == sizes["rescue"]
    assert off["direct"] == sizes["direct"] + sizes["split"]


def _frame_taps(case):
    """Every tap of every in-frame pixel over every supersample offset, from
    the full-frame fields: (rows, cols) lists of (out_h, out_w) tensors."""
    rot, (in_h, in_w, _), kw = _unpack(case)
    wrap = L.wrap_mode_for_input(kw["in_lens"])
    r = remap.rotation_tensor(rot, "cpu")
    cx = remap.pixel_centres(torch.arange(kw["out_w"]), kw["out_w"])[None, :]
    cy = remap.pixel_centres(torch.arange(kw["out_h"]), kw["out_h"])[:, None]
    rows, cols = [], []
    for ox in remap.supersample_offsets(kw["n_samples"]):
        for oy in remap.supersample_offsets(kw["n_samples"]):
            sx, sy = remap.source_coords(kw["in_lens"], kw["out_lens"], in_h, in_w, cx + ox,
                                         cy + oy, r, kw["out_h"], kw["out_w"])
            sx, sy = (t.expand(kw["out_h"], kw["out_w"]) for t in torch.broadcast_tensors(sx, sy))
            cols += sampling.x_taps(sx, in_w, kw["interp"], wrap).idx
            rows += sampling.y_taps(sy, in_h, kw["interp"]).idx
    return rows, cols, in_w, wrap


def _check_inside(window, rows, cols, in_w, wrap):
    row0, nrows, col0, ncols = (int(v) for v in window)
    for r in rows:
        assert ((r >= row0) & (r < row0 + nrows)).all()
    for c in cols:
        local = c - col0
        if wrap:
            local = torch.where(local < 0, local + in_w, local)
        assert ((local >= 0) & (local < ncols)).all()


@pytest.mark.parametrize("name,case,budget", ALL, ids=ALL_IDS)
def test_every_tap_lies_inside_its_window(name, case, budget):
    plan = _plan(case, budget)
    rows, cols, in_w, wrap = _frame_taps(case)

    def pixels(ty, tx, x0, x1):
        ys = slice(ty * 8, ty * 8 + 8)
        xs = slice(tx * 128 + x0, tx * 128 + x1)
        return [r[ys, xs] for r in rows], [c[ys, xs] for c in cols]

    for e in plan.rescue.tolist():
        _check_inside(e[2:6], *pixels(e[0], e[1], 0, 128), in_w, wrap)
    for e in plan.split.tolist():
        _check_inside(e[2:6], *pixels(e[0], e[1], 0, 64), in_w, wrap)
        _check_inside(e[6:10], *pixels(e[0], e[1], 64, 128), in_w, wrap)
    # B2's plain version counts the same reads B2 would: none.
    src = _source(case, batch=1)
    rot, _, kw = _unpack(case)
    for entries, split in ((plan.rescue, False), (plan.split, True)):
        if len(entries):
            assert int(P.misses_plain(src, rot, entries, split=split, **kw)) == 0


def test_seam_subtiles_get_one_short_unwrapped_window():
    """Panned 180 degrees, the 360-degree seam runs down the middle of the
    output: the sub-tiles across it read columns near 0 and near W - 1, and
    their windows run past W - 1 on to column 0 instead of spanning the
    whole row."""
    rot, (in_h, in_w, _), kw = _unpack(CASES["seam"])
    whole, _ = P.windows(rot, in_h=in_h, in_w=in_w, device="cpu", **kw)
    rows, cols, _, _ = _frame_taps(CASES["seam"])
    crossing = 0
    for ty in range(whole.shape[0]):
        for tx in range(whole.shape[1]):
            c = torch.stack([t[ty * 8:ty * 8 + 8, tx * 128:tx * 128 + 128] for t in cols])
            row0, nrows, col0, ncols = whole[ty, tx].tolist()
            assert ncols <= in_w // 4, "a short arc, never most of the row"
            if int(c.min()) < 8 and int(c.max()) > in_w - 8:
                crossing += 1
                assert col0 + ncols > in_w, "the window wraps past the seam"
    assert crossing > 0


@pytest.mark.parametrize("name,case,budget", ALL, ids=ALL_IDS)
def test_planned_plain_path_equals_unplanned_bit_for_bit(name, case, budget):
    rot, _, kw = _unpack(case)
    src = _source(case)
    kw = dict(kw, exposure=2.0, reinhard=4.0)
    plan = _plan(case, budget)
    misses = B2.new_misses("cpu")
    got = remap_fused.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw)
    want = remap_fused.remap_tonemap_batch(src, rot, **kw)
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert int(misses) == 0


def test_list_mode_writes_only_its_subtiles():
    case = CASES["headline"]
    rot, _, kw = _unpack(case)
    src = _source(case)
    out = torch.full((2, kw["out_h"], kw["out_w"], 3), -5.0)
    tiles = torch.tensor([[0, 1], [4, 0], [4, 1]], dtype=torch.int32)  # row 4 is clipped at 40
    B1.remap_tonemap_list(src, rot, out, tiles, **kw)
    want = remap_fused.remap_tonemap_batch(src, rot, **kw)
    written = torch.zeros(kw["out_h"], kw["out_w"], dtype=torch.bool)
    written[0:8, 128:256] = True
    written[32:40, :] = True
    assert torch.equal(out[:, written], want[:, written])
    assert (out[:, ~written] == -5.0).all()


def test_plain_version_counts_reads_outside_a_window():
    case = CASES["headline"]
    rot, _, kw = _unpack(case)
    plan = _plan(case)
    src = _source(case, batch=2)
    bad = plan.rescue.clone()
    bad[0, 5] = 1  # one column wide: the sub-tile's other columns miss
    misses = B2.new_misses("cpu")
    out = torch.zeros(2, kw["out_h"], kw["out_w"], 3)
    B2.remap_windows(src, rot, out, bad[:1], split=False, misses=misses, window_floats=1, **kw)
    n = int(misses)
    assert n > 0
    # Counted per (row tap, column tap) pair, channel and image, as B2 counts.
    assert n % (2 * 3) == 0
    # The values themselves come from the source, not the window.
    want = remap_fused.remap_tonemap_batch(src, rot, **kw)
    assert torch.equal(out[:, :8, :128], want[:, :8, :128])


def test_plan_checks_the_batch_it_serves():
    plan = _plan(CASES["headline"])
    rot, _, kw = _unpack(CASES["headline"])
    misses = B2.new_misses("cpu")
    with pytest.raises(ValueError, match="source"):
        remap_fused.remap_tonemap_planned_batch(torch.zeros(1, 48, 96, 4), rot, plan,
                                                misses=misses, **kw)
    with pytest.raises(ValueError, match="grid"):
        remap_fused.remap_tonemap_planned_batch(torch.zeros(1, 48, 96, 3), rot, plan,
                                                misses=misses, **dict(kw, out_h=80))
