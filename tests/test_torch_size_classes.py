"""Kernel B2's launch layout on the CPU: the plan's size classes, the batch
grouping, the instance rule and the staging of a window.

B2 (``csrc/rescue_kernel.cu``, ``csrc/rescue_windows.cu``) runs only on a
card; here its plain version and a numpy transcription of its staging are
held to what the kernel relies on:

- ``ops/plan.py`` sorts the rescue and split lists into size classes, each
  class's windows within the bytes B2 reserves for it, without moving a
  sub-tile from one list to another;
- the planned path's plain version equals the unplanned path's bit for bit
  at batch 1 and 3 (output widths a multiple of 32: see
  ``tests/test_torch_plan.py`` on PyTorch's CPU tails);
- B2's instance follows B1's rule, and a CTA takes the whole batch only
  where its windows fit;
- ``stage<V>``'s (row, chunk) stepping copies every texel of a window
  once, from 16-byte aligned addresses inside the window's rows, to where
  ``WindowFetch`` reads it.
"""

import math

import numpy as np
import pytest
import torch

from image_lens_reproject_torch.models import lens as L
from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
from image_lens_reproject_torch.ops import plan as P
from image_lens_reproject_torch.ops import remap_fused
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

F = np.float32
EQUIRECT = L.full_equirectangular()
EQUISOLID = L.FisheyeEquisolid(15.0, math.pi, 36.0, 36.0)

# BASELINE configs 2 and 3 (image_lens_reproject_torch/baseline.py) with
# their lenses, sampler and rotation, the widths cut: name -> (in_lens,
# out_lens, in_h, in_w, C, out_h, out_w, interp, rotation).
SHRUNK = {
    "config2": (EQUISOLID, EQUIRECT, 256, 256, 3, 256, 512, "bilinear", (30.0, 10.0, 5.0)),
    "config3": (EQUIRECT, L.Rectilinear(35.0, 36.0, 36.0 * 216 / 384), 192, 384, 3, 216, 384,
                "bicubic", (20.0, 5.0, 0.0)),
}
# Small enough for the planned path's plain version to run every list
# here in seconds, with shapes free of PyTorch's CPU tails.
SMALL = {
    "config2": (EQUISOLID, EQUIRECT, 64, 64, 3, 44, 256, "bilinear", (30.0, 10.0, 5.0)),
    "config3": (EQUIRECT, L.Rectilinear(35.0, 36.0, 36.0 * 40 / 256), 48, 96, 3, 40, 256,
                "bicubic", (20.0, 5.0, 0.0)),
}
# Class limits small enough that the shrunk windows fall into several classes.
SMALL_LIMITS = (2400, 16384, 40000)
# For SMALL: a budget that sends some sub-tiles direct, and class limits
# that cut the rest into several classes.
SMALL_BUDGET_LIMITS = {"config2": (40_000, (30_000, 36_000, 38_000)),
                       "config3": (1_100, (1_100, 1_200, 1_300))}


def _kw(case):
    in_lens, out_lens, in_h, in_w, c, out_h, out_w, interp, rot = case
    kw = dict(in_lens=in_lens, out_lens=out_lens, out_h=out_h, out_w=out_w, interp=interp)
    return rotation_matrix_degrees(*rot), (in_h, in_w, c), kw


def _plan(case, budget=P.WINDOW_BUDGET_BYTES):
    rot, (in_h, in_w, c), kw = _kw(case)
    return P.make_plan(rot, in_h=in_h, in_w=in_w, channels=c, budget_bytes=budget, device="cpu",
                       **kw)


@pytest.mark.parametrize("limits", [P.CLASS_LIMITS, SMALL_LIMITS], ids=["default", "small"])
@pytest.mark.parametrize("name", sorted(SHRUNK))
def test_size_classes_partition_each_list(monkeypatch, name, limits):
    monkeypatch.setattr(P, "CLASS_LIMITS", limits)
    plan = _plan(SHRUNK[name])
    c = SHRUNK[name][4]
    n_classes = 0
    for entries, classes, width in ((plan.rescue, plan.rescue_classes, 6),
                                    (plan.split, plan.split_classes, 10)):
        assert sum(n for n, _ in classes) == entries.shape[0]
        windows = entries[:, 2:].long().view(len(entries), (width - 2) // 4, 4)
        staged = P.staged_floats(windows, c).sum(-1)
        assert (staged >= windows[..., 1].mul(windows[..., 3]).sum(-1) * c).all()
        start, last = 0, -1
        for count, floats in classes:
            mine = staged[start:start + count]
            assert count > 0 and int(mine.max()) == floats, "a class reserves its largest window"
            cls = torch.bucketize(4 * mine, torch.tensor(limits))
            assert (cls == cls[0]).all() and int(cls[0]) > last, "one class, in increasing order"
            last = int(cls[0])
            start += count
        n_classes += len(classes)
        # Within a class the list keeps its row-major order.
        for (count, _), s in zip(classes, np.cumsum([0] + [n for n, _ in classes])):
            key = entries[s:s + count, 0].long() * plan.grid[1] + entries[s:s + count, 1].long()
            assert (key[1:] > key[:-1]).all()
    if limits == SMALL_LIMITS:
        assert n_classes >= 2, "the small limits cut the lists into several classes"


@pytest.mark.parametrize("budget", [P.WINDOW_BUDGET_BYTES, 8 * 1024])
@pytest.mark.parametrize("name", sorted(SHRUNK))
def test_sizes_follow_the_budget_alone(name, budget):
    """The classes sort the lists; which list a sub-tile joins is still the
    budget's choice on its unpadded window (whole, or each half in half the
    budget), as before the classes."""
    rot, (in_h, in_w, c), kw = _kw(SHRUNK[name])
    whole, halves = P.windows(rot, in_h=in_h, in_w=in_w, device="cpu", **kw)
    fits = whole[..., 1] * whole[..., 3] * c <= budget // 4
    split = ~fits & (halves[..., 1] * halves[..., 3] * c <= budget // 8).all(-1)
    plan = _plan(SHRUNK[name], budget)
    assert plan.sizes() == {"rescue": int(fits.sum()), "split": int(split.sum()),
                            "direct": int((~fits & ~split).sum())}
    tiles = {tuple(t) for t in plan.rescue[:, :2].tolist()}
    assert tiles == {tuple(t) for t in fits.nonzero().tolist()}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_planned_plain_path_equals_batch_path(monkeypatch, name, batch):
    budget, limits = SMALL_BUDGET_LIMITS[name]
    monkeypatch.setattr(P, "CLASS_LIMITS", limits)
    rot, (in_h, in_w, c), kw = _kw(SMALL[name])
    kw = dict(kw, exposure=2.0, reinhard=4.0)
    plan = P.make_plan(rot, in_h=in_h, in_w=in_w, channels=c, budget_bytes=budget, device="cpu",
                       **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})
    assert len(plan.rescue_classes) > 1 and plan.sizes()["direct"] > 0
    src = torch.from_numpy(
        np.random.default_rng(batch).uniform(0, 2, (batch, in_h, in_w, c)).astype(F))
    misses = B2.new_misses("cpu")
    got = remap_fused.remap_tonemap_planned_batch(src, rot, plan, misses=misses, **kw)
    want = remap_fused.remap_tonemap_batch(src, rot, **kw)
    assert int(misses) == 0
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("c", [3, 4, 5])
def test_b2_instance_follows_b1s_rule(c, n, aligned):
    """B2 is launched with B1's launch constants, so its (channels,
    samples) instance is B1's full frame's for the same shapes."""
    shape = (2, 96, 192, c)
    want = B1.specialisation(shape, n, aligned)
    assert B2.specialisation(shape, n, aligned) == want
    assert want == ((c if c == 3 or (c == 4 and aligned) else B1.ANY_CHANNELS),
                    1 if n == 1 else B1.ANY_SAMPLES)


@pytest.mark.parametrize("batch,window_bytes,want", [
    (1, 97_584, 1),
    (4, 3_072, 4),  # the headline's windows, four images to a CTA
    (4, B2.GROUP_BYTES // 4, 4),
    (4, B2.GROUP_BYTES // 4 + 1, 1),
    (3, 35_340, 1),  # config 2's median window
])
def test_a_cta_takes_the_batch_where_its_windows_fit(batch, window_bytes, want):
    assert B2.images_per_cta(batch, window_bytes) == want


def _stage(img, win, vec, threads=256):
    """csrc/rescue_windows.cu::staged and stage<V> in numpy on one (H, W, C)
    image: returns the shared-memory copy, its pitch and shift, after
    checking each (row, chunk) is copied once from an aligned address inside
    the row."""
    in_h, in_w, c = img.shape
    flat = img.reshape(-1)
    row0, rows, col0, cols = win
    n = cols * c
    shift = (col0 * c) & 3 if vec == 4 else 0
    pitch = (shift + n + 3) & ~3 if vec == 4 else n
    line, start, seam = in_w * c, col0 * c - shift, (in_w - col0) * c + shift
    chunks = pitch // vec
    dst = np.full(rows * pitch, np.nan, dtype=F)
    copied = np.zeros(rows * chunks, dtype=int)
    dr, dj = threads // chunks, threads % chunks
    for tid in range(threads):
        r, j = tid // chunks, tid % chunks
        while r < rows:
            o = j * vec
            row = min(row0 + r, in_h - 1) * line
            g = row + start + o if o < seam else row + (o - seam)
            assert g % vec == 0 and row <= g and g + vec <= row + line
            dst[r * pitch + o:r * pitch + o + vec] = flat[g:g + vec]
            copied[r * chunks + j] += 1
            r, j = r + dr, j + dj
            if j >= chunks:
                j, r = j - chunks, r + 1
    assert (copied == 1).all()
    return dst, pitch, shift


@pytest.mark.parametrize("vec,in_w", [(4, 96), (1, 95)])
@pytest.mark.parametrize("win", [
    (0, 5, 0, 7), (3, 9, 10, 40), (20, 4, 33, 1),
    (7, 6, 90, 20),  # wraps past the seam
    (10, 3, 60, 30),  # ends at the last column
    (0, 2, 0, 95),  # a whole row
])
def test_staging_copies_each_window_texel(win, vec, in_w):
    """Every texel of the window lands where WindowFetch reads it:
    shift + ly * pitch + lx * C, columns taken modulo W; the copy fits the
    plan's bound for the window."""
    c = 3
    img = np.arange(24 * in_w * c, dtype=F).reshape(24, in_w, c)
    row0, rows, col0, cols = win
    cols = min(cols, in_w)
    dst, pitch, shift = _stage(img, (row0, rows, col0, cols), vec)
    assert rows * pitch <= int(P.staged_floats(torch.tensor([row0, rows, col0, cols]), c))
    ly, lx, ch = np.meshgrid(np.arange(rows), np.arange(cols), np.arange(c), indexing="ij")
    got = dst[shift + ly * pitch + lx * c + ch]
    want = img[row0 + ly, (col0 + lx) % in_w, ch]
    np.testing.assert_array_equal(got, want)


def test_staging_thread_steps_cover_tall_narrow_and_wide_windows():
    """More chunks a row than threads, and fewer: the division-free stepping
    visits each (row, chunk) once either way."""
    img = np.arange(40 * 400 * 4, dtype=F).reshape(40, 400, 4)
    for win in ((0, 40, 3, 1), (1, 3, 0, 400), (5, 30, 390, 100)):
        dst, pitch, shift = _stage(img, win, 4)
        assert dst[shift] == img[win[0], win[2], 0]
