"""The arithmetic of the redesigned K7 and K8, emulated in plain PyTorch on
the CPU, against the plain versions (which tests/test_torch_inter_ops.py
holds to the JAX package).

- K8 (ops/me_frame.py leaf_qpel_sep, as csrc/leaf_qpel.cu computes it): the
  three horizontal passes shared by the 49 offsets, kept as int16 (a pass
  that left int16 raises), the vertical taps slid over each column's 16
  values, the window at k = 24, the butterfly Hadamard; per leaf the
  float32 sums in tile order from its first tile, the first
  minimum. Equal to leaf_qpel_plain, outputs and dtypes, for leaves of 1,
  2, 4, 16 and 64 tiles in one call with padding ids, at 8, 10 and 12
  bits, on random and all-max windows and on windows that drive each
  horizontal phase to its extreme sums.
- K7 (ops/me_frame.py tile_ssd_sep and frame_inter_sep, as
  csrc/frame_inter.cu computes them): per patch one window, r^2 as box
  sums, b^2, corr per (tile, dy, strip of dx), b^2 + r^2 - 2 corr in
  uint32; the float32 tile sums in raster order and the first
  minimum. Equal to _tile_ssd_plain and frame_inter_plain at r = 16 (the
  4 x 3 patch) and r = 5 (one tile, strips of 8, the last one partial),
  on random, flat and edge 8-bit planes whose tile grid leaves partial
  patches.

Tolerance 0 throughout: all of it is integer arithmetic or float32 sums in
the same order.
"""
import numpy as np
import pytest
import torch

from uvg266_tpu_torch.ops import me_frame as mf
from uvg266_tpu_torch.ops.inter import LUMA_FILTER

SIZES = (1, 2, 4, 16, 64)          # tiles a leaf (8x8 .. 64x64, and 8x16)


def _leaves(rng, bd, tag):
    """Windows, blocks, sorted ids (the leaves of SIZES, then three padding
    tiles with id n_leaves) and the number of leaves."""
    mx = (1 << bd) - 1
    ids = np.repeat(np.arange(len(SIZES) + 1), SIZES + (3,)).astype(np.int32)
    nt = ids.size
    if tag == "max":
        wins = np.full((nt, 18, 18), mx)
        blks = np.zeros((nt, 8, 8))
    elif tag == "taps":
        # every tile's rows cycle through the sign patterns of the three
        # fractional phases (positive taps at the maximum, the rest 0, or
        # the negative ones): the horizontal passes reach their extremes
        pats = [np.where(s * np.asarray(LUMA_FILTER[fx]) > 0, mx, 0)
                for fx in (4, 8, 12) for s in (1, -1)]
        row = lambda i: np.resize(pats[i % len(pats)], 18)   # noqa: E731
        wins = np.stack([np.stack([row(t + i) for i in range(18)])
                         for t in range(nt)])
        blks = rng.integers(0, mx + 1, (nt, 8, 8))
    else:
        wins = rng.integers(0, mx + 1, (nt, 18, 18))
        blks = rng.integers(0, mx + 1, (nt, 8, 8))
        blks[ids == 4] = mx - wins[ids == 4, 5:13, 5:13]   # largest residual
    pen = (rng.random(49) * 40).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (wins.astype(np.int32), blks.astype(np.int32), ids,
                      pen)], len(SIZES)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("tag", ["rand", "max", "taps"])
def test_leaf_qpel_separable_equals_plain(bd, tag):
    rng = np.random.default_rng(bd * 10 + len(tag))
    (wins, blks, ids, pen), nl = _leaves(rng, bd, tag)
    want = mf.leaf_qpel_plain(wins, blks, ids, nl, pen, bd)
    got = mf.leaf_qpel_sep(wins, blks, ids, nl, pen, bd)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (bd, tag)


def test_leaf_qpel_separable_ties_and_empty_leaves():
    """Flat windows (every offset of a leaf ties: the first minimum),
    leaves with no tile (cost = pen) and no tile at all."""
    wins = torch.full((6, 18, 18), 100, dtype=torch.int32)
    blks = torch.full((6, 8, 8), 100, dtype=torch.int32)
    ids = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int32)
    pen = torch.zeros(49)
    pen[::5] = 3.0
    for args in ((wins, blks, ids, 4, pen, 8),
                 (wins[:0], blks[:0], ids[:0], 3, pen, 8)):
        want = mf.leaf_qpel_plain(*args)
        for a, b in zip(mf.leaf_qpel_sep(*args), want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _planes(tag, H, W, r):
    rng = np.random.default_rng(len(tag) + r)
    if tag == "flat":
        src = np.full((H, W), 77)
        ref = np.full((H, W), 77)
    elif tag == "edge":
        ck = ((np.arange(H)[:, None] // 8 + np.arange(W)[None] // 8) % 2) * 255
        src, ref = ck, np.roll(ck, (3, 5), (0, 1))
    else:
        src = rng.integers(0, 256, (H, W))
        ref = np.clip(np.roll(src, (2, -3), (0, 1))
                      + rng.integers(-4, 5, (H, W)), 0, 255)
    n = 2 * r + 1
    pen = np.linspace(0, 30, n * n).astype(np.float32)
    bits = rng.uniform(4, 30, n * n).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        src.astype(np.int32), np.pad(ref, r, mode="edge").astype(np.int32),
        pen, bits)]


# 9 x 5 tiles: partial 4 x 3 patches on both axes
H_, W_ = 40, 72
CLASSES = ((8, 8, (0, 0, 8, 8, 9, 5)), (16, 16, (0, 0, 16, 16, 4, 2)),
           (32, 32, (0, 0, 32, 32, 2, 1)), (16, 32, (8, 0, 32, 32, 2, 1)),
           (64, 32, (0, 8, 64, 32, 1, 1)))


@pytest.mark.parametrize("r", [16, 5])
@pytest.mark.parametrize("tag", ["rand", "flat", "edge"])
def test_frame_inter_separable_equals_plain(r, tag):
    src, ref_pad, pen, bits = _planes(tag, H_, W_, r)
    assert torch.equal(mf.tile_ssd_sep(src, ref_pad, r),
                       mf._tile_ssd_plain(src, ref_pad, r))
    want = mf.frame_inter_plain(src, ref_pad, pen, bits, CLASSES, r)
    got = mf.frame_inter_sep(src, ref_pad, pen, bits, CLASSES, r)
    for g, w_ in zip(got, want):
        for a, b in zip(g, w_):
            assert a.dtype == b.dtype and torch.equal(a, b), (r, tag)


def test_tile_ssd_separable_wraps_as_uint32():
    """12-bit planes (SSD up to 64 * 4095^2 < 2^31) and int32 samples whose
    SSD passes 2^32: b^2 + r^2 - 2 corr modulo 2^32 equals the plain
    int64 SSD cast to int32."""
    rng = np.random.default_rng(5)
    for lo, hi in ((0, 4096), (-(1 << 20), 1 << 20)):
        src = torch.from_numpy(rng.integers(lo, hi, (24, 32)).astype(np.int32))
        ref = torch.from_numpy(rng.integers(lo, hi, (34, 42)).astype(np.int32))
        assert torch.equal(mf.tile_ssd_sep(src, ref, 5),
                           mf._tile_ssd_plain(src, ref, 5))
