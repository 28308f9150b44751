"""The arithmetic of the redesigned K9a and K9b, emulated in plain PyTorch
on the CPU, against the plain versions (which tests/test_torch_me_ops.py
holds to the JAX package).

- K9b (ops/me.py frac_search_sep, as csrc/frac_search.cu computes it): the
  three horizontal passes shared by the 49 offsets, kept as int16 (a pass
  that left int16 raises), the fx = 0 and fy = 0 shortcuts, the window at
  k = 24, the butterfly Hadamards down the columns then along the rows.
  Equal to frac_search_plain, outputs and dtypes, at every (w, h) in
  {4..64}^2, 8, 10 and 12 bits, random and all-max planes; its winner form
  equal to the plain gather, and so is the wrapper's on the CPU.
- K9a's r2 (ops/me.py box_r2, as csrc/fullpel_search.cu computes it):
  sliding column sums, then sliding row sums, each step in uint32; equal to
  the direct sum of squares over every box, the all-max 10-bit 64x64 block
  (4096 * 1023^2 < 2^32) included.

Tolerance 0 throughout: all of it is integer arithmetic.
"""
import numpy as np
import pytest
import torch

from uvg266_tpu_torch.ops import me

SIZES = [4, 8, 16, 32, 64]
R = 16


def _case(rng, w, h, bd, tag, B=3):
    mx = (1 << bd) - 1
    H, W = h + 40, w + 40
    if tag == "max":
        ref = np.full((H, W), mx, dtype=np.int32)
        blocks = np.zeros((B, h, w), dtype=np.int32)
    else:
        ref = rng.integers(0, mx + 1, (H, W)).astype(np.int32)
        blocks = rng.integers(0, mx + 1, (B, h, w)).astype(np.int32)
    # one block at each corner of the plane's edge extension, one inside
    xs = np.array([0, W - w, 11], dtype=np.int32)[:B]
    ys = np.array([0, H - h, 7], dtype=np.int32)[:B]
    mvx = np.array([-3, 5, 0], dtype=np.int32)[:B]
    mvy = np.array([2, -4, 1], dtype=np.int32)[:B]
    fpen = (rng.random(49) * 10).astype(np.float32)
    return [torch.from_numpy(a) for a in (ref, blocks, xs, ys, mvx, mvy,
                                          fpen)]


@pytest.mark.parametrize("w", SIZES)
@pytest.mark.parametrize("h", SIZES)
def test_frac_search_separable_equals_plain(w, h):
    rng = np.random.default_rng(w * 100 + h)
    for bd in (8, 10, 12):
        for tag in ("rand", "max"):
            args = _case(rng, w, h, bd, tag)
            want = me.frac_search_plain(*args, bd)
            got = me.frac_search_sep(*args, bd)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (bd, tag)


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (8, 32),
                                 (64, 64)])
@pytest.mark.parametrize("bd", [8, 10])
def test_frac_search_winner_form_equals_gather(w, h, bd):
    rng = np.random.default_rng(w + h + bd)
    args = _case(rng, w, h, bd, "rand")
    best, preds, costs = me.frac_search_plain(*args, bd)
    gathered = preds[torch.arange(best.shape[0]), best.long()]
    for got in (me.frac_search_sep(*args, bd, winner_only=True),
                me.frac_search(*args, bd, winner_only=True)):
        assert torch.equal(got[0], best) and torch.equal(got[2], costs)
        assert got[1].dtype == torch.int32 and torch.equal(got[1], gathered)


def test_frac_search_separable_int16_bound():
    """The horizontal passes are int16 at 8-12 bits: the largest and the
    smallest sums a phase can take (its positive, or its negative, taps at
    the maximum sample) pass through frac_search_sep without raising."""
    from uvg266_tpu_torch.ops.inter import LUMA_FILTER
    for bd in (8, 10, 12):
        mx = (1 << bd) - 1
        for fx in (4, 8, 12):
            f = np.asarray(LUMA_FILTER[fx])
            for sign in (1, -1):
                row = np.where(sign * f > 0, mx, 0)
                plane = np.tile(np.concatenate([row, row]), (24, 4))
                plane = torch.from_numpy(plane.astype(np.int32))
                z = torch.zeros(1, dtype=torch.int32)
                me.frac_search_sep(plane, torch.zeros((1, 8, 8),
                                                      dtype=torch.int32),
                                   z + 8, z + 8, z, z,
                                   torch.zeros(49), bd)


def _direct_r2(win, w, h):
    sq = win.long() ** 2
    n = win.shape[1] - h + 1
    out = torch.empty((win.shape[0], n, n), dtype=torch.int64)
    for dy in range(n):
        for dx in range(n):
            out[:, dy, dx] = sq[:, dy:dy + h, dx:dx + w].sum(dim=(1, 2))
    return out


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (4, 16), (32, 8),
                                 (64, 64)])
@pytest.mark.parametrize("tag", ["rand", "max"])
def test_fullpel_box_r2_equals_direct_sum(w, h, tag):
    rng = np.random.default_rng(w * h)
    shape = (2, h + 2 * R, w + 2 * R)
    win = torch.full(shape, 1023) if tag == "max" \
        else torch.from_numpy(rng.integers(0, 1024, shape))
    got = me.box_r2(win, w, h)
    assert torch.equal(got, _direct_r2(win, w, h))
    if tag == "max" and (w, h) == (64, 64):
        assert int(got.max()) == 4096 * 1023 ** 2 < 2 ** 32
