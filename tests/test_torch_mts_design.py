"""The arithmetic of the redesigned K10 and K11, emulated in plain PyTorch
on the CPU, against the plain versions (which tests/test_torch_tool_ops.py
holds to the JAX package).

- K11 (ops/rd_cost.py mts_search_sep, as csrc/mts_search.cu computes it):
  DCT2/DCT2 on even/odd partial butterflies; one forward row pass and one
  column pass per horizontal type for the four DST7/DCT8 pairs, each giving
  DST7 and DCT8 from one product through DCT8[k][x] = (-1)^k DST7[k][n-1-x];
  at 32 points only the 16 coefficients kept, the inverse passes over them
  alone; every sum checked inside int32. Equal to mts_search_plain (tr_idx,
  the cost bit for bit, dc_only, dtypes) at every (w, h) in {4..32}^2, 8
  and 10 bits, QP 22 and 37, on random, smooth and all-max residuals (a
  32x32 10-bit block's SSD can reach 1024 * 1023^2, just below 2^30).
- The identity itself on the port's matrices at 4-32 points.
- K10 (ops/mip.py mip_preds_seg, as csrc/mip_preds.cu forms its output):
  the horizontally upsampled reduced rows, then one vertical step per
  sample. Equal to mip_preds_plain at every (w, h) in {4..64}^2, 8 and 10
  bits, at the plane's edges and off any grid.

Tolerance 0 throughout: the integer steps are exact, and the float32 costs
are the same operations in the same order.
"""
import numpy as np
import pytest
import torch

from uvg266_tpu_torch.control.partition import qp_to_lambda
from uvg266_tpu_torch.ops import mip
from uvg266_tpu_torch.ops import rd_cost as rc
from uvg266_tpu_torch.ops import tables as tb
from uvg266_tpu_torch.ops.tr_matrices import dct8_matrix, dst7_matrix

MTS_SIZES = [4, 8, 16, 32]
MIP_SIZES = [4, 8, 16, 32, 64]


def _residual_cases(rng, w, h, bd, B=4):
    """(pred, src) int32 [B, h, w]: random, smooth (a ramp and its shifted
    copy) and all-max (zero prediction, source at the maximum)."""
    mx = (1 << bd) - 1
    rand = (rng.integers(0, mx + 1, (B, h, w)),
            rng.integers(0, mx + 1, (B, h, w)))
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (xx * 7 + yy * 5)[None] + rng.integers(0, mx // 2, (B, 1, 1))
    smooth = (np.clip(ramp, 0, mx),
              np.clip(ramp + rng.integers(-3, 4, (B, h, w)) + 9, 0, mx))
    full = (np.zeros((B, h, w)), np.full((B, h, w), mx))
    return {tag: tuple(torch.from_numpy(a.astype(np.int32)) for a in pair)
            for tag, pair in (("rand", rand), ("smooth", smooth),
                              ("max", full))}


@pytest.mark.parametrize("w", MTS_SIZES)
@pytest.mark.parametrize("h", MTS_SIZES)
def test_mts_search_sep_equals_plain(w, h):
    rng = np.random.default_rng(w * 100 + h)
    mts = tb.device_mts_tables(w, h, "cpu")
    for bd in (8, 10):
        for tag, (pred, src) in _residual_cases(rng, w, h, bd).items():
            for qp in (22, 37):
                ft = tb.frame_tables(qp, "cpu")
                args = (pred, src, qp + 6 * (bd - 8),
                        float(np.float32(qp_to_lambda(qp))), ft["wts"], mts,
                        bd)
                want = rc.mts_search_plain(*args)
                got = rc.mts_search_sep(*args)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b), \
                        (bd, tag, qp)


@pytest.mark.parametrize("n", MTS_SIZES)
def test_dct8_is_reflected_dst7(n):
    """DCT8[k][x] = (-1)^k DST7[k][n-1-x] on the port's matrices, and
    rd_cost.dct8_of builds the DCT8 matrix from the DST7 one."""
    s, c = dst7_matrix(n), dct8_matrix(n)
    sign = np.where(np.arange(n) % 2 == 0, 1, -1)[:, None]
    assert np.array_equal(c, sign * s[:, ::-1])
    assert torch.equal(rc.dct8_of(torch.from_numpy(s).long()),
                       torch.from_numpy(c).long())


@pytest.mark.parametrize("w", MIP_SIZES)
@pytest.mark.parametrize("h", MIP_SIZES)
def test_mip_preds_seg_equals_plain(w, h):
    rng = np.random.default_rng(w * 1000 + h)
    mat = tb.mip_matrix(mip.mip_size_id(w, h), "cpu")
    H, W = 2 * h + 6, 3 * w + 5
    # the four corners of the plane (clamped references) and off-grid
    # positions
    xs = np.array([0, W - w, 0, W - w, 3, w + 1, 1], dtype=np.int32)
    ys = np.array([0, 0, H - h, H - h, 1, h + 2, 5], dtype=np.int32)
    for bd in (8, 10):
        mx = (1 << bd) - 1
        planes = [rng.integers(0, mx + 1, (H, W)),
                  (np.indices((H, W)).sum(0) % 2) * mx,
                  np.full((H, W), mx)]
        for plane in planes:
            src = torch.from_numpy(plane.astype(np.int32))
            want = mip.mip_preds_plain(src, xs, ys, w, h, bd, mat)
            got = mip.mip_preds_seg(src, xs, ys, w, h, bd, mat)
            assert got.dtype == want.dtype and torch.equal(got, want), bd
