"""Port vs reference, on the CPU: the device functions of the all-intra tool
paths and their tables.

- K10 ``mip_preds`` (uvg266_tpu_torch.ops.mip) == make_mip_preds_fn, every
  MIP size id, 8 and 10 bits, blocks at the plane's edges: tolerance 0.
- K12a ``refs_blocks`` (ops.intra_batch) == make_refs_blocks_fn at positions
  off any grid: tolerance 0.
- K11 ``mts_search`` (ops.rd_cost) vs make_mts_search_fn: ``tr_idx`` and
  ``dc_only`` equal; the cost within rtol (n - 1) * 2^-24 for a block of n
  samples, K4's tolerance (tests/test_torch_rd_cost.py): the bits estimate
  is a float32 sum of n bucket weights that the reference adds one by one
  and the port takes as per-bucket counts times the weights.
- K3/K4 at the MIP candidate counts (12, 16, 32) vs make_rd_cost_fn on the
  MIP predictions: ``best`` and ``satd`` equal, rd within the same rtol.
- the MIP matrices and the MTS transform pairs with their zero-out masks
  equal the reference's arrays.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvg266_tpu.control.partition import qp_to_lambda
from uvg266_tpu.ops import intra_batch as ref_ib
from uvg266_tpu.ops import mip as ref_mip
from uvg266_tpu.ops import mip_tables as ref_mip_tables
from uvg266_tpu.ops import rd_cost as ref_rd
from uvg266_tpu.ops import tr_matrices as ref_tr
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import mip
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb

MIP_SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (8, 32), (64, 64), (16, 4)]


def _plane(w, h, bd, seed):
    """A plane a few blocks large, and block origins at its four corners
    (left, top, right and bottom edges) and off any grid."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    H, W = 3 * h + 6, 3 * w + 10
    src = np.clip(rng.integers(-60, 60, (H, W)) * (mx + 1) // 256
                  + (np.arange(W)[None, :] * mx // W), 0, mx).astype(np.int32)
    xs = np.array([0, W - w, 0, W - w, 3, w + 1, 2 * w + 5], dtype=np.int32)
    ys = np.array([0, 0, H - h, H - h, 1, h + 2, 2 * h + 3], dtype=np.int32)
    return src, xs, ys


@lru_cache(maxsize=None)
def _ref_mip_fn(w, h, bd):
    return jax.jit(ref_mip.make_mip_preds_fn(w, h, bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", MIP_SHAPES)
def test_mip_preds(w, h, bd):
    src, xs, ys = _plane(w, h, bd, seed=w * 64 + h + bd)
    want = np.asarray(_ref_mip_fn(w, h, bd)(jnp.asarray(src), xs, ys))
    mat = tb.mip_matrix(mip.mip_size_id(w, h), "cpu")
    got = mip.mip_preds(torch.from_numpy(src), xs, ys, w, h, bd, mat)
    assert got.dtype == torch.int32
    assert got.shape == (len(xs), 2 * mip.mip_mode_count(w, h), h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mip_preds_matches_the_host_prediction():
    """Candidate c of the batch is mip_predict_np(mode c % n, transpose
    c >= n) on the same boundary samples (what the finalize reconstructs
    for the desc the search returns)."""
    w, h, bd = 16, 8, 8
    src, xs, ys = _plane(w, h, bd, seed=5)
    mat = tb.mip_matrix(mip.mip_size_id(w, h), "cpu")
    got = mip.mip_preds(torch.from_numpy(src), xs, ys, w, h, bd, mat).numpy()
    n = mip.mip_mode_count(w, h)
    k = 5                                   # an interior block
    top = src[ys[k] - 1, xs[k]:xs[k] + w]
    left = src[ys[k]:ys[k] + h, xs[k] - 1]
    for c in range(2 * n):
        np.testing.assert_array_equal(
            got[k, c], mip.mip_predict_np(top, left, w, h, c % n, c >= n, bd))


@pytest.mark.parametrize("w,h", [(8, 8), (16, 32), (64, 64), (32, 8)])
def test_refs_blocks(w, h):
    src, xs, ys = _plane(w, h, 8, seed=w + h)
    want_r, want_b = jax.jit(ref_ib.make_refs_blocks_fn(w, h))(
        jnp.asarray(src), xs, ys)
    refs, blocks = ib.refs_blocks(torch.from_numpy(src), xs, ys, w, h)
    np.testing.assert_array_equal(refs.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(want_b))
    # on a grid it is K1
    g = (3, 1, w, h, 2, 2)
    gx, gy = ib._grid_xy(g, "cpu")
    a = ib.refs_blocks(torch.from_numpy(src), gx.numpy(), gy.numpy(), w, h)
    b = ib.refs_blocks_grid(torch.from_numpy(src), w, h, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_positions_outside_the_plane_raise():
    src = torch.zeros((32, 48), dtype=torch.int32)
    mat = tb.mip_matrix(1, "cpu")
    for xs, ys in (([41], [0]), ([0], [25]), ([-1], [0]), ([0, 8], [0])):
        with pytest.raises(ValueError, match="block positions"):
            ib.refs_blocks(src, np.array(xs), np.array(ys), 8, 8)
        with pytest.raises(ValueError, match="block positions"):
            mip.mip_preds(src, np.array(xs), np.array(ys), 8, 8, 8, mat)


@lru_cache(maxsize=None)
def _ref_mts_fn(w, h, bd):
    return jax.jit(ref_rd.make_mts_search_fn(w, h, bd))


def _mts_blocks(w, h, bd, seed):
    """Source blocks and predictions: random, smooth (where DST7/DCT8 win),
    exact (all-zero levels), flat offset (DC only) and all-max residuals."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    sc = (mx + 1) // 256
    B = 8
    blk = rng.integers(0, mx + 1, (B, h, w)).astype(np.int32)
    pred = np.clip(blk + rng.integers(-30, 30, (B, h, w)) * sc, 0, mx)
    ramp = (np.arange(w)[None, :] * 3 + np.arange(h)[:, None] * 2) * sc
    blk[3:6] = np.clip(mx // 3 + ramp + rng.integers(-3, 3, (3, h, w)) * sc,
                       0, mx)
    pred[3] = mx // 3
    pred[4] = np.clip(blk[4] - ramp[::-1, :], 0, mx)
    pred[5] = np.clip(blk[5] + (np.arange(w)[None, :] - w) * 2 * sc, 0, mx)
    pred[1] = blk[1]
    blk[6] = mx // 2
    pred[6] = mx // 2 - 9 * sc
    blk[7] = mx
    pred[7] = 0
    return pred.astype(np.int32), blk


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (32, 32), (32, 16)])
def test_mts_search(w, h, bd, qp):
    pred, blk = _mts_blocks(w, h, bd, seed=w + h + bd + qp)
    qps = qp + 6 * (bd - 8)
    lam = np.float32(qp_to_lambda(qp))
    ft = tb.frame_tables(qp, "cpu")
    want = _ref_mts_fn(w, h, bd)(pred, blk, np.int32(qps), lam,
                                 ft["wts"].numpy())
    tr, cost, dc = rd.mts_search(torch.from_numpy(pred), torch.from_numpy(blk),
                                 qps, float(lam), ft["wts"],
                                 tb.device_mts_tables(w, h, "cpu"), bd)
    assert tr.dtype == torch.int32 and dc.dtype == torch.bool
    np.testing.assert_array_equal(tr.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(dc.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(cost.numpy(), np.asarray(want[1]),
                               rtol=(w * h - 1) * 2.0 ** -24)
    assert dc[1] and dc[6] and tr[1] == 0 and tr[6] == 0


def test_mts_search_picks_other_transforms():
    """The inputs do exercise the choice: over the 8-bit cases some block
    takes a transform pair other than DCT2."""
    seen = set()
    for (w, h) in ((8, 8), (16, 16), (32, 16)):
        pred, blk = _mts_blocks(w, h, 8, seed=w + h + 8 + 22)
        ft = tb.frame_tables(22, "cpu")
        tr, _c, _d = rd.mts_search(
            torch.from_numpy(pred), torch.from_numpy(blk), 22,
            float(np.float32(qp_to_lambda(22))), ft["wts"],
            tb.device_mts_tables(w, h, "cpu"), 8)
        seen |= set(tr.tolist())
    assert seen - {0}, seen


@pytest.mark.parametrize("w,h,bd", [(16, 16, 8), (8, 8, 10), (4, 4, 8),
                                    (32, 8, 8)])
def test_satd_and_rd_cost_at_mip_candidate_counts(w, h, bd):
    """K3 and K4 over M = 12, 16 or 32 candidates with the flat 6.0 bits of
    the MIP search, against make_rd_cost_fn (which runs make_satd67_fn)."""
    src, xs, ys = _plane(w, h, bd, seed=w * 3 + h + bd)
    s = torch.from_numpy(src)
    preds = mip.mip_preds(s, xs, ys, w, h, bd,
                          tb.mip_matrix(mip.mip_size_id(w, h), "cpu"))
    _refs, blocks = ib.refs_blocks(s, xs, ys, w, h)
    M = preds.shape[1]
    assert M in (12, 16, 32)
    satds = ib.satd67(preds, blocks)
    np.testing.assert_array_equal(
        satds.numpy(), np.asarray(jax.jit(ref_ib.make_satd67_fn(w, h))(
            jnp.asarray(preds.numpy()), jnp.asarray(blocks.numpy()))))
    qp = 27
    qps = qp + 6 * (bd - 8)
    lam = np.float32(qp_to_lambda(qp))
    ft = tb.frame_tables(qp, "cpu")
    bits = tb.mip_mode_bits(M, "cpu")
    want = jax.jit(ref_rd.make_rd_cost_fn(w, h, bd))(
        jnp.asarray(preds.numpy()), jnp.asarray(blocks.numpy()),
        np.int32(qps), lam, ft["wts"].numpy(), bits.numpy())
    best, cost, satd = rd.rd_cost(preds, blocks, satds, qps, float(lam),
                                  ft["wts"], bits,
                                  tb.device_tables(w, h, bd, "cpu"), bd)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(satd.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(cost.numpy(), np.asarray(want[1]),
                               rtol=(w * h - 1) * 2.0 ** -24)


@pytest.mark.parametrize("size_id", [0, 1, 2])
def test_mip_matrices_equal_reference(size_id):
    want = (ref_mip_tables.MIP_4X4, ref_mip_tables.MIP_8X8,
            ref_mip_tables.MIP_16X16)[size_id]
    got = tb.mip_matrix(size_id, "cpu")
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (32, 16), (8, 32)])
def test_mts_tables_equal_reference(w, h):
    """The five pairs in the order of make_mts_search_fn's idx_list, with
    its zero-out rule (rd_cost.py:258-261), from the reference's matrices."""
    t = tb.device_mts_tables(w, h, "cpu")
    assert tb.MTS_IDX == (0, 2, 3, 4, 5) == tuple(ref_rd.MTS_PAIRS)
    assert t["mts_w"].dtype == t["mts_h"].dtype == torch.int8
    for ci, idx in enumerate(tb.MTS_IDX):
        th, tv = ref_rd.MTS_PAIRS[idx]
        np.testing.assert_array_equal(t["mts_w"][ci].numpy(),
                                      ref_tr.get_matrix(th, w))
        np.testing.assert_array_equal(t["mts_h"][ci].numpy(),
                                      ref_tr.get_matrix(tv, h))
        keep_w = 16 if (th != ref_tr.DCT2 and w == 32) else w
        keep_h = 16 if (tv != ref_tr.DCT2 and h == 32) else h
        mask = np.zeros((h, w), dtype=np.int32)
        mask[:keep_h, :keep_w] = 1
        np.testing.assert_array_equal(t["mts_mask"][ci].numpy(), mask)
        assert t["mts_keep"][ci] == (keep_w, keep_h)
