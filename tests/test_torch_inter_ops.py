"""Port vs reference: the inter-slice kernels' plain versions against their
JAX functions on the CPU, and the constant tables they use.

- K5 pseudo_recon against make_pseudo_recon_fn and pseudo_recon_plane:
  equal.
- K1 refs_blocks_grid with a separate reference plane against
  make_refs_blocks_grid_fn(src, refsrc): equal.
- K6 rd_cost_pred against make_rd_cost_pred_fn: rtol (n - 1) * 2^-24 for
  a block of n samples, as K4 (tests/test_torch_rd_cost.py): the bits
  estimate is a float32 sum of n bucket weights that the reference adds
  one by one and the port takes as per-bucket counts times the weights.
- K7 frame_inter (+ K6) against make_frame_inter_fn on
  tests/test_me_frame.py's 64x48 frame and classes: offset indices equal,
  costs as K6.
- K8 leaf_qpel against make_leaf_qpel_fn: best, cost and segment sums
  equal.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvg266_tpu.control.partition import qp_to_lambda
from uvg266_tpu.ops import inter as ref_inter
from uvg266_tpu.ops import intra_batch as ref_ib
from uvg266_tpu.ops import me as ref_me
from uvg266_tpu.ops import me_frame as ref_mf
from uvg266_tpu.ops import pseudo_recon as ref_pr
from uvg266_tpu.ops import quant as ref_quant
from uvg266_tpu.ops import rd_cost as ref_rd
from uvg266_tpu.ops import tr_matrices as ref_tr
from uvg266_tpu.ops.fast_cost_tables import FAST_COEFF_WTS
from uvg266_tpu_torch.ops import inter, me, me_frame, pseudo_recon, quant
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb
from uvg266_tpu_torch.ops import tr_matrices as tr

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "uvg266_tpu_torch", "csrc")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_constant_tables_equal_reference():
    """The 'weights' the slice adds: the luma filter (also the copy
    compiled into csrc/qpel.cuh, which K8 leaf_qpel.cu and K9b
    frac_search.cu share, and its rows 4, 8, 12 as qpel.cuh's tap table),
    the 16x16 DCT2, the quant scales, the mv penalty and the mv bits
    table."""
    np.testing.assert_array_equal(inter.LUMA_FILTER, ref_inter.LUMA_FILTER)
    with open(os.path.join(CSRC, "qpel.cuh")) as fh:
        src = fh.read()
    body = src[src.index("kLumaFilter[16][8] = {"):].split(";")[0]
    cu = np.array([int(v) for v in re.findall(r"-?\d+", body)[2:]])
    np.testing.assert_array_equal(cu.reshape(16, 8), ref_inter.LUMA_FILTER)
    body = src[src.index("constexpr int f[3][8] = {"):].split(";")[0]
    cu = np.array([int(v) for v in re.findall(r"-?\d+", body)[2:]])
    np.testing.assert_array_equal(cu.reshape(3, 8),
                                  ref_inter.LUMA_FILTER[[4, 8, 12]])
    np.testing.assert_array_equal(tr.get_matrix(tr.DCT2, 16),
                                  ref_tr.get_matrix(ref_tr.DCT2, 16))
    np.testing.assert_array_equal(quant.QUANT_SCALES, ref_quant.QUANT_SCALES)
    np.testing.assert_array_equal(quant.INV_QUANT_SCALES,
                                  ref_quant.INV_QUANT_SCALES)
    for qp in (22, 27, 37):
        ls = np.sqrt(qp_to_lambda(qp, False))
        np.testing.assert_array_equal(me.make_mv_penalty(16, ls),
                                      ref_me.make_mv_penalty(16, ls))
    np.testing.assert_array_equal(me_frame.mv_bits_table(16),
                                  ref_mf.mv_bits_table(16))
    assert me_frame.TILE == ref_mf.TILE


@pytest.mark.parametrize("bd,qps", [(8, 22), (8, 37), (8, 51), (10, 34),
                                    (10, 63)])
def test_pseudo_recon(bd, qps):
    rng = np.random.default_rng(bd * 100 + qps)
    mx = (1 << bd) - 1
    src = rng.integers(0, mx + 1, (48, 64)).astype(np.int32)
    src[:16, :16] = mx * (np.arange(16)[None, :] % 2)     # largest residual
    src[16:32, :16] = 128                                  # flat: exact DC
    want = np.asarray(jax.jit(ref_pr.make_pseudo_recon_fn(48, 64, bd))(
        src, np.int32(qps)))
    got = pseudo_recon.pseudo_recon(t(src), qps, bd).numpy()
    np.testing.assert_array_equal(got, want)
    host = ref_pr.pseudo_recon_plane(src, qps, bd)
    np.testing.assert_array_equal(got, host)
    # the port's host copy, also on a plane that is not a multiple of 16
    np.testing.assert_array_equal(
        pseudo_recon.pseudo_recon_plane(src[:40, :56], qps, bd),
        ref_pr.pseudo_recon_plane(src[:40, :56], qps, bd))


@pytest.mark.parametrize("w,h,grid", [(8, 8, (0, 0, 8, 8, 8, 6)),
                                      (32, 32, (0, 0, 32, 32, 2, 1)),
                                      (16, 32, (8, 0, 32, 32, 1, 1)),
                                      (32, 8, (0, 0, 32, 8, 2, 6))])
def test_refs_blocks_grid_refsrc(w, h, grid):
    rng = np.random.default_rng(w + h)
    src = rng.integers(0, 256, (48, 64)).astype(np.int32)
    pseudo = rng.integers(0, 256, (48, 64)).astype(np.int32)
    want_r, want_b = jax.jit(ref_ib.make_refs_blocks_grid_fn(w, h, grid))(
        jnp.asarray(src), jnp.asarray(pseudo))
    got_r, got_b = ib.refs_blocks_grid(t(src), w, h, grid, t(pseudo))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    # without refsrc the call reads src itself: the all-intra K1, which
    # tests/test_torch_intra_batch.py holds against JAX
    for a, b in zip(ib.refs_blocks_grid(t(src), w, h, grid),
                    ib.refs_blocks_grid(t(src), w, h, grid, t(src))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s", [8, 16, 32])
@pytest.mark.parametrize("qp", [22, 37])
def test_rd_cost_pred(s, qp):
    rng = np.random.default_rng(s * 10 + qp)
    B = 6
    src = rng.integers(0, 256, (B, s, s)).astype(np.int32)
    pred = np.clip(src + rng.integers(-30, 30, (B, s, s)), 0, 255) \
        .astype(np.int32)
    pred[0] = 0
    src[0] = 255                                      # largest residual
    pred[1] = src[1]                                  # flat: all zero levels
    extra = rng.uniform(4, 40, B).astype(np.float32)
    lam = np.float32(qp_to_lambda(qp, False))
    wts = FAST_COEFF_WTS[qp].astype(np.float32)
    want = np.asarray(jax.jit(ref_rd.make_rd_cost_pred_fn(s, s, 8))(
        pred, src, np.int32(qp), lam, wts, extra))
    got = rd.rd_cost_pred(t(pred), t(src), qp, float(lam), t(wts), t(extra),
                          tb.device_tables(s, s, 8, "cpu"), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=(s * s - 1) * 2.0 ** -24)


# tests/test_me_frame.py's frame and classes
R = 16
H, W = 48, 64
CLASSES = (
    (8, 8, (0, 0, 8, 8, W // 8, H // 8)),
    (16, 16, (0, 0, 16, 16, W // 16, H // 16)),
    (16, 8, (0, 0, 16, 8, W // 16, H // 8)),
    (8, 16, (0, 0, 8, 16, W // 8, H // 16)),
    (16, 32, (8, 0, 32, 32, (W - 8) // 32, H // 32)),
)


def _frames():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = np.roll(src, (2, -3), axis=(0, 1))
    ref[20:30, 10:30] = rng.integers(0, 256, (10, 20))
    ref2 = np.clip(ref.astype(np.int64) + 7, 0, 255).astype(np.int32)
    return src, np.stack([np.pad(ref, R, mode="edge"),
                          np.pad(ref2, R, mode="edge")]).astype(np.int32)


def test_frame_inter():
    src, refs_pad = _frames()
    qp = 27
    lam = np.float32(qp_to_lambda(qp))
    pen = ref_me.make_mv_penalty(R, np.sqrt(lam)).reshape(-1)
    bits = ref_mf.mv_bits_table(R)
    wts = FAST_COEFF_WTS[qp].astype(np.float32)
    want = np.asarray(jax.jit(ref_mf.make_frame_inter_fn(
        H, W, CLASSES, n_refs=2))(src, refs_pad, pen, bits, np.int32(qp),
                                  lam, wts))
    got = me_frame.frame_inter_search(
        t(src), t(refs_pad), t(pen), t(bits), CLASSES, qp, float(lam), t(wts),
        8).numpy()
    assert got.shape == want.shape
    off = 0
    for _ri in range(2):
        for (w, h, grid) in CLASSES:
            B = grid[4] * grid[5]
            np.testing.assert_array_equal(got[off:off + B], want[off:off + B])
            np.testing.assert_allclose(got[off + B:off + 2 * B],
                                       want[off + B:off + 2 * B],
                                       rtol=(w * h - 1) * 2.0 ** -24)
            off += 2 * B


def test_frame_inter_outputs():
    """K7's own outputs: the prediction and source blocks at the chosen
    offset, and the extra bits, against a direct gather."""
    src, refs_pad = _frames()
    n = 2 * R + 1
    pen = t(np.linspace(0, 50, n * n).astype(np.float32))
    bits = t(ref_mf.mv_bits_table(R))
    found = me_frame.frame_inter(t(src), t(refs_pad[0]), pen, bits, CLASSES,
                                 R)
    for (w, h, (x0, y0, sx, sy, gx, gy)), (idx, pred, blk, extra) in zip(
            CLASSES, found):
        for b in range(gx * gy):
            x, y = x0 + (b % gx) * sx, y0 + (b // gx) * sy
            k = int(idx[b])
            dy, dx = k // n - R, k % n - R
            np.testing.assert_array_equal(
                pred[b].numpy(),
                refs_pad[0][y + dy + R:y + dy + R + h,
                            x + dx + R:x + dx + R + w])
            np.testing.assert_array_equal(blk[b].numpy(),
                                          src[y:y + h, x:x + w])
            assert float(extra[b]) == float(bits[k])


@pytest.mark.parametrize("bd", [8, 10])
def test_leaf_qpel(bd):
    src, refs_pad = _frames()
    ref = refs_pad[0][R:R + H, R:R + W]
    rng = np.random.default_rng(bd)
    tiles, blocks, ids = [], [], []
    # three leaves (16x16, 8x8, 32x16) at full-pel MVs, as
    # _refine_inter_leaves cuts them, then padding tiles
    for li, (x, y, w, h, mvx, mvy) in enumerate(
            [(16, 8, 16, 16, 3, -2), (0, 0, 8, 8, 0, 0),
             (32, 16, 32, 16, -5, 4)]):
        win = ref_inter.fetch_extended_block(ref, x + mvx, y + mvy, w, h,
                                             5, 5, 5, 5)
        blk = src[y:y + h, x:x + w]
        for i in range(h // 8):
            for j in range(w // 8):
                tiles.append(win[8 * i:8 * i + 18, 8 * j:8 * j + 18])
                blocks.append(blk[8 * i:8 * i + 8, 8 * j:8 * j + 8])
                ids.append(li)
    nl = 4
    while len(tiles) < 16:
        tiles.append(np.zeros((18, 18), dtype=np.int32))
        blocks.append(np.zeros((8, 8), dtype=np.int32))
        ids.append(nl)
    scale = 1 << (bd - 8)
    tiles = np.stack(tiles).astype(np.int32) * scale \
        + rng.integers(0, scale, (16, 18, 18)).astype(np.int32)
    blocks = np.stack(blocks).astype(np.int32) * scale
    ids = np.asarray(ids, dtype=np.int32)
    pen49 = np.array([7.3 * ((0.0 if k % 7 == 3 else 2.0)
                             + (0.0 if k // 7 == 3 else 2.0))
                      for k in range(49)], dtype=np.float32)
    want = jax.jit(ref_mf.make_leaf_qpel_fn(16, nl, bd))(tiles, blocks, ids,
                                                         pen49)
    got = me_frame.leaf_qpel(t(tiles), t(blocks), t(ids), nl, t(pen49), bd)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
