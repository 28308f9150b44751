"""The per-class motion search of the port against the JAX package: K9a
fullpel_search, K9b frac_search, their windows, their rate tables, and K6
rd_cost_pred at 10 bits and with intra rounding.

The same inputs, made from a seed with numpy, go through the JAX functions
(on the CPU) and the port's plain versions.

K9a's tolerance: the reference sums b2, corr and r2 in float32 in XLA's
order, the port takes the exact integers, rounds each once and combines
them in the reference's order. Where every term is below 2^24 (8 bits up
to 16x16) the two are equal. Elsewhere the reference's cost is off the
exact one by at most n * 2^-24 * (b2 + 2*corr + r2) for n samples (each
float32 sum of n non-negative terms errs by at most (n - 1) * 2^-24 of its
value, the two combining operations by 2^-24 each), and the port's by 2^-24
of that sum: the cost must agree within that bound at the chosen offset,
and the MVs must be equal wherever the exact runner-up lies farther than
twice the bound from the exact minimum. The test counts the near ties it
skips; there must be none on the textured inputs.
"""
import jax
import numpy as np
import pytest
import torch

from uvg266_tpu.ops.fast_cost_tables import FAST_COEFF_WTS
from uvg266_tpu.ops.inter import fetch_extended_block, mc_luma
from uvg266_tpu.ops.me import (make_frac_search_fn, make_fullpel_search_fn,
                               make_mv_penalty, mv_bits_est)
from uvg266_tpu.ops.rd_cost import make_rd_cost_pred_fn
from uvg266_tpu_torch.ops import me
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb

R = 16
H_, W_ = 128, 224
LAM = 57.9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planes(bd, seed):
    """(ref, src): random texture left of x = 160, the source being the
    reference moved by (5, 3) plus a little noise; right of it an all-max
    area above y = 64 and a flat one below."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    ref = rng.integers(0, mx + 1, (H_, W_)).astype(np.int32)
    src = np.clip(np.roll(ref, (3, 5), (0, 1))
                  + rng.integers(-2, 3, (H_, W_)), 0, mx).astype(np.int32)
    for p in (ref, src):
        p[:64, 160:] = mx
        p[64:, 160:] = mx // 3
    return ref, src


def _positions(w, h):
    """Textured, all-max and flat blocks, and blocks at the four frame
    edges, whose windows the frame's border extends."""
    return {"textured": [(8, 8), (16, 24), (88, 40)],
            "max": [(160, 0), (W_ - w, 64 - h)],
            "flat": [(160, 64), (W_ - w, H_ - h)],
            "edges": [(0, 40), (72, 0), (0, H_ - h), (W_ - w, 32)]}


def _exact(win, blk, pen):
    """Exact costs [B, n*n] in float64 (pen as float32), and the sums
    b2 + 2*corr + r2 per offset (float64)."""
    B, h, w = blk.shape
    n = 2 * R + 1
    win = win.astype(np.int64)
    blk = blk.astype(np.int64)
    corr = np.zeros((B, n, n), dtype=np.int64)
    r2 = np.zeros((B, n, n), dtype=np.int64)
    for i in range(h):
        for j in range(w):
            sl = win[:, i:i + n, j:j + n]
            corr += blk[:, i, j, None, None] * sl
            r2 += sl * sl
    b2 = (blk * blk).sum(axis=(1, 2))[:, None, None]
    cost = (b2 - 2 * corr + r2).astype(np.float64) + pen.astype(np.float64)
    return cost.reshape(B, -1), \
        (b2 + 2 * corr + r2).astype(np.float64).reshape(B, -1)


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (16, 8), (32, 32),
                                 (64, 64)])
@pytest.mark.parametrize("bd", [8, 10])
def test_fullpel_search_matches_reference(w, h, bd):
    ref, src = _planes(bd, seed=w + h + bd)
    pen = make_mv_penalty(R, np.sqrt(LAM))
    fn = jax.jit(make_fullpel_search_fn(w, h, R))
    exact_ok = bd == 8 and w <= 16 and h <= 16
    near = {}
    for tag, pos in _positions(w, h).items():
        wins = np.stack([fetch_extended_block(ref, x, y, w, h, R, R, R, R)
                         for x, y in pos]).astype(np.int32)
        blks = np.stack([src[y:y + h, x:x + w] for x, y in pos])
        jx, jy, jc = (np.asarray(a) for a in fn(wins, blks, pen))
        xs = _t(np.array([p[0] for p in pos], dtype=np.int32))
        ys = _t(np.array([p[1] for p in pos], dtype=np.int32))
        px, py, pc = (a.numpy() for a in me.fullpel_search_plain(
            _t(ref), _t(blks), xs, ys, R, _t(pen.reshape(-1))))
        if exact_ok:
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_array_equal(py, jy)
            np.testing.assert_array_equal(pc, jc)
            continue
        cost, terms = _exact(wins, blks, pen)
        near[tag] = 0
        for b in range(len(pos)):
            order = np.argsort(cost[b], kind="stable")
            k0 = order[0]
            bound = h * w * 2.0 ** -24 * terms[b, k0]
            if cost[b, order[1]] - cost[b, k0] <= 2 * bound:
                near[tag] += 1              # a near tie: either MV may win
                continue
            assert (px[b], py[b]) == (jx[b], jy[b]), (tag, b)
            assert abs(float(pc[b]) - float(jc[b])) <= bound, (tag, b)
            # the port's cost: four roundings of terms of that sum at most
            assert abs(float(pc[b]) - cost[b, k0]) \
                <= 4 * 2.0 ** -24 * terms[b, k0], (tag, b)
    if not exact_ok:
        assert near["textured"] == 0, near


@pytest.mark.parametrize("w,h,bd", [(8, 8, 8), (16, 8, 10), (4, 16, 8),
                                    (16, 4, 10), (32, 32, 8)])
def test_frac_search_matches_reference(w, h, bd):
    """best, preds and costs equal; the predictions are also mc_luma's
    (tests/test_e2e_inter.py test_jax_frac_interp_matches_mc_luma)."""
    ref, src = _planes(bd, seed=w * h + bd)
    pos = [p for ps in _positions(w, h).values() for p in ps]
    rng = np.random.default_rng(bd)
    mvs = rng.integers(-R, R + 1, (len(pos), 2)).astype(np.int32)
    mvs[0] = (5, 3)
    lam_sqrt = np.sqrt(LAM)
    fpen = tb.frac_penalty(lam_sqrt)
    wins = np.stack([fetch_extended_block(ref, x + mx_, y + my_, w, h,
                                          5, 5, 5, 5)
                     for (x, y), (mx_, my_) in zip(pos, mvs)]).astype(np.int32)
    blks = np.stack([src[y:y + h, x:x + w] for x, y in pos])
    jb, jp, jc = (np.asarray(a) for a in jax.jit(make_frac_search_fn(
        w, h, bd))(wins, blks, fpen))
    pb, pp, pc = (a.numpy() for a in me.frac_search_plain(
        _t(ref), _t(blks), _t(np.array([p[0] for p in pos], np.int32)),
        _t(np.array([p[1] for p in pos], np.int32)), _t(mvs[:, 0]),
        _t(mvs[:, 1]), _t(fpen), bd))
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pc, jc)
    for b in (0, 3, len(pos) - 1):
        x, y = pos[b]
        for k in range(0, 49, 5):
            mv = (int(mvs[b, 0]) * 16 + (k % 7 - 3) * 4,
                  int(mvs[b, 1]) * 16 + (k // 7 - 3) * 4)
            np.testing.assert_array_equal(pp[b, k],
                                          mc_luma(ref, x, y, w, h, mv, bd))


def test_windows_are_fetch_extended_block():
    rng = np.random.default_rng(1)
    plane = rng.integers(0, 1024, (40, 56)).astype(np.int32)
    pos = [(0, 0), (48, 0), (0, 32), (48, 32), (20, 12)]
    for pad in (R, me.FRAC_PAD):
        got = me.windows(_t(plane), _t(np.array([p[0] for p in pos])),
                         _t(np.array([p[1] for p in pos])), 8, 8, pad).numpy()
        for g, (x, y) in zip(got, pos):
            np.testing.assert_array_equal(
                g, fetch_extended_block(plane, x, y, 8, 8, pad, pad, pad, pad))


def test_me_tables_match_reference():
    """The mvd bits table against mv_bits_est, the full-pel penalty against
    make_mv_penalty and the quarter-pel one against the reference's fpen
    (uvg266_tpu/control/encoder.py search_inter_blocks)."""
    tab = tb.mvd_bits_table(R)
    lim = 4 * R + 3
    assert tab.dtype == np.float32 and tab.shape == (2 * lim + 1,)
    for v in range(-lim, lim + 1):
        assert tab[v + lim] == mv_bits_est(v)
    for qp in (22, 37):
        from uvg266_tpu.control.partition import qp_to_lambda
        lam = qp_to_lambda(qp, False)
        pen, fpen = tb.me_penalties(lam, R, "cpu")
        np.testing.assert_array_equal(
            pen.numpy(), make_mv_penalty(R, np.sqrt(lam)).reshape(-1))
        lam_sqrt = np.sqrt(lam)
        want = np.empty(49, dtype=np.float32)
        for k in range(49):
            dxq, dyq = k % 7 - 3, k // 7 - 3
            want[k] = lam_sqrt * ((0.0 if dxq == 0 else 2.0)
                                  + (0.0 if dyq == 0 else 2.0))
        np.testing.assert_array_equal(fpen.numpy(), want)


@pytest.mark.parametrize("w,h,bd,intra", [(8, 8, 10, False),
                                          (16, 8, 10, True),
                                          (32, 32, 8, True)])
def test_rd_cost_pred_bitdepth_and_rounding(w, h, bd, intra):
    """K6 at 10 bits and with is_intra_slice (quant rounding 171): rd
    within K6's tolerance, (n - 1) * 2^-24 of rd (the bits estimate as
    per-bucket counts, ops/rd_cost.py)."""
    rng = np.random.default_rng(w + h + bd)
    mx = (1 << bd) - 1
    B = 12
    src = rng.integers(0, mx + 1, (B, h, w)).astype(np.int32)
    pred = np.clip(src + rng.integers(-40, 41, (B, h, w)), 0, mx) \
        .astype(np.int32)
    pred[0] = 0
    src[0] = mx
    extra = rng.integers(0, 12, B).astype(np.float32)
    tabs = tb.device_tables(w, h, bd, "cpu")
    differ = False
    fn = jax.jit(make_rd_cost_pred_fn(w, h, bd, intra))
    for qp in (22, 37):
        qps = qp + 6 * (bd - 8)
        wts = FAST_COEFF_WTS[qp]
        want = np.asarray(fn(pred, src, np.int32(qps), np.float32(LAM), wts,
                             extra))
        args = (_t(pred), _t(src), qps, LAM, _t(wts.astype(np.float32)),
                _t(extra), tabs, bd)
        got = rd.rd_cost_pred(*args, is_intra_slice=intra).numpy()
        np.testing.assert_allclose(got, want, rtol=(w * h - 1) * 2.0 ** -24)
        other = rd.rd_cost_pred(*args, is_intra_slice=not intra).numpy()
        differ |= not np.array_equal(other, got)
    assert differ          # the rounding offset reaches the quantiser
