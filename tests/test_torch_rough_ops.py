"""The rough intra search of the port against the JAX package: K12b
predict_modes, K2 over the 35-mode stage-1 subset, and the K12c chain
rough_refine.

The same inputs, made from a seed with numpy, go through the JAX functions
(on the CPU) and the port's plain versions. Predictions, modes and SATDs
are integers and must be equal; rd goes through K6, whose bits estimate is
an order-free form of the reference's float32 sum, so it must agree within
(n - 1) * 2^-24 of rd for n samples (ops/rd_cost.py).
"""
import jax
import numpy as np
import pytest
import torch

from uvg266_tpu.ops.fast_cost_tables import FAST_COEFF_WTS
from uvg266_tpu.ops.intra_batch import (build_mode_tables, make_predict_fn,
                                        make_predict_modes_fn,
                                        make_refs_blocks_fn,
                                        slice_mode_tables)
from uvg266_tpu.ops.rd_cost import make_rough_refine_fn
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb

LAM = 57.9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (32, 16), (64, 64)])
@pytest.mark.parametrize("bd", [8, 10])
def test_predict_modes_and_subset_match_reference(w, h, bd):
    """K12b on random mode lists with 2, 66 and duplicates; K2 at the
    stage-1 subset against make_predict_fn(slice_mode_tables(...))."""
    rng = np.random.default_rng(w + h + bd)
    B = 5
    refs = rng.integers(0, 1 << bd, (B, 780)).astype(np.int32)
    modes = rng.integers(2, 67, (B, 4)).astype(np.int32)
    modes[0] = (2, 66, 2, 66)
    modes[1] = (34, 34, 3, 65)
    tables = build_mode_tables(w, h, bd, False)
    dt = tb.device_tables(w, h, bd, "cpu")
    want = np.asarray(jax.jit(make_predict_modes_fn(tables))(refs, modes))
    np.testing.assert_array_equal(
        ib.predict_modes_plain(_t(refs), _t(modes), dt).numpy(), want)
    want1 = np.asarray(jax.jit(make_predict_fn(
        slice_mode_tables(tables, tb.ROUGH_MODES)))(refs))
    got1 = ib.predict67_plain(_t(refs), dt, tb.rough_modes("cpu")).numpy()
    assert got1.shape == (B, 35, h, w)
    np.testing.assert_array_equal(got1, want1)


def _plane(bd, seed):
    """Random texture, anti-diagonal stripes (constant along x + y: the
    best angular mode 2 or 66, where the refine list clips onto a stage-1
    mode), smooth gradients and a flat area."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    H, W = 64, 256
    yy, xx = np.mgrid[0:H, 0:W]
    p = rng.integers(0, mx + 1, (H, W))
    p[:, 64:128] = ((xx + yy)[:, 64:128] % 8 < 4) * mx
    p[:, 128:192] = (xx[:, 128:192] * 3 + yy[:, 128:192] * 5) * mx // 1200
    p[:, 192:] = mx // 2
    return p.astype(np.int32)


@pytest.mark.parametrize("w,h,bd", [(8, 8, 8), (16, 16, 10), (32, 16, 8),
                                    (8, 4, 10), (64, 64, 8)])
def test_rough_refine_matches_reference(w, h, bd):
    src = _plane(bd, seed=w * h + bd)
    H, W = src.shape
    xs, ys = np.meshgrid(np.arange(0, W - w + 1, w), np.arange(0, H - h + 1,
                                                               h))
    xs = xs.reshape(-1).astype(np.int32)
    ys = ys.reshape(-1).astype(np.int32)
    refs, blocks = jax.jit(make_refs_blocks_fn(w, h))(src, xs, ys)
    refs, blocks = np.asarray(refs), np.asarray(blocks)
    dt = tb.device_tables(w, h, bd, "cpu")
    m1 = tb.rough_modes("cpu")
    fn = jax.jit(make_rough_refine_fn(w, h, bd))
    for qp in (22, 37):
        qps = qp + 6 * (bd - 8)
        ft = tb.frame_tables(qp, "cpu")
        want = [np.asarray(a) for a in fn(refs, blocks, np.int32(qps),
                                          np.float32(LAM), FAST_COEFF_WTS[qp],
                                          tb.MODE_BITS)]
        got = [a.numpy() for a in rd.rough_refine_plain(
            _t(refs), _t(blocks), qps, LAM, ft["wts"], ft["mode_bits"], dt,
            bd, m1)]
        np.testing.assert_array_equal(got[0], want[0])      # best_mode
        np.testing.assert_array_equal(got[2], want[2])      # satd_best
        np.testing.assert_allclose(got[1], want[1],
                                   rtol=(w * h - 1) * 2.0 ** -24)
    # blocks whose best angular stage-1 mode is 2 or 66 (clipped refines)
    s1 = ib.satd67_plain(ib.predict67_plain(_t(refs), dt, m1), _t(blocks))
    refine = rd.rough_select_plain(s1, LAM, ft["mode_bits"], m1)
    assert ((refine[:, 0] == 2) | (refine[:, 1] == 66)).any()
