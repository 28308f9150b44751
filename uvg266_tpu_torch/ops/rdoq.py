"""Rate-distortion optimized quantization (RDOQ), vectorized.

The reference's uvg_rdoq (rdo.c:1449) walks coefficients in scan order,
choosing each level by d + lambda*rate with live CABAC context states,
then optimizes coefficient-group zeroing and the last-position choice.
That walk is inherently sequential; this module implements the same three
decisions as whole-block vector operations (numpy; one pass per TU):

1. per-coefficient level choice among {ceil, floor, 0} with a static
   monotone rate model (sig/gt1/par/gt3 flag estimates plus an
   exp-Golomb tail for large levels),
2. last-significant-position optimization via cumulative cost scans,
3. coefficient-group zeroing for groups whose coded cost exceeds their
   distortion saving.

Static rates replace the context-adaptive estimates of the reference;
decisions only steer the encoder, so any outcome remains decodable.
Distortion is measured in the pixel-SSD domain (levelDouble error scaled
by the quantizer and forward-transform gains), matching the lambda units
of the partition/mode RD costs.
"""
from __future__ import annotations

import numpy as np

from .. import trace
from .quant import LOG2, quant_params
from .scan import GROUP_IDX, coeff_scan_table, log2_sbb_size

_LAST_CTX_BITS = 1.3      # avg bits per last_sig prefix ctx bin
_SIG_GROUP_BITS = 1.2     # sig_coeff_group flag estimate

# static per-level rate estimates (bits): sig / gt1 / par / gt3 flags with
# typical adapted-context costs, plus the EP sign bit; the remainder tail
# follows go-Rice / exp-Golomb growth. What drives the level decision is
# the monotone *increments* between adjacent levels (~2.4 bits for 0->1,
# ~1 bit per step after), mirroring the shape of the reference's live
# context estimates (rdo.c get_coeff_cost) without the sequential state.
_R0 = 0.3
_R_STEPS = np.array([0.0, 2.4, 3.4, 4.4], dtype=np.float64)


def _rate_model(levels: np.ndarray) -> np.ndarray:
    """Approximate residual-coding bits for |level| values."""
    l = np.abs(levels.astype(np.int64))
    bits = np.where(l == 0, _R0, _R_STEPS[np.minimum(l, 3)])
    big = l > 3
    if big.any():
        bits = bits.astype(np.float64).copy()
        bits[big] = _R_STEPS[3] + 1.5 * np.log2(l[big].astype(np.float64) - 2.0)
    return bits


def rate_table(n: int) -> np.ndarray:
    """_rate_model of the levels 0 .. n-1: the native rdoq's rates, so
    that its log2 tail rounds as numpy's does."""
    return _rate_model(np.arange(n, dtype=np.int64))


# native.rdoq_levels_native once the library loads, False where it cannot
_NATIVE = None


def rdoq_levels(coef: np.ndarray, qp_scaled: int, bitdepth: int,
                lam: float, is_intra_slice: bool = True) -> np.ndarray:
    """RDO-quantize one h x w transform block; returns int16 levels.

    The native library's C++ rdoq gives rdoq_levels_numpy's levels
    (tests/test_torch_rdoq_native.py); the numpy function decides where
    the library does not load, and the blocks the C++ leaves to it."""
    global _NATIVE
    if _NATIVE is None:
        try:
            from ..native import get_lib, rdoq_levels_native
            get_lib()
            _NATIVE = rdoq_levels_native
        except Exception:
            _NATIVE = False
    if _NATIVE:
        out = _NATIVE(coef, qp_scaled, bitdepth, lam)
        if out is not None:
            trace.count("rdoq_native", 1)
            return out
    return rdoq_levels_numpy(coef, qp_scaled, bitdepth, lam, is_intra_slice)


def rdoq_levels_numpy(coef: np.ndarray, qp_scaled: int, bitdepth: int,
                      lam: float, is_intra_slice: bool = True) -> np.ndarray:
    """RDO-quantize one h x w transform block in numpy; returns int16
    levels."""
    h, w = coef.shape
    log2_w, log2_h = LOG2[w], LOG2[h]
    scale, q_bits, _add = quant_params(qp_scaled, log2_w, log2_h, bitdepth,
                                       False, is_intra_slice)

    a = np.abs(coef.astype(np.int64))
    sign = np.sign(coef.astype(np.int64))
    level_double = a * scale
    l_floor = level_double >> q_bits

    # pixel-domain error scale: levelDouble/2^qbits is the coefficient in
    # quantizer units; dividing by (scale/2^qbits) recovers the coefficient,
    # and the forward transform carries a 2^transform_shift gain over
    # orthonormal, so SSD_pixel = (d_levelDouble / (scale * 2^ts))^2
    ts = q_bits - 14 - qp_scaled // 6  # = transform_shift used in quant
    err_unit = 1.0 / (float(scale) * (2.0 ** ts))
    err_scale = err_unit * err_unit

    def dist(lvl):
        d = (level_double - (lvl.astype(np.int64) << q_bits)).astype(np.float64)
        return d * d * err_scale

    # --- 1. per-coefficient level decision -------------------------------
    cands = [np.zeros_like(l_floor), l_floor, l_floor + 1]
    costs = [dist(c) + lam * _rate_model(c) for c in cands]
    cost = np.minimum(np.minimum(costs[0], costs[1]), costs[2])
    lvl = np.where(costs[2] == cost, cands[2],
                   np.where(costs[1] == cost, cands[1], cands[0]))
    lvl = np.minimum(lvl, 32767)
    cost0 = dist(np.zeros_like(l_floor)) + lam * _R0

    if not lvl.any():
        return np.zeros((h, w), dtype=np.int16)

    # --- 2. last-significant-position optimization -----------------------
    scan = coeff_scan_table(log2_w, log2_h)           # scan idx -> flat pos
    lvl_s = lvl.reshape(-1)[scan]
    cost_s = cost.reshape(-1)[scan]
    cost0_s = cost0.reshape(-1)[scan]
    n = lvl_s.shape[0]
    # total cost with last at scan pos i: sum(cost_s[:i+1]) + last_bits(i)
    #                                     + sum(cost0_s[i+1:])
    csum = np.cumsum(cost_s)
    zsum_tail = np.concatenate([np.cumsum(cost0_s[::-1])[::-1][1:], [0.0]])
    xs = scan % w
    ys = scan // w
    last_bits = _LAST_CTX_BITS * (GROUP_IDX[xs] + GROUP_IDX[ys] + 2.0) \
        + np.maximum(0, (GROUP_IDX[xs] >> 1) - 1) \
        + np.maximum(0, (GROUP_IDX[ys] >> 1) - 1)
    total = csum + lam * last_bits + zsum_tail
    cand_mask = lvl_s > 0
    total_all_zero = float(np.sum(cost0_s))  # cbf = 0
    total = np.where(cand_mask, total, np.inf)
    best_i = int(np.argmin(total))
    if total_all_zero <= total[best_i]:
        return np.zeros((h, w), dtype=np.int16)
    lvl_s = lvl_s.copy()
    lvl_s[best_i + 1:] = 0

    # --- 3. coefficient-group zeroing ------------------------------------
    log2_cg_w, log2_cg_h = log2_sbb_size(log2_w, log2_h)
    cg_size = 1 << (log2_cg_w + log2_cg_h)
    n_cg = n // cg_size
    if n_cg > 1:
        lvl_cg = lvl_s.reshape(n_cg, cg_size)
        cost_cg = np.where(lvl_cg > 0, cost_s.reshape(n_cg, cg_size),
                           cost0_s.reshape(n_cg, cg_size)).sum(axis=1)
        zero_cg = cost0_s.reshape(n_cg, cg_size).sum(axis=1)
        last_cg = best_i // cg_size
        for g in range(1, last_cg):      # keep DC group and the last group
            if lvl_cg[g].any() and zero_cg[g] < cost_cg[g] \
                    + lam * _SIG_GROUP_BITS:
                lvl_cg[g] = 0
        lvl_s = lvl_cg.reshape(-1)

    out = np.zeros(h * w, dtype=np.int64)
    out[scan] = lvl_s
    out = out.reshape(h, w) * sign
    return np.clip(out, -32768, 32767).astype(np.int16)
