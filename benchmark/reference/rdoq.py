"""The benchmark's plain reference of the rate-distortion optimised
quantisation that the ``medium`` preset's finalize runs on every
transform block (``ops/rdoq.py`` ``rdoq_levels``, with
``ops/quant.py`` ``quant_params`` and the scan tables of ``ops/scan.py``),
copied as they stood when the benchmark was written; nothing here imports
the port or JAX.

``dtype`` sets the precision of the distortion and rate costs: float64
as the program computes them, float32 for the control.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .tables import QUANT_SCALES

LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6}
QUANT_SHIFT = 14
MAX_TR_DYNAMIC_RANGE = 15

_LAST_CTX_BITS = 1.3
_SIG_GROUP_BITS = 1.2
_R0 = 0.3
_R_STEPS = np.array([0.0, 2.4, 3.4, 4.4], dtype=np.float64)

# uvg_g_log2_sbb_size[log2_w][log2_h] -> (log2_sbb_w, log2_sbb_h)
_LOG2_SBB_SIZE = [
    [(0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 4), (0, 4), (0, 4)],
    [(1, 0), (1, 1), (1, 1), (1, 3), (1, 3), (1, 3), (1, 3), (1, 3)],
    [(2, 0), (1, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
    [(3, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
    [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
    [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
    [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
    [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
]
GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4 + [8] * 8 + [9] * 8
    + [10] * 16 + [11] * 16, dtype=np.int32)


def quant_params(qp_scaled: int, log2_w: int, log2_h: int, bitdepth: int,
                 is_intra_slice: bool):
    """(scale, q_bits, add) of the scalar quantiser (no transform skip)."""
    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    shift = MAX_TR_DYNAMIC_RANGE - bitdepth - ((log2_w + log2_h) >> 1) \
        - needs_sqrt2
    q_bits = QUANT_SHIFT + qp_scaled // 6 + shift
    add = (171 if is_intra_slice else 85) << (q_bits - 9)
    return int(QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6]), q_bits, add


def _diag_scan(w: int, h: int) -> np.ndarray:
    order = []
    for d in range(w + h - 1):
        for x in range(max(0, d - h + 1), min(d, w - 1) + 1):
            order.append((d - x) * w + x)
    return np.array(order, dtype=np.int32)


@lru_cache(maxsize=None)
def coeff_scan(log2_w: int, log2_h: int) -> np.ndarray:
    """The grouped up-right diagonal scan: index -> raster position."""
    w = 1 << log2_w
    sw, sh = _LOG2_SBB_SIZE[log2_w][log2_h]
    cgw = 1 << sw
    cg_order = _diag_scan(1 << (log2_w - sw), 1 << (log2_h - sh))
    inner = _diag_scan(cgw, 1 << sh)
    cg_grid_w = w >> sw
    out = []
    for cg in cg_order:
        cg_y = (int(cg) // cg_grid_w) << sh
        cg_x = (int(cg) % cg_grid_w) << sw
        for p in inner:
            py, px = divmod(int(p), cgw)
            out.append((cg_y + py) * w + (cg_x + px))
    return np.array(out, dtype=np.int32)


def _rate_model(levels: np.ndarray, dtype) -> np.ndarray:
    lv = np.abs(levels.astype(np.int64))
    steps = _R_STEPS.astype(dtype)
    bits = np.where(lv == 0, dtype(_R0), steps[np.minimum(lv, 3)])
    big = lv > 3
    if big.any():
        bits = bits.astype(dtype).copy()
        bits[big] = steps[3] + dtype(1.5) * np.log2(
            lv[big].astype(dtype) - dtype(2.0))
    return bits.astype(dtype)


def rdoq_levels(coef: np.ndarray, qp_scaled: int, bitdepth: int,
                lam: float, is_intra_slice: bool = True,
                dtype=np.float64) -> np.ndarray:
    """RDO-quantise one h x w transform block -> int16 levels."""
    h, w = coef.shape
    log2_w, log2_h = LOG2[w], LOG2[h]
    scale, q_bits, _add = quant_params(qp_scaled, log2_w, log2_h, bitdepth,
                                       is_intra_slice)
    lam = dtype(lam)
    a = np.abs(coef.astype(np.int64))
    sign = np.sign(coef.astype(np.int64))
    level_double = a * scale
    l_floor = level_double >> q_bits
    ts = q_bits - 14 - qp_scaled // 6
    err_unit = 1.0 / (float(scale) * (2.0 ** ts))
    err_scale = dtype(err_unit * err_unit)

    def dist(lvl):
        d = (level_double - (lvl.astype(np.int64) << q_bits)).astype(dtype)
        return d * d * err_scale

    cands = [np.zeros_like(l_floor), l_floor, l_floor + 1]
    costs = [dist(c) + lam * _rate_model(c, dtype) for c in cands]
    cost = np.minimum(np.minimum(costs[0], costs[1]), costs[2])
    lvl = np.where(costs[2] == cost, cands[2],
                   np.where(costs[1] == cost, cands[1], cands[0]))
    lvl = np.minimum(lvl, 32767)
    cost0 = dist(np.zeros_like(l_floor)) + lam * dtype(_R0)
    if not lvl.any():
        return np.zeros((h, w), dtype=np.int16)

    scan = coeff_scan(log2_w, log2_h)
    lvl_s = lvl.reshape(-1)[scan]
    cost_s = cost.reshape(-1)[scan]
    cost0_s = cost0.reshape(-1)[scan]
    n = lvl_s.shape[0]
    csum = np.cumsum(cost_s)
    zsum_tail = np.concatenate([np.cumsum(cost0_s[::-1])[::-1][1:],
                                np.zeros(1, dtype=dtype)])
    xs = scan % w
    ys = scan // w
    last_bits = (_LAST_CTX_BITS * (GROUP_IDX[xs] + GROUP_IDX[ys] + 2.0)
                 + np.maximum(0, (GROUP_IDX[xs] >> 1) - 1)
                 + np.maximum(0, (GROUP_IDX[ys] >> 1) - 1)).astype(dtype)
    total = csum + lam * last_bits + zsum_tail
    total_all_zero = dtype(np.sum(cost0_s))
    total = np.where(lvl_s > 0, total, dtype(np.inf))
    best_i = int(np.argmin(total))
    if total_all_zero <= total[best_i]:
        return np.zeros((h, w), dtype=np.int16)
    lvl_s = lvl_s.copy()
    lvl_s[best_i + 1:] = 0

    sw, sh = _LOG2_SBB_SIZE[log2_w][log2_h]
    cg_size = 1 << (sw + sh)
    n_cg = n // cg_size
    if n_cg > 1:
        lvl_cg = lvl_s.reshape(n_cg, cg_size)
        cost_cg = np.where(lvl_cg > 0, cost_s.reshape(n_cg, cg_size),
                           cost0_s.reshape(n_cg, cg_size)).sum(axis=1)
        zero_cg = cost0_s.reshape(n_cg, cg_size).sum(axis=1)
        for g in range(1, best_i // cg_size):
            if lvl_cg[g].any() and zero_cg[g] < cost_cg[g] \
                    + lam * dtype(_SIG_GROUP_BITS):
                lvl_cg[g] = 0
        lvl_s = lvl_cg.reshape(-1)

    out = np.zeros(h * w, dtype=np.int64)
    out[scan] = lvl_s
    out = out.reshape(h, w) * sign
    return np.clip(out, -32768, 32767).astype(np.int16)
