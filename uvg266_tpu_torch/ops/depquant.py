"""Dependent quantization (VVC trellis quantizer).

Behavioral parity with the reference:
- normative dequantization with the 4-state machine, the qpDQ = qp+1
  fine step, qIdx = 2*level - sign*(state>>1), and the packed transition
  table 32040: dep_quant.c uvg_dep_quant_dequant:1069-1140
- encoder: a 4-state Viterbi over the reverse scan walk (the direction
  the state machine runs in). The reference's 8/12-state trellis with
  subblock banks (dep_quant.c:842-1060) jointly optimizes the last
  position and subblock flags; this implementation fixes the last
  position from a scalar-quant pass and optimizes the level/parity path.
  NOTE: the static rate model is a rough stand-in for the reference's
  CABAC-adaptive estimates; RD parity with scalar quant holds only near
  mid QP (see tests), so the tool is opt-in until the adaptive rate
  estimator lands.

State transitions: T[state][level & 1] = [[0,2],[2,0],[1,3],[3,1]].
States 2,3 use the offset quantizer (reconstruction shifted by half a
fine step).
"""
from __future__ import annotations

import numpy as np

from .quant import LOG2, quant_params
from .rdoq import _rate_model
from .scan import coeff_scan_table

STATE_TRANS = np.array([[0, 2], [2, 0], [1, 3], [3, 1]], dtype=np.int64)
DEP_LAMBDA_SCALE = 8.0
IQUANT_SHIFT = 6
INV_QUANT_SCALES = np.array([
    [40, 45, 51, 57, 64, 72],
    [57, 64, 72, 80, 90, 102],
], dtype=np.int64)


def dequant_dep(q: np.ndarray, qp_scaled: int, bitdepth: int = 8) -> np.ndarray:
    """Normative dep-quant dequantization (dep_quant.c:1069)."""
    h, w = q.shape
    lw, lh = LOG2[w], LOG2[h]
    scan = coeff_scan_table(lw, lh)
    flat = q.reshape(-1).astype(np.int64)
    out = np.zeros(w * h, dtype=np.int64)
    nz = np.nonzero(flat[scan])[0]
    if len(nz) == 0:
        return out.reshape(h, w).astype(np.int16)
    last = int(nz[-1])
    needs_sqrt2 = (lw + lh) % 2 == 1
    qp_dq = qp_scaled + 1
    qp_per, qp_rem = divmod(qp_dq, 6)
    transform_shift = 15 - bitdepth - ((lw + lh) >> 1) - needs_sqrt2
    shift = IQUANT_SHIFT + 1 - qp_per - transform_shift
    inv_scale = int(INV_QUANT_SCALES[int(needs_sqrt2), qp_rem])
    add = 0 if shift < 0 else (1 << shift) >> 1
    if shift < 0:
        inv_scale <<= -shift
        shift = 0
    state = 0
    for si in range(last, -1, -1):
        pos = int(scan[si])
        level = int(flat[pos])
        if level:
            q_idx = level * 2 + (-(state >> 1) if level > 0 else (state >> 1))
            v = (q_idx * inv_scale + add) >> shift
            out[pos] = max(-(1 << 15), min((1 << 15) - 1, v))
        state = int(STATE_TRANS[state][level & 1])
    return out.reshape(h, w).astype(np.int16)


def quant_dep(coef: np.ndarray, qp_scaled: int, bitdepth: int = 8,
              lam: float = 0.0, is_intra_slice: bool = True) -> np.ndarray:
    """Trellis quantization: 4-state Viterbi along the reverse scan."""
    h, w = coef.shape
    lw, lh = LOG2[w], LOG2[h]
    scan = coeff_scan_table(lw, lh)
    flat = coef.reshape(-1).astype(np.int64)
    a = np.abs(flat[scan])
    sgn = np.sign(flat[scan])
    qp_dq = qp_scaled + 1
    scale, q_bits, add0 = quant_params(qp_dq, lw, lh, bitdepth, False,
                                       is_intra_slice)
    # the dequant fine step satisfies qIdx = levelDouble >> (q_bits - 1)
    # (scale*inv_scale = 2^20 while QUANT_SHIFT + IQUANT_SHIFT + 1 = 21)
    q_bits -= 1
    ld = a * scale                       # levelDouble at the fine step
    # last position from plain rounding at the coarse (2x) step
    rough = (ld + (1 << q_bits)) >> (q_bits + 1)
    nz = np.nonzero(rough)[0]
    if len(nz) == 0:
        return np.zeros((h, w), dtype=np.int16)
    last = int(nz[-1])

    ts = q_bits - 14 - qp_dq // 6
    err_unit = 1.0 / (float(scale) * (2.0 ** ts))
    err_scale = err_unit * err_unit
    if lam <= 0.0:
        # the static rate model underestimates the doubled level alphabet;
        # the scale is calibrated so dep-quant lands at/below the scalar
        # operating point (see tests/test_depquant.py RD check)
        lam = 0.57 * 2.0 ** ((qp_scaled - 12) / 3.0) * DEP_LAMBDA_SCALE

    # precompute per-position candidate levels/costs/transitions for all
    # 4 states x 3 candidates (vectorized), leaving only the tiny 4-state
    # recurrence as a Python loop
    n = last + 1
    ld_w = ld[last::-1].astype(np.float64)       # walk order (reverse scan)
    offs = np.array([0, 0, 1, 1], dtype=np.int64)[None, :]        # [1,4]
    base = (ld[last::-1][:, None] + (offs << q_bits)) >> (q_bits + 1)
    lvls = np.stack([np.zeros_like(base), np.maximum(base, 0), base + 1],
                    axis=2)                                        # [n,4,3]
    q_idx = np.where(lvls > 0, 2 * lvls - offs[:, :, None], 0)
    d = ld_w[:, None, None] - (q_idx << q_bits).astype(np.float64)
    max_l = int(lvls.max())
    rate_lut = _rate_model(np.arange(max_l + 1))
    costs = d * d * err_scale + lam * rate_lut[lvls]               # [n,4,3]
    trans = STATE_TRANS[np.arange(4)[None, :, None],
                        (lvls & 1).astype(np.int64)]               # [n,4,3]

    INF = float("inf")
    dp = [0.0, INF, INF, INF]
    choices = []
    for k in range(n):
        ndp = [INF] * 4
        pick = [0] * 4
        back = [0] * 4
        ck = costs[k]
        tk = trans[k]
        lk = lvls[k]
        for s in range(4):
            ds = dp[s]
            if ds == INF:
                continue
            for c in range(3):
                ns = int(tk[s, c])
                t = ds + float(ck[s, c])
                if t < ndp[ns]:
                    ndp[ns] = t
                    pick[ns] = int(lk[s, c])
                    back[ns] = s
        choices.append((pick, back))
        dp = ndp
    # backtrack from the best terminal state
    best_end = int(np.argmin(dp))
    levels = np.zeros(w * h, dtype=np.int64)
    s = best_end
    for k in range(len(choices) - 1, -1, -1):
        pick, back = choices[k]
        lvl = pick[s]
        si = last - k
        levels[int(scan[si])] = lvl * int(sgn[si])
        s = back[s]
    out = levels.reshape(h, w)
    return np.clip(out, -32768, 32767).astype(np.int16)
