"""LFNST (low-frequency non-separable secondary transform).

Behavioral parity with the reference:
- kernels + mode->set LUT: lfnst_tables.h (spec constants, see
  lfnst_tables.py)
- forward/inverse NxN multiply with (x+64)>>7 rounding:
  transform.c uvg_fwd_lfnst_NxN:880, uvg_inv_lfnst_NxN:1079
- region gather/scatter incl. transpose and the top-left diagonal scan:
  transform.c uvg_fwd_lfnst:965, uvg_inv_lfnst:1104
- mode mapping (wide-angle + extended-mode ranges, transpose rule):
  transform.c get_lfnst_intra_mode:919, get_transpose_flag:939
"""
from __future__ import annotations

import numpy as np

from .lfnst_tables import LFNST_4X4, LFNST_8X8, LFNST_LUT
from .scan import coeff_scan_table

NUM_LUMA_MODE = 67
EXT_HALF = 14            # NUM_EXT_LUMA_MODE >> 1
DIA_IDX = 34


def _lfnst_mode(intra_mode: int, log2_w: int, log2_h: int) -> tuple[int, bool]:
    """(set index via LUT, transpose flag) for an intra mode."""
    from .intra import wide_angle_correction
    m = wide_angle_correction(intra_mode, log2_w, log2_h,
                              account_for_dc_planar=True)
    if m < 0:
        mm = m + EXT_HALF + NUM_LUMA_MODE
    elif m >= NUM_LUMA_MODE:
        mm = m + EXT_HALF
    else:
        mm = m
    transpose = (mm >= NUM_LUMA_MODE + EXT_HALF) \
        or (mm < NUM_LUMA_MODE and mm > DIA_IDX)
    return int(LFNST_LUT[mm]), transpose


def _top_left_scan(w: int, h: int) -> np.ndarray:
    """First-48 grouped diagonal scan of the top-left 8x8, with the
    block's row stride (uvg_coef_top_left_diag_scan_8x8)."""
    s8 = coeff_scan_table(3, 3)
    ys, xs = np.divmod(s8, 8)
    return (ys * w + xs).astype(np.int64)


def _gather_region(coef: np.ndarray, sb: int, transpose: bool) -> np.ndarray:
    """Read the LFNST input vector (16 or 48 coeffs) from the TU."""
    h, w = coef.shape
    if sb == 4:
        blk = coef[:4, :4]
        return (blk.T if transpose else blk).reshape(-1).astype(np.int64)
    out = np.zeros(48, dtype=np.int64)
    if transpose:
        for y in range(8):
            for k in range(4):
                out[8 * k + y] = coef[y, k]
            if y < 4:
                for k in range(4):
                    out[32 + 4 * k + y] = coef[y, 4 + k]
    else:
        idx = 0
        for y in range(8):
            stride = 8 if y < 4 else 4
            out[idx:idx + stride] = coef[y, :stride]
            idx += stride
    return out


def _scatter_region(coef: np.ndarray, vec: np.ndarray, sb: int,
                    transpose: bool) -> None:
    """Write the inverse-LFNST result back to the TU region."""
    h, w = coef.shape
    if sb == 4:
        blk = vec.reshape(4, 4)
        coef[:4, :4] = blk.T if transpose else blk
        return
    if transpose:
        for y in range(8):
            for k in range(4):
                coef[y, k] = vec[8 * k + y]
            if y < 4:
                for k in range(4):
                    coef[y, 4 + k] = vec[32 + 4 * k + y]
    else:
        idx = 0
        for y in range(8):
            stride = 8 if y < 4 else 4
            coef[y, :stride] = vec[idx:idx + stride]
            if y >= 4:
                coef[y, 4:8] = 0
            idx += stride


def fwd_lfnst(coef: np.ndarray, intra_mode: int, cu_log2_w: int,
              cu_log2_h: int, lfnst_idx: int) -> np.ndarray:
    """Apply forward LFNST on DCT2 coefficients; returns a new array with
    the whole block zeroed outside the LFNST outputs."""
    h, w = coef.shape
    sb = 8 if (w >= 8 and h >= 8) else 4
    mode_set, transpose = _lfnst_mode(intra_mode, cu_log2_w, cu_log2_h)
    K = (LFNST_8X8 if sb == 8 else LFNST_4X4)[mode_set, lfnst_idx - 1] \
        .astype(np.int64)
    vec = _gather_region(coef, sb, transpose)
    n_out = 8 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 16
    out16 = (K[:n_out] @ vec + 64) >> 7
    res = np.zeros_like(coef)
    scan = _top_left_scan(w, h) if sb == 8 else coeff_scan_table(
        int(np.log2(w)), int(np.log2(h)))
    flat = res.reshape(-1)
    flat[scan[:n_out]] = out16
    return res


def inv_lfnst(coef: np.ndarray, intra_mode: int, cu_log2_w: int,
              cu_log2_h: int, lfnst_idx: int) -> np.ndarray:
    """Inverse LFNST (decoder side + encoder reconstruction)."""
    h, w = coef.shape
    sb = 8 if (w >= 8 and h >= 8) else 4
    mode_set, transpose = _lfnst_mode(intra_mode, cu_log2_w, cu_log2_h)
    K = (LFNST_8X8 if sb == 8 else LFNST_4X4)[mode_set, lfnst_idx - 1] \
        .astype(np.int64)
    n_in = 8 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 16
    scan = _top_left_scan(w, h) if sb == 8 else coeff_scan_table(
        int(np.log2(w)), int(np.log2(h)))
    flat = coef.reshape(-1)
    vec16 = flat[scan[:16]].astype(np.int64)
    res = (K[:n_in].T @ vec16[:n_in] + 64) >> 7
    res = np.clip(res, -(1 << 15), (1 << 15) - 1)
    out = coef.copy()
    _scatter_region(out, res, sb, transpose)
    return out
