"""Forward/inverse 2-D transforms (DCT-II / DST-VII / DCT-VIII), bit-exact.

Pipeline parity with the reference generic implementation
(dct-generic.c: mts_dct_generic:2560, mts_idct_generic:2622, butterfly
macros :720-770).  In matrix form, for an h x w residual block X:

  forward:  C  = rshift_round(Mv @ rshift_round(X @ Mh^T, s1), s2)
            s1 = log2(w) - 1 + bitdepth - 8,   s2 = log2(h) - 1 + 7
  inverse:  X' = clip16(rshift_round(clip16(rshift_round(Mv^T @ C, 7)) @ Mh,
                        20 - bitdepth))

Zero-out rules: a non-DCT2 32-point dimension keeps 16 coefficients; any
64-point dimension keeps 32 (mts_dct_generic:2582-2583).

On TPU these run as batched integer matmuls over fixed-size TU batches; XLA
maps them onto the MXU (values fit 16 bits so the int32 dot is exact).
"""
from __future__ import annotations

import numpy as np

from .tr_matrices import DCT2, DCT8, DST7, get_matrix

LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6}


def fwd_shifts(width: int, height: int, bitdepth: int) -> tuple[int, int]:
    return LOG2[width] - 1 + bitdepth - 8, LOG2[height] - 1 + 7


def inv_shifts(bitdepth: int) -> tuple[int, int]:
    return 7, 20 - bitdepth


def zero_out(width: int, type_hor: int, type_ver: int, height: int) -> tuple[int, int]:
    """Number of retained coefficients per dimension."""
    keep_w = 16 if (type_hor != DCT2 and width == 32) else min(width, 32)
    keep_h = 16 if (type_ver != DCT2 and height == 32) else min(height, 32)
    return keep_w, keep_h


def _rshift_round(x, shift):
    # arithmetic shift with rounding, matching C ((v + (1<<(s-1))) >> s);
    # shift can reach 0 / negative for 1- and 2-point ISP transforms
    if shift <= 0:
        return x << (-shift)
    return (x + (1 << (shift - 1))) >> shift


def fwd_transform_2d(x: np.ndarray, type_hor: int = DCT2, type_ver: int = DCT2,
                     bitdepth: int = 8, lfnst: bool = False) -> np.ndarray:
    """Bit-exact numpy forward transform of one h x w block."""
    h, w = x.shape
    s1, s2 = fwd_shifts(w, h, bitdepth)
    mh = get_matrix(type_hor, w).astype(np.int64)
    mv = get_matrix(type_ver, h).astype(np.int64)
    tmp = _rshift_round(x.astype(np.int64) @ mh.T, s1).astype(np.int16).astype(np.int64)
    c = _rshift_round(mv @ tmp, s2).astype(np.int16)
    keep_w, keep_h = zero_out(w, type_hor, type_ver, h)
    if lfnst:
        if (w == 4 and h > 4) or (w > 4 and h == 4):
            keep_w, keep_h = 4, 4
        elif w >= 8 and h >= 8:
            keep_w, keep_h = 8, 8
    if keep_w < w:
        c[:, keep_w:] = 0
    if keep_h < h:
        c[keep_h:, :] = 0
    return c


def inv_transform_2d(c: np.ndarray, type_hor: int = DCT2, type_ver: int = DCT2,
                     bitdepth: int = 8) -> np.ndarray:
    """Bit-exact numpy inverse transform of one h x w coefficient block."""
    h, w = c.shape
    s1, s2 = inv_shifts(bitdepth)
    mh = get_matrix(type_hor, w).astype(np.int64)
    mv = get_matrix(type_ver, h).astype(np.int64)
    u = np.clip(_rshift_round(mv.T @ c.astype(np.int64), s1), -32768, 32767)
    x = np.clip(_rshift_round(u @ mh, s2), -32768, 32767).astype(np.int16)
    return x
