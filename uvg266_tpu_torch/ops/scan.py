"""Coefficient scan orders and residual-coding lookup tables.

Generates the VVC up-right-diagonal scan tables programmatically — the
analogue of the reference's generated tables.c (g_sig_last_scan_* /
g_scan_order, produced by tools/generate_tables.c) and the sbb-size table
uvg_g_log2_sbb_size (tables.c:13-24).  The grouped scan walks 4x4 (or
degenerate-shape) coefficient subblocks in diagonal order, with a diagonal
scan inside each subblock.

Also hosts the last-position group tables (encoderstate.h:424-453) and the
Golomb-Rice parameter table (tables.h:44-50).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

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


def log2_sbb_size(log2_w: int, log2_h: int) -> tuple[int, int]:
    return _LOG2_SBB_SIZE[log2_w][log2_h]


def _diag_scan(w: int, h: int) -> np.ndarray:
    """Up-right diagonal scan: raster positions in scan order.

    Within each anti-diagonal d = x + y, positions are visited with x
    ascending (bottom-left to top-right).
    """
    order = []
    for d in range(w + h - 1):
        for x in range(max(0, d - h + 1), min(d, w - 1) + 1):
            y = d - x
            order.append(y * w + x)
    return np.array(order, dtype=np.int32)


@lru_cache(maxsize=None)
def cg_scan_table(log2_w: int, log2_h: int) -> np.ndarray:
    """Scan order of coefficient subblocks (SCAN_GROUP_UNGROUPED analogue):
    index i -> raster position of the i-th scanned CG in the CG grid."""
    sw, sh = log2_sbb_size(log2_w, log2_h)
    return _diag_scan(1 << (log2_w - sw), 1 << (log2_h - sh))


@lru_cache(maxsize=None)
def coeff_scan_table(log2_w: int, log2_h: int) -> np.ndarray:
    """Full grouped coefficient scan (SCAN_GROUP_4X4 analogue):
    index i -> raster position within the w x h block."""
    w, h = 1 << log2_w, 1 << log2_h
    sw, sh = log2_sbb_size(log2_w, log2_h)
    cgw, cgh = 1 << sw, 1 << sh
    cg_order = cg_scan_table(log2_w, log2_h)
    inner = _diag_scan(cgw, cgh)
    cg_grid_w = w >> sw
    out = np.empty(w * h, dtype=np.int32)
    pos = 0
    for cg in cg_order:
        cg_y = (cg // cg_grid_w) << sh
        cg_x = (cg % cg_grid_w) << sw
        for p in inner:
            py, px = divmod(int(p), cgw)
            out[pos] = (cg_y + py) * w + (cg_x + px)
            pos += 1
    return out


# last significant coefficient position group tables (encoderstate.h:424-453)
GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4 + [8] * 8 + [9] * 8
    + [10] * 16 + [11] * 16, dtype=np.int32)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96],
                        dtype=np.int32)

# Golomb-Rice parameter by neighbourhood abs-sum (tables.h:44-50)
GO_RICE_PARS = np.array(
    [0] * 7 + [1] * 7 + [2] * 14 + [3] * 4, dtype=np.int32)
