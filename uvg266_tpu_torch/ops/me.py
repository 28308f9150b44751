"""Motion-vector rate estimates of the motion search (host, numpy).

Port of the host half of uvg266_tpu/ops/me.py: the mvd bit estimate and
the full-pel rate-penalty table. The dense full-pel and 7x7 fractional
search factories of that module (make_fullpel_search_fn,
make_frac_search_fn, kernel K9) belong to the per-class inter path and are
not ported yet (ROADMAP.md, 'Modules to port', item 7b).
"""
from __future__ import annotations

import numpy as np


def mv_bits_est(v: int) -> float:
    """Approximate signaled bits for one quarter-pel mvd component
    (abs_mvd coding: greater0 + greater1 + EG1 + sign)."""
    a = abs(v)
    if a == 0:
        return 1.0
    if a == 1:
        return 3.0
    # EG1 length for a-2
    k = a - 2
    length = 1
    count = 1
    while k >= (1 << count):
        k -= 1 << count
        count += 1
        length += 2
    return 2.0 + length + count + 1


def make_mv_penalty(r: int, lam_sqrt: float) -> np.ndarray:
    """[2r+1, 2r+1] rate penalty for full-pel offsets (quarter-pel mvd
    magnitude = 4*offset), biasing toward small vectors."""
    n = 2 * r + 1
    out = np.zeros((n, n), dtype=np.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out[dy + r, dx + r] = lam_sqrt * (mv_bits_est(4 * dx)
                                              + mv_bits_est(4 * dy))
    return out
