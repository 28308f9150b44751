"""VVC transform matrices (DCT-II, DST-VII, DCT-VIII) generated from their
basis parameter lists.

The H.266 spec defines each transform matrix by a small list of integer basis
amplitudes; every matrix element is +/- one of those amplitudes (or 0),
selected by exact trigonometric index reduction.  The reference encoder
encodes the same structure as C macros (dct-generic.c:830-1027
DEFINE_{DCT2,DST7,DCT8}_P*_MATRIX); we generate the matrices from the
parameter lists and the reduction rules, which the tests verify
element-exactly against frozen hashes of the reference tables.

``device_matrix`` keeps an int8 copy of each matrix per device (every entry
lies within +-91), as the transform kernels read them; ``device_matrix32``
an int32 copy (or its transpose), as K13 reads its DST7 / DCT8 matrices.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device_cache

# odd-frequency basis amplitudes of the DCT-II matrices per size
DCT2_ODD = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
    64: [91, 90, 90, 90, 88, 87, 86, 84, 83, 81, 79, 77, 73, 71, 69, 65, 62,
         59, 56, 52, 48, 44, 41, 37, 33, 28, 24, 20, 15, 11, 7, 2],
}

# DST-VII basis amplitudes p[i] ~ S*sin((i+1)*pi/(2N+1))
DST7_PARAMS = {
    4: [29, 55, 74, 84],
    8: [17, 32, 46, 60, 71, 78, 85, 86],
    16: [8, 17, 25, 33, 40, 48, 55, 62, 68, 73, 77, 81, 85, 87, 88, 88],
    32: [4, 9, 13, 17, 21, 26, 30, 34, 38, 42, 46, 50, 53, 56, 60, 63, 66,
         68, 72, 74, 77, 78, 80, 82, 84, 85, 86, 87, 88, 89, 90, 90],
}


def _dct2_value(a: int, n: int) -> int:
    """Value of S*cos(a*pi/(2n)) on the integer amplitude grid, a in [0, n]."""
    if a == 0:
        return 64
    if a & 1:
        return DCT2_ODD[n][(a - 1) >> 1]
    return _dct2_value(a >> 1, n >> 1)


@functools.lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """Forward DCT-II matrix, rows = frequencies: M[k][j] ~ S*cos((2j+1)k*pi/2n)."""
    if n == 1:
        # 1-point transform (ISP 1xN sub-TUs): pure 64x scaling
        return np.array([[64]], dtype=np.int32)
    m = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            x = ((2 * j + 1) * k) % (4 * n)
            if x > 2 * n:
                x = 4 * n - x
            sign = 1
            if x > n:
                sign = -1
                x = 2 * n - x
            m[k, j] = sign * _dct2_value(x, n)
    return m


@functools.lru_cache(maxsize=None)
def dst7_matrix(n: int) -> np.ndarray:
    """Forward DST-VII: M[k][j] ~ S*sin((2k+1)(j+1)*pi/(2n+1))."""
    p = DST7_PARAMS[n]
    d = 2 * n + 1
    m = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            x = ((2 * k + 1) * (j + 1)) % (2 * d)
            sign = 1
            if x >= d:
                sign = -1
                x -= d
            if x > n:
                x = d - x
            m[k, j] = 0 if x == 0 else sign * p[x - 1]
    return m


@functools.lru_cache(maxsize=None)
def dct8_matrix(n: int) -> np.ndarray:
    """Forward DCT-VIII: M[k][j] ~ S*cos((2k+1)(2j+1)*pi/(4n+2)).

    Shares the DST-VII amplitude grid: cos(x*pi/D) = sin((2n+1-x)*pi/D)."""
    p = DST7_PARAMS[n]
    d = 2 * (2 * n + 1)
    m = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            x = ((2 * k + 1) * (2 * j + 1)) % (2 * d)
            if x > d:
                x = 2 * d - x
            sign = 1
            if x > d // 2:
                sign = -1
                x = d - x
            mm = (2 * n + 1 - x) >> 1
            m[k, j] = 0 if mm == 0 else sign * p[mm - 1]
    return m


# transform type ids matching the reference (transform.h tr_type_t)
DCT2, DCT8, DST7 = 0, 1, 2


def get_matrix(tr_type: int, n: int) -> np.ndarray:
    if tr_type == DCT2:
        return dct2_matrix(n)
    if tr_type == DST7:
        return dst7_matrix(n)
    if tr_type == DCT8:
        return dct8_matrix(n)
    raise ValueError(tr_type)


@device_cache
def device_matrix(tr_type: int, n: int, device: str) -> torch.Tensor:
    """get_matrix(tr_type, n) as int8 on ``device``, built once per process."""
    return torch.from_numpy(get_matrix(tr_type, n).astype(np.int8)) \
        .to(torch.device(device))


@device_cache
def device_matrix32(tr_type: int, n: int, device: str,
                    transpose: bool = False) -> torch.Tensor:
    """get_matrix(tr_type, n), or its transpose, as int32 on ``device``,
    built once per process: K13 reads a DST7 / DCT8 matrix's rows (the
    forward) or its columns (the inverse) four at a time."""
    m = get_matrix(tr_type, n).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(m.T if transpose else m)) \
        .to(torch.device(device))
