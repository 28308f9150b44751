"""Distortion cost kernels: SAD / SATD / SSD.

Behavioral parity with the reference cost kernels
(uvg266 src/strategies/generic/picture-generic.c: satd_4x4
:215, satd_8x8_subblock :324, satd_any_size :507, reg_sad, ssd).
SATD is the 2-D Hadamard-transformed SAD computed on 8x8 subblocks
(4x4 for blocks with a dimension of 4), matching the reference exactly
so RD decisions can be compared 1:1.

numpy implementations are fully vectorized over the batch dimension —
these are also the golden models for the JAX/Pallas search kernels.
"""
from __future__ import annotations

import numpy as np


def _hadamard_matrix(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H4 = _hadamard_matrix(4)
_H8 = _hadamard_matrix(8)


def sad(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sum of absolute differences over the last two axes."""
    return np.abs(a.astype(np.int64) - b.astype(np.int64)).sum(axis=(-2, -1))


def ssd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a.astype(np.int64) - b.astype(np.int64)
    return (d * d).sum(axis=(-2, -1))


def _satd_blocks(diff: np.ndarray, h_mat: np.ndarray, norm_add: int,
                 norm_shift: int) -> np.ndarray:
    """Hadamard-SATD of [..., n, n] difference blocks.

    Matches the reference exactly, including the DC down-weighting
    (sad -= abs(dc); sad += abs(dc) >> 2) before normalization
    (picture-generic.c:246-248, 341-344).
    """
    t = np.abs(h_mat @ diff.astype(np.int64) @ h_mat)
    s = t.sum(axis=(-2, -1))
    dc = t[..., 0, 0]
    s = s - dc + (dc >> 2)
    return (s + norm_add) >> norm_shift


def satd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SATD over the last two axes, any size >= 4 (satd_any_size_generic).

    8x8 Hadamard subblocks with the reference normalization
    ((sum + 2) >> 2); 4-wide/high blocks use 4x4 subblocks ((sum + 1) >> 1).
    """
    *batch, h, w = a.shape
    d = a.astype(np.int64) - b.astype(np.int64)
    if w >= 8 and h >= 8:
        n, add, shift, hm = 8, 2, 2, _H8
    else:
        n, add, shift, hm = 4, 1, 1, _H4
    bh, bw = h // n, w // n
    d = d.reshape(*batch, bh, n, bw, n)
    d = np.moveaxis(d, -2, -3)            # [..., bh, bw, n, n]
    sub = _satd_blocks(d, hm, add, shift)
    return sub.sum(axis=(-2, -1))
