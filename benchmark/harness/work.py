"""The yardstick of the roofline metrics: the published peaks of one
NVIDIA H100 SXM and the work the all-intra frame search needs.

The operation counts are those of ``chip_smoke.py`` ``work()`` for
refs_blocks_grid, predict67, satd67 and rd_cost (copied as they stood
when the benchmark was written), recast as one function per size class:
the reference lines, the 67-mode prediction, the SATD, the mode decision
and the RD cost of the winner. Its bytes are what that one function must
move: each sample of the picture read once, each block's decision (mode
and cost, four bytes each) written once. The predictions between the
stages are not counted, so any fusion of the stages reads the same work.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
OPS_PER_S = 67e12             # H100 SXM float32 rate outside the tensor cores
MODES = 67


def dct_ops(n: int) -> int:
    """Operations of one n-point integer DCT-II as a partial butterfly."""
    return 4 if n <= 2 else n + 2 * (n // 2) ** 2 + dct_ops(n // 2)


def satd_ops(n: int) -> int:
    """Operations per sample of an n x n Hadamard SATD."""
    return 1 + 2 * (n.bit_length() - 1) + 2


def class_ops(B: int, s: int) -> int:
    """Operations of one s x s class of B blocks: the reference lines and
    their smoothing, 12 a predicted sample, the SATD of every mode, and per
    block the mode costs, the residual, a forward and an inverse 2-D
    transform, the quantiser, the dequantiser and the reconstruction with
    its SSD."""
    hw = s * s
    tr = 2 * (s * dct_ops(s) + s * dct_ops(s))
    n = 8 if s >= 8 else 4
    refs = 2 * 195 * 4
    predict = MODES * hw * 12
    satd = MODES * hw * satd_ops(n)
    rd = MODES * 4 + hw + tr + hw * 7 + hw * 4 + hw * 6 + 10
    return B * (refs + predict + satd + rd)


def intra_search_work(width: int, height: int, bitdepth: int = 8):
    """(bytes, operations) of one picture's all-intra search over the
    square classes 64..8, each block wholly inside the picture."""
    sample = (bitdepth + 7) // 8
    ops = 0
    blocks = 0
    for s in (64, 32, 16, 8):
        B = (width // s) * (height // s)
        ops += class_ops(B, s)
        blocks += B
    return width * height * sample + blocks * 8, ops


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card can take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)
