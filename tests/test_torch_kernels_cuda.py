"""The CUDA kernels K1-K4 against their plain PyTorch versions on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA card: they
carry the ``cuda`` marker and skip elsewhere. On the card:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Both sides run the same integer and float32 operations in the same order,
so every output, the rd costs included, must be equal.
"""
import numpy as np
import pytest
import torch

from uvg266_tpu_torch import kernels
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("w,h,bd", [(4, 4, 8), (8, 8, 8), (16, 8, 8),
                                    (8, 16, 10), (32, 32, 8), (64, 64, 10),
                                    (64, 32, 8), (16, 64, 8)])
def test_kernels_equal_plain(card, w, h, bd):
    rng = np.random.default_rng(w * 100 + h + bd)
    mx = (1 << bd) - 1
    src = torch.from_numpy(
        rng.integers(0, mx + 1, (3 * h + 5, 4 * w + 3)).astype(np.int32))
    src = src.to(card)
    grid = (w // 2, 1, w, h, 3, 2)               # offset grid, edges clamped
    tabs = tb.device_tables(w, h, bd, "cuda")
    before = dict(kernels.LAUNCHES)
    refs, blocks = ib.refs_blocks_grid(src, w, h, grid)
    pr, pb = ib.refs_blocks_grid_plain(src, w, h, grid)
    assert torch.equal(refs, pr) and torch.equal(blocks, pb)
    preds = ib.predict67(refs, tabs)
    assert torch.equal(preds, ib.predict67_plain(refs, tabs))
    preds[0] = 0
    blocks[0] = mx
    satds = ib.satd67(preds, blocks)
    assert torch.equal(satds, ib.satd67_plain(preds, blocks))
    for qp in (22, 37):
        ft = tb.frame_tables(qp, "cuda")
        args = (preds, blocks, satds, qp + 6 * (bd - 8), 57.9, ft["wts"],
                ft["mode_bits"], tabs, bd)
        for a, b in zip(rd.rd_cost(*args), rd.rd_cost_plain(*args)):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == {
        "refs_blocks_grid": 1, "predict67": 1, "satd67": 1, "rd_cost": 2}
