"""Port vs reference: K4 rd_cost (uvg266_tpu_torch.ops.rd_cost, after K3
satd67) against uvg266_tpu.ops.rd_cost.make_rd_cost_fn on the CPU.

``best`` and ``satd`` must be equal. ``rd`` is compared with rtol
(n - 1) * 2^-24 for a block of n samples: the bits estimate is a float32
sum of n bucket weights, which the reference adds one by one in XLA's
order and the port takes as per-bucket counts times the weights (four
products, three adds). (n - 1) * 2^-24 is the textbook bound on the
rounding error of a float32 sum of n positive terms, so it is how far the
reference's own bits may lie from the exact sum. A flat block shows it:
1023 zero levels of weight 0.16424 added one at a time drift by 3.3e-6
of rd at 32x32 QP37, beyond 1e-6. 8x8 and 16x16 blocks stay within
1e-6 here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvg266_tpu.control.partition import qp_to_lambda
from uvg266_tpu.ops import intra_batch as ref_ib
from uvg266_tpu.ops import rd_cost as ref_rd
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb


def _inputs(s, bd, seed):
    """Real predictions of random content, plus a block whose residual is
    the largest possible (its SSD wraps int32 at 64x64 10-bit)."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    H, W = 3 * s, 3 * s
    src = np.clip(rng.integers(-40, 40, (H, W))
                  + (np.arange(W)[None, :] * mx // W), 0, mx).astype(np.int32)
    pos = [(x, y) for y in range(0, H, s) for x in range(0, W, s)]
    g = ref_ib.grid_of_positions(pos, s, s)
    refs, blocks = ib.refs_blocks_grid(torch.from_numpy(src), s, s, g)
    preds = ib.predict67(refs, tb.device_tables(s, s, bd, "cpu"))
    preds[0] = 0
    blocks[0] = mx
    return preds, blocks


def _compare(s, bd, qp, preds, blocks):
    qps = qp + 6 * (bd - 8)
    lam = np.float32(qp_to_lambda(qp))
    ft = tb.frame_tables(qp, "cpu")
    want = jax.jit(ref_rd.make_rd_cost_fn(s, s, bd))(
        jnp.asarray(preds.numpy()), jnp.asarray(blocks.numpy()),
        np.int32(qps), lam, ft["wts"].numpy(), ft["mode_bits"].numpy())
    satds = ib.satd67(preds, blocks)
    best, cost, satd = rd.rd_cost(preds, blocks, satds, qps, float(lam),
                                  ft["wts"], ft["mode_bits"],
                                  tb.device_tables(s, s, bd, "cpu"), bd)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(satd.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(cost.numpy(), np.asarray(want[1]),
                               rtol=(s * s - 1) * 2.0 ** -24)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("s", [8, 16, 32])
def test_rd_cost(s, qp, bd):
    preds, blocks = _inputs(s, bd, seed=s + qp + bd)
    _compare(s, bd, qp, preds, blocks)


def test_rd_cost_64x64_10bit_int32_wrap():
    """The all-max residual of a 64x64 10-bit block has an SSD of
    4096 * 1023^2 > 2^32: both sides must wrap it as int32."""
    preds, blocks = _inputs(64, 10, seed=3)
    preds, blocks = preds[:2].clone(), blocks[:2].clone()
    _compare(64, 10, 22, preds, blocks)


def test_rd_cost_first_minimum_on_ties():
    """Equal SATDs: 65 angular modes share mode_bits 5.0, so the argmin
    must take the first of the tied modes."""
    preds = torch.full((3, 67, 8, 8), 100, dtype=torch.int32)
    blocks = torch.full((3, 8, 8), 100, dtype=torch.int32)
    satds = torch.zeros((3, 67), dtype=torch.int32)
    satds[1, :2] = 50                     # planar/DC worse: best is mode 2
    ft = tb.frame_tables(22, "cpu")
    best, _cost, _satd = rd.rd_cost(preds, blocks, satds, 22, 57.9,
                                    ft["wts"], ft["mode_bits"],
                                    tb.device_tables(8, 8, 8, "cpu"), 8)
    assert best.tolist() == [0, 2, 0]
