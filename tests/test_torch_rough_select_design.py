"""The redesigned K12c selection stages, on the CPU.

csrc/rough_refine.cu runs each stage as a warp per block: lane l holds the
costs of slots l and l + 32 (stage 1: the angular costs j = 2 + l and
34 + l; stage 2: the 39 costs, stage-1 slots first), keeps the first
minimum of its two, and five __shfl_xor_sync steps (16, 8, 4, 2, 1) leave
every lane with the first minimum of the key (cost, index); stage 1 raises
c[i1] by 1e30 in its lane and reduces again, stage 2 copies the winner
four samples at a time. ops/rd_cost.py rough_select_sep and rough_pick_sep
emulate that lane layout and shuffle tree step by step (and raise if the
lanes disagree). Held here:

- against rough_select_plain and rough_pick_plain on chip_smoke.py's
  crafted ties (rough_stage_cases: all SATDs equal, the minimum at each
  slot, i1 and i2 tied, refine slots tied with stage-1 slots and with each
  other, refine lists at 2 and 66, random SATDs), with the real and flat
  mode bits, at B = 1, 37 and 6240, stage 2 at the (w, h) of the card
  test; and on seeded random SATDs at QP 22 and 37, lambda 57.9;
- the chain with the _sep stages (rough_refine_sep) against the JAX
  package's make_rough_refine_fn under JAX_PLATFORMS=cpu at 8x8 and 16x16
  with 8 bits and 32x16 with 10 bits, as tests/test_torch_rough_ops.py
  holds the plain chain.

Tolerance 0 for every selection output: each is an integer or the same
float32 operations in the same order. The chain's best_mode and satd_best
equal the reference's; its rd goes through K6, whose bits sum is an
order-free form of the reference's float32 sum (ops/rd_cost.py), so it
agrees within (n - 1) * 2^-24 of rd for n samples, as in
tests/test_torch_rough_ops.py, and equals the plain chain's exactly.
"""
import jax
import numpy as np
import pytest
import torch

from chip_smoke import rough_stage_cases
from test_torch_rough_ops import _plane
from uvg266_tpu.ops.fast_cost_tables import FAST_COEFF_WTS
from uvg266_tpu.ops.intra_batch import make_refs_blocks_fn
from uvg266_tpu.ops.rd_cost import make_rough_refine_fn
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb

LAM = 57.9
M1 = tb.rough_modes("cpu")


def _numbered(B, h, w):
    """Predictions p1 [B, 35, h, w] and p2 [B, 4, h, w] whose samples are
    all different, so that a wrong gather shows."""
    p1 = torch.arange(B * 35 * h * w, dtype=torch.int32).view(B, 35, h, w)
    p2 = -1 - torch.arange(B * 4 * h * w, dtype=torch.int32).view(B, 4, h, w)
    return p1, p2


def _check(s1, s2, refine, mb, p1, p2):
    got = rd.rough_select_sep(s1, LAM, mb, M1)
    want = rd.rough_select_plain(s1, LAM, mb, M1)
    assert got.dtype == want.dtype and torch.equal(got, want)
    pk = (s1, s2, got if refine is None else refine, LAM, mb, M1, p1, p2)
    for a, b in zip(rd.rough_pick_sep(*pk), rd.rough_pick_plain(*pk)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 37, 6240])
def test_stages_equal_plain_on_ties(B):
    p1, p2 = _numbered(B, 8, 8)
    bits = (tb.frame_tables(22, "cpu")["mode_bits"], torch.ones(67))
    for _tag, s1, s2, refine in rough_stage_cases(B, seed=B):
        for mb in bits:
            _check(torch.from_numpy(s1), torch.from_numpy(s2),
                   None if refine is None else torch.from_numpy(refine), mb,
                   p1, p2)


@pytest.mark.parametrize("w,h", [(4, 4), (16, 16), (32, 16), (64, 64)])
def test_pick_copy_at_each_shape(w, h):
    """Stage 2's copy at the card test's other (w, h), on the ties."""
    p1, p2 = _numbered(37, h, w)
    for _tag, s1, s2, refine in rough_stage_cases(37, seed=w * h):
        _check(torch.from_numpy(s1), torch.from_numpy(s2),
               None if refine is None else torch.from_numpy(refine),
               torch.ones(67), p1, p2)


@pytest.mark.parametrize("qp", [22, 37])
def test_stages_equal_plain_on_random_satds(qp):
    rng = np.random.default_rng(qp)
    mb = tb.frame_tables(qp, "cpu")["mode_bits"]
    p1, p2 = _numbered(500, 8, 8)
    for hi in (8, 300, 1 << 16):
        s1 = torch.from_numpy(rng.integers(0, hi, (500, 35)).astype(np.int32))
        s2 = torch.from_numpy(rng.integers(0, hi, (500, 4)).astype(np.int32))
        _check(s1, s2, None, mb, p1, p2)


def test_sep_lanes_agree():
    """Every lane ends the shuffle tree with the same key: a butterfly of a
    lexicographic minimum, which the kernels' stage 1 reads from lane 0."""
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.integers(0, 3, (64, 39)).astype(np.float32))
    lc, li = rd._lane_min(c)
    cc, ii = rd._warp_argmin(lc, li)
    assert torch.equal(cc, cc[:, :1].expand(-1, 32))
    assert torch.equal(ii, torch.argmin(c, dim=1)[:, None].expand(-1, 32))


@pytest.mark.parametrize("w,h,bd", [(8, 8, 8), (16, 16, 8), (32, 16, 10)])
def test_sep_chain_matches_reference(w, h, bd):
    src = _plane(bd, seed=w * h + bd)
    H, W = src.shape
    xs, ys = np.meshgrid(np.arange(0, W - w + 1, w),
                         np.arange(0, H - h + 1, h))
    xs = xs.reshape(-1).astype(np.int32)
    ys = ys.reshape(-1).astype(np.int32)
    refs, blocks = jax.jit(make_refs_blocks_fn(w, h))(src, xs, ys)
    refs, blocks = np.array(refs), np.array(blocks)
    dt = tb.device_tables(w, h, bd, "cpu")
    fn = jax.jit(make_rough_refine_fn(w, h, bd))
    for qp in (22, 37):
        qps = qp + 6 * (bd - 8)
        ft = tb.frame_tables(qp, "cpu")
        want = [np.asarray(a) for a in fn(refs, blocks, np.int32(qps),
                                          np.float32(LAM), FAST_COEFF_WTS[qp],
                                          tb.MODE_BITS)]
        args = (torch.from_numpy(refs), torch.from_numpy(blocks), qps, LAM,
                ft["wts"], ft["mode_bits"], dt, bd, M1)
        got = [a.numpy() for a in rd.rough_refine_sep(*args)]
        np.testing.assert_array_equal(got[0], want[0])      # best_mode
        np.testing.assert_array_equal(got[2], want[2])      # satd_best
        np.testing.assert_allclose(got[1], want[1],
                                   rtol=(w * h - 1) * 2.0 ** -24)
        # and every output, rd included, equal to the plain chain's
        for a, b in zip(got, rd.rough_refine_plain(*args)):
            np.testing.assert_array_equal(a, b.numpy())
