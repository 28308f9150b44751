"""The redesigned K6 and K1/K12a, on the CPU.

- K4/K6's shared RD tail (ops/rd_cost.py rd_tail_sep, as csrc/rd_tail.cuh
  computes it): the DCT2 passes on even/odd partial butterflies, the
  bucket counts of levels 0, 1, 2 and >= 3, the SSD summed in uint32.
  Equal to the plain tail, and rd_cost_pred_sep / rd_cost_plain on it
  equal to rd_cost_pred_plain / rd_cost_plain (the rd cost bit for bit,
  the mode decision), at every (w, h) in {4..64}^2, 8 and 10 bits, QP 0,
  22 and 37, quant rounding 85 (inter) and 171 (intra), on random, smooth
  and all-max residuals. The all-max residual (zero prediction, source at
  the maximum) reconstructs closely, so its SSD stays small; a source at
  the 12-bit maximum against a zero prediction at 10 bits wraps the
  forward passes' int16 and clips the reconstruction at 1023, so the
  64x64 SSD (errors near 3072 a sample) wraps through int32.
- K1 refs_blocks_grid and K12a refs_blocks (ops/intra_batch.py, plain
  versions on the CPU) against the JAX package's make_refs_blocks_grid_fn
  and make_refs_blocks_fn under JAX_PLATFORMS=cpu at the BT/TT child
  shapes, on planes narrower than the 3w+3 top line and shorter than the
  3h+3 left line, with grids whose last blocks leave the plane, with a
  separate reference plane, and at origins off the 4-sample grid
  (tests/test_torch_intra_batch.py holds the square and 16x8/8x16 shapes).

Tolerance 0 throughout: the integer steps are exact, and the float32 costs
are the same operations in the same order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvg266_tpu.ops import intra_batch as ref_ib
from uvg266_tpu_torch.control.partition import qp_to_lambda
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import rd_cost as rc
from uvg266_tpu_torch.ops import tables as tb
from uvg266_tpu_torch.ops.tr_matrices import DCT2, device_matrix

SIZES = [4, 8, 16, 32, 64]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small int64 products: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# the BT/TT child shapes of the lattice
LATTICE_SHAPES = [(32, 8), (8, 32), (64, 16), (16, 64), (4, 16), (16, 4)]


def _residual_cases(rng, w, h, bd, B=3):
    """(pred, src) int32 [B, h, w]: random, smooth (a ramp and a noisy
    shifted copy) and all-max (zero prediction, source at the maximum)."""
    mx = (1 << bd) - 1
    rand = (rng.integers(0, mx + 1, (B, h, w)),
            rng.integers(0, mx + 1, (B, h, w)))
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (xx * 7 + yy * 5)[None] + rng.integers(0, mx // 2, (B, 1, 1))
    smooth = (np.clip(ramp, 0, mx),
              np.clip(ramp + rng.integers(-3, 4, (B, h, w)) + 9, 0, mx))
    full = (np.zeros((B, h, w)), np.full((B, h, w), mx))
    return {tag: tuple(torch.from_numpy(a.astype(np.int32)) for a in pair)
            for tag, pair in (("rand", rand), ("smooth", smooth),
                              ("max", full))}


def _same(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


def _dct2_tables(w, h):
    """The two entries of device_tables(w, h, bd) that K4 and K6 read (the
    mode tables, which they do not read, take seconds to build)."""
    return {"mat_w": device_matrix(DCT2, w, "cpu"),
            "mat_h": device_matrix(DCT2, h, "cpu")}


def _check_tail(pred, src, w, h, bd, qp, intra):
    """rd_tail_sep against _rd_tail_plain, K6's and K4's costs on it."""
    qps = qp + 6 * (bd - 8)
    lam = float(np.float32(qp_to_lambda(qp, intra)))
    ft = tb.frame_tables(qp, "cpu")
    tabs = _dct2_tables(w, h)
    c = rc.quant_consts(w, h, bd, qps, intra)
    args = (pred.long(), src.long(), c, w, h, bd, ft["wts"], tabs["mat_w"],
            tabs["mat_h"])
    for name, a, b in zip(("bits", "ssd", "level"), rc.rd_tail_sep(*args),
                          rc._rd_tail_plain(*args)):
        _same(a, b, name)
    extra = torch.linspace(0.0, 9.5, pred.shape[0], dtype=torch.float32)
    k6 = (pred, src, qps, lam, ft["wts"], extra, tabs, bd, intra)
    _same(rc.rd_cost_pred_sep(*k6), rc.rd_cost_pred_plain(*k6), "K6 rd")
    # K4 over three candidates: the prediction, a copy moved by one and
    # the source itself (each may win the argmin)
    preds = torch.stack([pred, pred.roll(1, -1), src], dim=1)
    satds = torch.stack([(p - src).abs().sum(dim=(-2, -1)).to(torch.int32)
                         for p in preds.unbind(1)], dim=1)
    mode_bits = torch.tensor([1.0, 2.5, 7.0], dtype=torch.float32)
    k4 = (preds, src, satds, qps, lam, ft["wts"], mode_bits, tabs, bd)
    for name, a, b in zip(("best", "rd", "satd"),
                          rc.rd_cost_plain(*k4, tail=rc.rd_tail_sep),
                          rc.rd_cost_plain(*k4)):
        _same(a, b, "K4 " + name)


@pytest.mark.parametrize("w", SIZES)
@pytest.mark.parametrize("h", SIZES)
def test_rd_tail_sep_equals_plain(w, h):
    rng = np.random.default_rng(w * 100 + h)
    for bd in (8, 10):
        for tag, (pred, src) in _residual_cases(rng, w, h, bd).items():
            for qp in (0, 22, 37):
                for intra in (False, True):
                    _check_tail(pred, src, w, h, bd, qp, intra)


def test_rd_tail_sep_ssd_wraps_int32():
    """A 12-bit-range source against a zero prediction at 10 bits: the
    reconstruction clips at 1023, and the 64x64 SSD (errors near 3072 a
    sample) leaves int32: read as int32 it is negative. Both tails wrap
    it the same way."""
    pred = torch.zeros((2, 64, 64), dtype=torch.int32)
    src = torch.full((2, 64, 64), 4095, dtype=torch.int32)
    src[1, ::2] = 0
    c = rc.quant_consts(64, 64, 10, 34, False)
    tabs = _dct2_tables(64, 64)
    wts = tb.frame_tables(22, "cpu")["wts"]
    _bits, ssd, _lv = rc.rd_tail_sep(pred.long(), src.long(), c, 64, 64, 10,
                                     wts, tabs["mat_w"], tabs["mat_h"])
    assert ssd[0].item() < 0
    for qp in (0, 22, 37):
        for intra in (False, True):
            _check_tail(pred, src, 64, 64, 10, qp, intra)


# --- K1 / K12a against the JAX package --------------------------------------

def _planes(w, h, bd, seed):
    """Planes narrower than the 3w+3 top line and shorter than the 3h+3
    left line (the lines leave the plane and repeat its last sample), with
    W % 4 != 0 for one of them: random and a 4x4 checkerboard of 0 and the
    maximum."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    H, W = 2 * h + 3, 2 * w + 6 + (seed % 2)
    yy, xx = np.mgrid[0:H, 0:W]
    return [rng.integers(0, mx + 1, (H, W)).astype(np.int32),
            (((yy // 4 + xx // 4) % 2) * mx).astype(np.int32)]


@pytest.mark.parametrize("w,h", LATTICE_SHAPES)
@pytest.mark.parametrize("bd", [8, 10])
def test_refs_blocks_grid_bt_tt_edges(w, h, bd):
    """K1 at the BT/TT shapes: an aligned grid whose last row and column
    of blocks leave the plane (clamped), a TT-middle-like grid off the
    4-sample grid, and a separate reference plane."""
    for k, src in enumerate(_planes(w, h, bd, seed=w * 10 + h + bd)):
        H, W = src.shape
        grids = [(0, 0, w, h, -(-W // w), -(-H // h)),
                 (w // 2 + 1, 1, 2 * w, h, max(1, (W - w) // (2 * w)), 2)]
        other = np.ascontiguousarray(src[::-1, ::-1])
        for g in grids:
            fn = jax.jit(ref_ib.make_refs_blocks_grid_fn(w, h, g))
            for refsrc in (None, other):
                args = (jnp.asarray(src),) + (
                    () if refsrc is None else (jnp.asarray(refsrc),))
                want_r, want_b = fn(*args)
                got_r, got_b = ib.refs_blocks_grid(
                    torch.from_numpy(src), w, h, g,
                    None if refsrc is None else torch.from_numpy(refsrc))
                np.testing.assert_array_equal(got_r.numpy(),
                                              np.asarray(want_r), (k, g))
                np.testing.assert_array_equal(got_b.numpy(),
                                              np.asarray(want_b), (k, g))


@pytest.mark.parametrize("w,h", LATTICE_SHAPES)
def test_refs_blocks_bt_tt_edges(w, h):
    """K12a at the BT/TT shapes: origins at the plane's four corners, where
    the top and left lines leave it, and off the 4-sample grid."""
    fn = jax.jit(ref_ib.make_refs_blocks_fn(w, h))
    for bd in (8, 10):
        for src in _planes(w, h, bd, seed=w + 10 * h + bd):
            H, W = src.shape
            xs = np.array([0, W - w, 0, W - w, 1, 3, w + 2, W - w - 1],
                          dtype=np.int32)
            ys = np.array([0, 0, H - h, H - h, 2, h + 1, 1, H - h - 1],
                          dtype=np.int32)
            want_r, want_b = fn(jnp.asarray(src), jnp.asarray(xs),
                                jnp.asarray(ys))
            got_r, got_b = ib.refs_blocks(torch.from_numpy(src), xs, ys, w, h)
            np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
            np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
