"""The redesigned K12b and K5, on the CPU.

- K12b predict_modes on K2's descriptor route (ops/tables.py
  predict_modes_desc, as csrc/predict_modes.cu computes it: each mode
  clamped to [2, 66], only the leading samples of each reference section
  that the angular modes reach (mode_reach; a read past them raises), each
  slot from its mode's descriptor). Equal to predict_modes_plain at every
  (w, h) in {4..64}^2, 8 and 10 bits, on the references of
  tests/test_torch_predict_desc.py, for refine-like lists, random lists in
  [2, 66] with duplicates and lists with modes outside [2, 66] (-1, 0, 1,
  67, 80), which clamp. With in-range modes it also equals the JAX
  package's make_predict_modes_fn under JAX_PLATFORMS=cpu at the four
  squares of the all-intra classes and two BT/TT shapes; JAX clamps an
  out-of-range index to [0, 66], not [2, 66], so the clamped lists are held
  against the plain version only.
- K5 pseudo_recon on partial butterflies (ops/pseudo_recon.py
  pseudo_recon_sep, as csrc/pseudo_recon.cu computes it: the DC from the
  integer sum's quotient and remainder, the 16-point DCT2 passes as even
  and odd half sums, no int16 wrap between the forward passes, quant
  rounding 171). Equal to pseudo_recon_plain, to the JAX package's
  make_pseudo_recon_fn and to the numpy pseudo_recon_plane on planes of
  16x16, 48x32, 144x80 and 832x480, at 8 and 10 bits, qp_scaled 0, 22, 37
  and the largest, on random, all-max and checkerboard planes.

Tolerance 0 throughout: every step is integer arithmetic.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_predict_desc import _refs
from uvg266_tpu.ops import intra_batch as ref_ib
from uvg266_tpu.ops import pseudo_recon as ref_pr
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import pseudo_recon as pr
from uvg266_tpu_torch.ops import tables as tb

# every (w, h) the kernels are built for: the partition lattice's shapes
# and the rest of {4..64}^2
SHAPES = [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small int64 products: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lists(rng, B):
    """Mode lists [B, 4]: refine-like (a - 1, a + 1 around two even modes,
    clipped to [2, 66], duplicates kept), random in [2, 66] with repeats,
    and with modes outside [2, 66]."""
    a = rng.integers(1, 34, (B, 2)) * 2
    refine = np.clip(np.stack([a[:, 0] - 1, a[:, 0] + 1, a[:, 1] - 1,
                               a[:, 1] + 1], 1), 2, 66)
    refine[0] = (2, 3, 65, 66)
    refine[1] = (3, 3, 3, 3)
    rand = rng.integers(2, 67, (B, 4))
    rand[0] = (2, 66, 2, 66)
    rand[1] = (34, 34, 18, 50)
    wide = rng.integers(-3, 81, (B, 4))
    wide[0] = (-1, 0, 1, 67)
    wide[1] = (80, 80, 66, 2)
    return {"refine": refine, "random": rand, "clamped": wide}


@pytest.mark.parametrize("bd", (8, 10))
@pytest.mark.parametrize("w,h", SHAPES)
def test_predict_modes_desc_equals_plain(w, h, bd):
    refs = _refs(bd, 100 * w + h + bd)
    tabs = tb.device_tables(w, h, bd, "cpu")
    for tag, ml in _lists(np.random.default_rng(w * h + bd),
                          refs.shape[0]).items():
        modes = torch.from_numpy(ml.astype(np.int32))
        got = tb.predict_modes_desc(refs, modes, w, h, bd)
        want = ib.predict_modes_plain(refs, modes, tabs)
        assert got.dtype == want.dtype and torch.equal(got, want), tag


@pytest.mark.parametrize("bd", (8, 10))
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (64, 64), (32, 8), (16, 64)])
def test_predict_modes_desc_equals_reference(w, h, bd):
    """In-range lists only: the reference clamps to [0, 66]."""
    refs = _refs(bd, 7 * w + h + bd)
    fn = jax.jit(ref_ib.make_predict_modes_fn(
        ref_ib.build_mode_tables(w, h, bd, False)))
    lists = _lists(np.random.default_rng(w + 3 * h + bd), refs.shape[0])
    for tag in ("refine", "random"):
        ml = lists[tag].astype(np.int32)
        want = np.asarray(fn(refs.numpy(), ml))
        got = tb.predict_modes_desc(refs, torch.from_numpy(ml), w, h, bd)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=tag)


@pytest.mark.parametrize("w,h", SHAPES)
def test_reach_is_what_the_modes_read(w, h):
    """mode_reach is the prefix of each section the angular modes read; a
    negative slope's taps stay inside its main reference's ww + 2
    samples; the prefix holds far fewer than the 780 samples."""
    reads = tb.mode_reads(w, h)
    reach = tb.mode_reach(w, h)
    assert not reads[:2].any()
    for k, n in enumerate(reach):
        sec = reads[2:, k * ib.REF_LEN:(k + 1) * ib.REF_LEN].any(axis=0)
        assert n == (np.nonzero(sec)[0][-1] + 1 if sec.any() else 0)
        assert not sec[n:].any()
    assert sum(reach) <= 4 * (2 * max(w, h) + 2)
    desc, _ext = tb.mode_descriptors(w, h)
    for d in desc[2:]:
        if d[tb.D_SD] < 0:
            assert d[tb.D_EXTN] - d[tb.D_BASE] <= d[tb.D_MAINN]


def _planes(rng, H, W, bd):
    mx = (1 << bd) - 1
    return {"rand": rng.integers(0, mx + 1, (H, W)),
            "max": np.full((H, W), mx),
            "check": ((np.arange(H)[:, None] + np.arange(W)[None]) % 2) * mx}


@pytest.mark.parametrize("bd", (8, 10))
@pytest.mark.parametrize("H,W", [(16, 16), (32, 48), (80, 144), (480, 832)])
def test_pseudo_recon_sep_equals_plain_reference_numpy(H, W, bd):
    fn = jax.jit(ref_pr.make_pseudo_recon_fn(H, W, bd))
    for tag, a in _planes(np.random.default_rng(H + W + bd), H, W,
                          bd).items():
        a = a.astype(np.int32)
        src = torch.from_numpy(a)
        for qps in (0, 22, 37, 51 + 6 * (bd - 8)):
            what = f"{tag} qp{qps}"
            got = pr.pseudo_recon_sep(src, qps, bd)
            assert got.dtype == torch.int32, what
            assert torch.equal(got, pr.pseudo_recon_plain(src, qps, bd)), what
            np.testing.assert_array_equal(got.numpy(), np.asarray(fn(a, qps)),
                                          err_msg=what)
            np.testing.assert_array_equal(
                got.numpy(), pr.pseudo_recon_plane(a, qps, bd), err_msg=what)
