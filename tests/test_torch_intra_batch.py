"""Port vs reference: K1 refs_blocks_grid, K2 predict67, K3 satd67 and the
static tables (uvg266_tpu_torch.ops.intra_batch / ops.tables against
uvg266_tpu.ops.intra_batch, run on the CPU under JAX_PLATFORMS=cpu).

Inputs are made from a numpy seed and handed to both. On the CPU the
port's wrappers compute their plain PyTorch versions; every integer output
must equal the JAX function's exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvg266_tpu.control import encoder as ref_encoder
from uvg266_tpu.ops import fast_cost_tables as ref_fct
from uvg266_tpu.ops import intra_batch as ref_ib
from uvg266_tpu.ops import quant as ref_quant
from uvg266_tpu.ops.tr_matrices import DCT2, get_matrix
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import tables as tb

# (w, h, bitdepth) of the exact comparisons
SHAPES = [(8, 8, 8), (16, 16, 8), (16, 8, 8), (8, 16, 8), (4, 4, 8),
          (16, 16, 10)]


def _plane(w, h, bd, seed, kind="rand"):
    """A source plane holding a few blocks of w x h, partly past the
    block grid so the edge clamping is exercised."""
    rng = np.random.default_rng(seed)
    H, W = 3 * h + 5, 4 * w + 3
    mx = (1 << bd) - 1
    if kind == "edge":
        yy, xx = np.mgrid[0:H, 0:W]
        return (((yy // 4 + xx // 4) % 2) * mx).astype(np.int32)
    return rng.integers(0, mx + 1, (H, W)).astype(np.int32)


def _grid(src, w, h, offset=False):
    H, W = src.shape
    if offset:        # a TT-middle-like grid: offset origin, stride 2w
        pos = [(x + w // 2, y) for y in range(0, H - h + 1, h)
               for x in range(0, W - 2 * w + 1, 2 * w)]
    else:
        pos = [(x, y) for y in range(0, H - h + 1, h)
               for x in range(0, W - w + 1, w)]
    g = ref_ib.grid_of_positions(pos, w, h)
    assert g is not None
    return g


def _ref_refs_blocks(src, w, h, g):
    r, b = jax.jit(ref_ib.make_refs_blocks_grid_fn(w, h, g))(jnp.asarray(src))
    return np.asarray(r), np.asarray(b)


@pytest.mark.parametrize("w,h,bd", SHAPES)
@pytest.mark.parametrize("kind", ["rand", "edge", "offset"])
def test_refs_blocks_grid(w, h, bd, kind):
    src = _plane(w, h, bd, seed=w * 7 + h, kind="edge" if kind == "edge"
                 else "rand")
    g = _grid(src, w, h, offset=kind == "offset")
    want_r, want_b = _ref_refs_blocks(src, w, h, g)
    got_r, got_b = ib.refs_blocks_grid(torch.from_numpy(src), w, h, g)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_refs_blocks_grid_frames_batched():
    """[F, H, W] input: frames outermost, as the reference concatenates."""
    w = h = 8
    srcs = np.stack([_plane(w, h, 8, seed=s) for s in range(3)])
    g = _grid(srcs[0], w, h)
    got_r, got_b = ib.refs_blocks_grid(torch.from_numpy(srcs), w, h, g)
    want = [_ref_refs_blocks(s, w, h, g) for s in srcs]
    np.testing.assert_array_equal(got_r.numpy(),
                                  np.concatenate([r for r, _b in want]))
    np.testing.assert_array_equal(got_b.numpy(),
                                  np.concatenate([b for _r, b in want]))


def _refs_for(w, h, bd, seed):
    src = _plane(w, h, bd, seed)
    r, _b = _ref_refs_blocks(src, w, h, _grid(src, w, h))
    rng = np.random.default_rng(seed + 1)
    # plus references that no plane produces: uniform and extreme values
    rand = rng.integers(0, 1 << bd, r.shape).astype(np.int32)
    ext = np.where(rng.random(r.shape) < 0.5, 0, (1 << bd) - 1)
    return np.concatenate([r, rand, ext.astype(np.int32)])


@pytest.mark.parametrize("w,h,bd", SHAPES)
def test_predict67(w, h, bd):
    refs = _refs_for(w, h, bd, seed=w + 3 * h + bd)
    fn, A = ref_ib.make_predict_matmul_fn(
        ref_ib.build_mode_tables(w, h, bd, False))
    want = np.asarray(jax.jit(fn)(jnp.asarray(refs), A))
    got = ib.predict67(torch.from_numpy(refs),
                       tb.device_tables(w, h, bd, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_predict67_32x32_gather_twin():
    """At 32x32 the matmul form's A is 214 MB: compare with its bit-exact
    gather twin make_predict_fn instead."""
    refs = _refs_for(32, 32, 8, seed=5)
    want = np.asarray(jax.jit(ref_ib.make_predict_fn(
        ref_ib.build_mode_tables(32, 32, 8, False)))(jnp.asarray(refs)))
    got = ib.predict67(torch.from_numpy(refs),
                       tb.device_tables(32, 32, 8, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h,bd", SHAPES)
def test_satd67(w, h, bd):
    rng = np.random.default_rng(w * h + bd)
    mx = (1 << bd) - 1
    B = 6
    preds = rng.integers(0, mx + 1, (B, 67, h, w)).astype(np.int32)
    src = rng.integers(0, mx + 1, (B, h, w)).astype(np.int32)
    preds[0] = 0                          # largest residuals
    src[0] = mx
    want = np.asarray(jax.jit(ref_ib.make_satd67_fn(w, h))(
        jnp.asarray(preds), jnp.asarray(src)))
    got = ib.satd67(torch.from_numpy(preds), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h,bd", SHAPES + [(32, 32, 8), (64, 64, 10)])
def test_class_tables_equal_reference(w, h, bd):
    mine = tb.class_tables(w, h, bd)
    ref = ref_ib.build_mode_tables(w, h, bd, False)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert mine[k].dtype == v.dtype, k
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
        else:
            assert mine[k] == v, k
    np.testing.assert_array_equal(mine["mat_w"], get_matrix(DCT2, w))
    np.testing.assert_array_equal(mine["mat_h"], get_matrix(DCT2, h))


def test_frame_tables_equal_reference():
    np.testing.assert_array_equal(tb.FAST_COEFF_WTS, ref_fct.FAST_COEFF_WTS)
    np.testing.assert_array_equal(tb.QUANT_SCALES, ref_quant.QUANT_SCALES)
    np.testing.assert_array_equal(tb.INV_QUANT_SCALES,
                                  ref_quant.INV_QUANT_SCALES)
    np.testing.assert_array_equal(tb.MODE_BITS, ref_encoder._MODE_BITS)
    assert tb.MODE_BITS.dtype == ref_encoder._MODE_BITS.dtype
    ft = tb.frame_tables(22, "cpu")
    np.testing.assert_array_equal(
        ft["wts"].numpy(), ref_fct.FAST_COEFF_WTS[22].astype(np.float32))
    np.testing.assert_array_equal(ft["mode_bits"].numpy(),
                                  ref_encoder._MODE_BITS)


@pytest.mark.parametrize("w,h", [(8, 8), (64, 64)])
def test_tables_to_torch_round_trip(w, h):
    t = tb.class_tables(w, h, 10)
    dev = tb.tables_to_torch(t, "cpu")
    for k, v in t.items():
        if isinstance(v, np.ndarray):
            assert dev[k].is_contiguous()
            np.testing.assert_array_equal(dev[k].numpy(), v, err_msg=k)
            if k in tb.NARROW:
                assert dev[k].numpy().dtype == tb.NARROW[k], k
        else:
            assert dev[k] == v
    with pytest.raises(ValueError):
        tb.tables_to_torch({"K": np.array([1 << 15])}, "cpu")
