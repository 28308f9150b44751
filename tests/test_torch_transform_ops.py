"""K13 and K14 of the port against the JAX factories, on the CPU.

ops.transforms ``fwd_batch`` / ``inv_batch`` (K13) and ops.quant
``quant_batch`` / ``dequant_batch`` (K14) run their plain PyTorch versions
for CPU tensors; the reference's make_fwd_fn / make_inv_fn /
make_quant_fn / make_dequant_fn run jitted on the CPU, as
tests/test_transforms.py runs them. The same inputs, made with numpy from
a seed, go through both: tolerance 0, dtypes equal (int16 for the
transforms, int32 for the quantisers). The reference computes in int32
(x64 off) and wraps; the port must wrap where it wraps, including where the
numpy host versions saturate.
"""
import jax
import numpy as np
import pytest
import torch

from uvg266_tpu.ops import quant as jq
from uvg266_tpu.ops import transforms as jt
from uvg266_tpu_torch.ops import quant as pq
from uvg266_tpu_torch.ops import transforms as pt
from uvg266_tpu_torch.ops.tr_matrices import (DCT2, DCT8, DST7, device_matrix,
                                              get_matrix)

SIZES = (4, 8, 16, 32, 64)
MTS_SIZES = (4, 8, 16, 32)
# the MTS pairs (type_hor, type_ver) of the transform search, and a
# DCT2/DST7 mix
MTS_PAIRS = ((DST7, DST7), (DCT8, DCT8), (DST7, DCT8), (DCT8, DST7),
             (DCT2, DST7))
I32 = np.iinfo(np.int32)


def _same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert port.dtype == torch.from_numpy(ref).dtype
    assert tuple(port.shape) == ref.shape
    assert np.array_equal(port.numpy(), ref)


def _residuals(rng, w, h, bd, n=5):
    """Random residuals within +-(2^bd - 1), int16-range inputs (where the
    int16 casts wrap), the all-max block and its negative, and the int32
    extremes (a checkerboard of INT32_MAX and INT32_MIN: the redesigned
    kernel's butterfly sums wrap there)."""
    mx = (1 << bd) - 1
    board = (np.arange(h)[:, None] + np.arange(w)[None]) % 2 == 0
    return np.concatenate([
        rng.integers(-mx, mx + 1, (n, h, w)),
        rng.integers(-32767, 32768, (n, h, w)),
        np.full((1, h, w), mx), np.full((1, h, w), -mx),
        np.full((1, h, w), 32767),
        np.where(board, I32.max, I32.min)[None]]).astype(np.int32)


def _check_transforms(w, h, th, tv, bd, rng):
    """Forward of _residuals; inverse of its coefficients and of
    int16-range coefficients (one compile for both reference functions)."""
    fwd = jt.make_fwd_fn(w, h, th, tv, bd)
    inv = jt.make_inv_fn(w, h, th, tv, bd)

    def ref_fn(x, extra):
        c = fwd(x)
        return c, inv(jax.numpy.concatenate([c.astype(np.int32), extra]))

    x = _residuals(rng, w, h, bd)
    extra = rng.integers(-32768, 32768, (4, h, w), dtype=np.int32)
    c_ref, y_ref = (np.asarray(a) for a in jax.jit(ref_fn)(x, extra))
    _same(pt.fwd_batch(torch.from_numpy(x), th, tv, bd), c_ref)
    c = np.concatenate([c_ref.astype(np.int32), extra])
    _same(pt.inv_batch(torch.from_numpy(c), th, tv, bd), y_ref)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("w", SIZES)
def test_dct2_equals_reference(w, h, bd):
    _check_transforms(w, h, DCT2, DCT2, bd,
                      np.random.default_rng(w * 1000 + h * 10 + bd))


@pytest.mark.parametrize("w", MTS_SIZES)
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("pair", MTS_PAIRS, ids=lambda p: f"{p[0]}{p[1]}")
def test_mts_pairs_equal_reference(pair, bd, w):
    rng = np.random.default_rng(pair[0] * 10 + pair[1] + bd * 100 + w)
    for h in MTS_SIZES:
        _check_transforms(w, h, pair[0], pair[1], bd, rng)


def test_leading_batch_shape_and_narrow_input():
    """[..., h, w] with two leading dimensions, and an int16 input (the
    reference casts to int32 first)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-1023, 1024, (2, 3, 8, 16)).astype(np.int32)
    c_ref = np.asarray(jax.jit(jt.make_fwd_fn(16, 8, DST7, DCT2, 10))(x))
    _same(pt.fwd_batch(torch.from_numpy(x).to(torch.int16), DST7, DCT2, 10),
          c_ref)
    _same(pt.inv_batch(torch.from_numpy(c_ref), DST7, DCT2, 10),
          jax.jit(jt.make_inv_fn(16, 8, DST7, DCT2, 10))(
              c_ref.astype(np.int32)))


def _coefficients(rng, w, h, n=4):
    """int16-range values, values past int16 (where |c| * scale wraps),
    the int32 extremes and zeros."""
    return np.concatenate([
        rng.integers(-32768, 32768, (n, h, w)),
        rng.integers(-300000, 300001, (n, h, w)),
        rng.integers(I32.min, I32.max, (1, h, w), dtype=np.int64,
                     endpoint=True),
        np.full((1, h, w), I32.min), np.full((1, h, w), I32.max),
        np.zeros((1, h, w))]).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("w", SIZES)
def test_quant_dequant_equal_reference(w, h, bd):
    """Every qp_scaled the encoder gives (0-51 at 8 bits, 0-63 at 10),
    both roundings: qp_scaled is an argument of the call, so one compile
    per function serves them all."""
    rng = np.random.default_rng(w * 1000 + h * 10 + bd + 7)
    coef = _coefficients(rng, w, h)
    levels = np.concatenate([coef, rng.integers(-32768, 32768, (4, h, w),
                                                dtype=np.int32)])
    fns = (jq.make_quant_fn(w, h, bd, True), jq.make_quant_fn(w, h, bd, False),
           jq.make_dequant_fn(w, h, bd))
    ref = jax.jit(lambda c, lv, qp: (fns[0](c, qp), fns[1](c, qp),
                                     fns[2](lv, qp)))
    coef_t, levels_t = torch.from_numpy(coef), torch.from_numpy(levels)
    for qp in range(52 if bd == 8 else 64):
        q_intra, q_inter, dq = ref(coef, levels, qp)
        _same(pq.quant_batch(coef_t, qp, bd, True), q_intra)
        _same(pq.quant_batch(coef_t, qp, bd, False), q_inter)
        _same(pq.dequant_batch(levels_t, qp, bd), dq)


def test_dequant_wraps_as_reference():
    """8x4 at 10 bits, qp_scaled 63: level * (80 << 10) passes 2^31 from
    |level| >= 26215, and the reference wraps where numpy saturates."""
    q = np.array([[20000, 26214, 26215, 29127, 32767, -32768, -29127,
                   0]] * 4, dtype=np.int32)
    ref = np.asarray(jax.jit(jq.make_dequant_fn(8, 4, 10))(q, 63))
    port = pq.dequant_batch(torch.from_numpy(q), 63, 10)
    _same(port, ref)
    assert port[0, 3] == -32768 and port[0, 5] == 32767
    assert jq.dequant(q, 63, 10)[0, 3] == 32767          # numpy saturates


def test_quant_wraps_as_reference():
    """4x4 at 10 bits, qp_scaled 0: 200000 * 26214 passes 2^32; the
    reference gives 7231 where numpy saturates to 32767."""
    c = np.full((4, 4), 200000, dtype=np.int32)
    c[1] = -200000
    ref = np.asarray(jax.jit(jq.make_quant_fn(4, 4, 10))(c, 0))
    port = pq.quant_batch(torch.from_numpy(c), 0, 10)
    _same(port, ref)
    assert port[0, 0] == 7231 and port[1, 0] == -7231
    assert jq.quant(c, 0, 10)[0, 0] == 32767


@pytest.mark.parametrize("w,h,qp", [(4, 4, 0), (8, 4, 3), (8, 4, 63),
                                    (16, 32, 27)])
def test_quant_of_int32_min(w, h, qp):
    """|INT32_MIN| stays INT32_MIN in the reference: with an odd scale
    (8x4, qp_scaled % 6 == 3: 13107) the level is negative before the
    sign; with an even one it is 0."""
    c = np.full((2, h, w), I32.min, dtype=np.int32)
    c[1, 0, :2] = (I32.max, -I32.max)
    ref = jax.jit(jq.make_quant_fn(w, h, 10, False))(c, qp)
    _same(pq.quant_batch(torch.from_numpy(c), qp, 10, False), ref)


def _raises(fn):
    try:
        fn()
    except Exception as e:        # noqa: BLE001 (the type is the result)
        return type(e)
    return None


@pytest.mark.parametrize("kind,args", [
    ("fwd", (2, 4, DCT2, DCT2, 8)),          # s1 = 0: a negative shift
    ("fwd", (64, 64, DST7, DST7, 8)),        # no 64-point DST7
    ("fwd", (32, 64, DCT2, DCT8, 10)),       # no 64-point DCT8
    ("fwd", (8, 2, DST7, DST7, 10)),         # no 2-point DST7
    ("inv", (64, 64, DCT8, DCT8, 8)),
    ("inv", (64, 16, DST7, DCT2, 10)),
    ("fwd", (2, 4, DCT2, DCT2, 10)),         # works at 10 bits
    ("fwd", (4, 2, DCT2, DCT2, 8)),          # a 2-point column works
    ("inv", (2, 4, DCT2, DCT2, 8)),
])
def test_port_refuses_where_the_reference_refuses(kind, args):
    """The factories raise for some shapes when they are made; the port
    raises the same exception on the same call, plain version and wrapper,
    and computes the same where the factory works."""
    w, h, th, tv, bd = args
    make = jt.make_fwd_fn if kind == "fwd" else jt.make_inv_fn
    plain = pt.fwd_batch_plain if kind == "fwd" else pt.inv_batch_plain
    wrapper = pt.fwd_batch if kind == "fwd" else pt.inv_batch
    x = np.random.default_rng(w + h).integers(-500, 500, (3, h, w)) \
        .astype(np.int32)
    want = _raises(lambda: make(w, h, th, tv, bd))
    for fn in (plain, wrapper):
        got = _raises(lambda: fn(torch.from_numpy(x), th, tv, bd))
        assert got is want, (fn.__name__, got, want)
    if want is None:
        _same(wrapper(torch.from_numpy(x), th, tv, bd),
              jax.jit(make(w, h, th, tv, bd))(x))


@pytest.mark.parametrize("shape", [(4, 3), (6, 8), (8,)])
def test_quantisers_refuse_what_the_reference_refuses(shape):
    """A dimension that is not a power of two has no LOG2 entry in the
    factories (KeyError); a 1-D tensor has no block shape."""
    x = torch.zeros(shape, dtype=torch.int32)
    if len(shape) == 1:
        for fn in (pq.quant_batch, pq.dequant_batch):
            with pytest.raises(ValueError):
                fn(x, 22)
        return
    h, w = shape
    assert _raises(lambda: jq.make_quant_fn(w, h)) is KeyError
    assert _raises(lambda: jq.make_dequant_fn(w, h)) is KeyError
    for fn in (pq.quant_batch, pq.dequant_batch, pq.quant_batch_plain,
               pq.dequant_batch_plain):
        with pytest.raises(KeyError):
            fn(x, 22)


@pytest.mark.parametrize("tr_type,sizes", [(DCT2, (1, 2, 4, 8, 16, 32, 64)),
                                           (DST7, MTS_SIZES),
                                           (DCT8, MTS_SIZES)])
def test_device_matrix_is_the_matrix(tr_type, sizes):
    for n in sizes:
        m = device_matrix(tr_type, n, "cpu")
        assert m.dtype == torch.int8
        assert np.array_equal(m.numpy().astype(np.int32),
                              get_matrix(tr_type, n))


@pytest.mark.parametrize("w,h,bd,qp", [(64, 64, 8, 22), (32, 32, 10, 37),
                                       (16, 8, 8, 27), (8, 32, 10, 63),
                                       (4, 4, 8, 51)])
def test_round_trip_equals_reference(w, h, bd, qp):
    """The slice as a whole: residuals of smooth blocks through forward,
    quant, dequant and inverse, chained as the encoder's RD tail chains
    them, in the port and in the reference."""
    rng = np.random.default_rng(w + h + bd + qp)
    yy, xx = np.mgrid[0:h, 0:w]
    mx = (1 << bd) - 1
    blocks = np.stack([np.clip((xx * (k + 1) + yy * (3 - k)) * (mx // 64)
                               + rng.integers(-8, 9, (h, w)), 0, mx)
                       for k in range(4)]).astype(np.int32)
    resid = blocks - (1 << (bd - 1))
    c = jax.jit(jt.make_fwd_fn(w, h, bitdepth=bd))(resid)
    q = jax.jit(jq.make_quant_fn(w, h, bd))(c.astype(np.int32), qp)
    d = jax.jit(jq.make_dequant_fn(w, h, bd))(q, qp)
    r = jax.jit(jt.make_inv_fn(w, h, bitdepth=bd))(d)
    pc = pt.fwd_batch(torch.from_numpy(resid), bitdepth=bd)
    pqv = pq.quant_batch(pc, qp, bd)
    pd = pq.dequant_batch(pqv, qp, bd)
    pr = pt.inv_batch(pd, bitdepth=bd)
    for a, b in ((pc, c), (pqv, q), (pd, d), (pr, r)):
        _same(a, b)
