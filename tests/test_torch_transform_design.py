"""The redesigned K13 and K14 arithmetic against the plain versions, on the
CPU.

ops.transforms ``fwd_batch_sep`` / ``inv_batch_sep`` emulate
csrc/transform.cu in plain PyTorch (partial butterflies to full depth for
DCT2, matrix passes for DST7 / DCT8 and the generic instance, the
forward's kept outputs only, int16 intermediates, sums wrapped to int32);
ops.quant ``quant_batch_sep`` / ``dequant_batch_sep`` emulate
csrc/quant.cu (int16 or int32 read in place, eight elements a thread, the
sign as selects). Each must equal its plain version bit for bit, dtypes
included, at every lattice shape, the MTS pairs up to 32, the generic
shapes (a dimension of 1 or 2, 10 bits), and the int32 extremes where the
butterflies' E +- O sums wrap. The DCT2 coefficients the kernel takes as
compile-time constants (csrc/dct2_coef.cuh) are compiled with g++ and held
to ops/tr_matrices.py.
"""
import os
import subprocess

import numpy as np
import pytest
import torch

from uvg266_tpu_torch.kernels import CSRC
from uvg266_tpu_torch.ops import quant as pq
from uvg266_tpu_torch.ops import transforms as pt
from uvg266_tpu_torch.ops.tr_matrices import DCT2, DCT8, DST7, get_matrix

SIZES = (4, 8, 16, 32, 64)
MTS_SIZES = (4, 8, 16, 32)
TYPES = (DCT2, DST7, DCT8)
I32 = np.iinfo(np.int32)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small int64 products: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, w, h, bd):
    """Residuals, int16-range values, random int32, and the int32 extremes:
    all INT32_MAX, all INT32_MIN, a checkerboard of both."""
    mx = (1 << bd) - 1
    board = (np.arange(h)[:, None] + np.arange(w)[None]) % 2 == 0
    return torch.from_numpy(np.concatenate([
        rng.integers(-mx, mx + 1, (3, h, w)),
        rng.integers(-32768, 32768, (2, h, w)),
        rng.integers(I32.min, I32.max, (2, h, w), dtype=np.int64,
                     endpoint=True),
        np.full((1, h, w), I32.max), np.full((1, h, w), I32.min),
        np.where(board, I32.max, I32.min)[None]]).astype(np.int32))


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _check(w, h, th, tv, bd, rng):
    x = _inputs(rng, w, h, bd)
    c = pt.fwd_batch_plain(x, th, tv, bd)
    _same(pt.fwd_batch_sep(x, th, tv, bd), c)
    cc = torch.cat([c.to(torch.int32), x])
    _same(pt.inv_batch_sep(cc, th, tv, bd), pt.inv_batch_plain(cc, th, tv, bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("w", SIZES)
def test_dct2_sep_equals_plain(w, h, bd):
    """Every lattice shape, DCT2: the butterflies, the kept outputs (a
    64-point dimension keeps 32), int16 t and u."""
    _check(w, h, DCT2, DCT2, bd, np.random.default_rng(w * 100 + h + bd))


@pytest.mark.parametrize("h", MTS_SIZES)
@pytest.mark.parametrize("w", MTS_SIZES)
def test_mts_pairs_sep_equal_plain(w, h):
    """Every pair of DCT2, DST7 and DCT8 up to 32 points but DCT2/DCT2 (a
    32-point DST7 or DCT8 keeps 16), 8 and 10 bits: the matrix passes and
    the butterflies side by side."""
    rng = np.random.default_rng(w * 7 + h)
    for th in TYPES:
        for tv in TYPES:
            if th == tv == DCT2:
                continue
            for bd in (8, 10):
                _check(w, h, th, tv, bd, rng)


@pytest.mark.parametrize("w,h", [(1, 1), (1, 8), (8, 1), (2, 2), (2, 4),
                                 (4, 2), (1, 64), (64, 2), (2, 64), (2, 32)])
def test_generic_shapes_sep_equal_plain(w, h):
    """A dimension of 1 or 2 (the generic instance's plain products), at
    10 bits, where the reference allows it."""
    _check(w, h, DCT2, DCT2, 10, np.random.default_rng(w * 3 + h))


def test_butterfly_wraps_where_the_matrix_product_wraps():
    """At the int32 extremes the butterflies' e = v[x] + v[n-1-x] and
    d = v[x] - v[n-1-x] leave int32; in uint32 they are ring operations,
    so the outputs equal the wrapped matrix product's (and are not those of
    an exact product)."""
    x = torch.full((1, 8, 64), I32.max, dtype=torch.int32)
    x[0, :, 1::2] = I32.min
    exact = torch.from_numpy(x.numpy().astype(np.int64)
                             @ get_matrix(DCT2, 64).T.astype(np.int64))
    wrapped = pt._bfly_fwd_keep(x.long(), 64, 32)
    assert torch.equal(wrapped, pt._wrap(exact[..., :32], 32))
    assert not torch.equal(wrapped, exact[..., :32])


def test_dct2_header_equals_tr_matrices(tmp_path):
    """csrc/dct2_coef.cuh (the DCT2 coefficients K13 compiles in) built with
    g++ gives every entry of the 1..64-point matrices of tr_matrices."""
    src = tmp_path / "dct2.cpp"
    src.write_text(f'#include "{os.path.join(CSRC, "dct2_coef.cuh")}"\n'
                   "#include <cstdio>\nint main() {\n"
                   "  for (int n = 1; n <= 64; n *= 2)\n"
                   "    for (int k = 0; k < n; ++k)\n"
                   "      for (int j = 0; j < n; ++j)\n"
                   '        std::printf("%d\\n", uvg::dct2_coef(n, k, j));\n'
                   "}\n")
    exe = tmp_path / "dct2"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(src)],
                   check=True)
    got = np.array(subprocess.run([str(exe)], check=True, capture_output=True,
                                  text=True).stdout.split(), dtype=np.int64)
    want = np.concatenate([get_matrix(DCT2, n).reshape(-1)
                           for n in (1, 2, 4, 8, 16, 32, 64)])
    assert np.array_equal(got, want)


def _level_inputs(rng, w, h):
    """Coefficients as int16 and as int32 (int16 range, past it, the int32
    extremes), and both at an element offset of 1, 2 and 3."""
    c32 = np.concatenate([
        rng.integers(-32768, 32768, (3, h, w)),
        rng.integers(-300000, 300001, (2, h, w)),
        np.full((1, h, w), I32.min), np.full((1, h, w), I32.max),
        np.zeros((1, h, w))]).astype(np.int32)
    c32 = torch.from_numpy(c32)
    c16 = torch.from_numpy(rng.integers(-32768, 32768, (5, h, w))
                           .astype(np.int16))
    out = [c16, c32]
    for t in (c16, c32):
        for o in (1, 2, 3):
            flat = torch.empty(t.numel() + o, dtype=t.dtype)
            view = flat[o:].view(t.shape)
            view.copy_(t)
            out.append(view)
    return out


@pytest.mark.parametrize("w,h", [(4, 4), (8, 4), (16, 16), (64, 32),
                                 (2, 1), (1, 1)])
def test_quant_sep_equals_plain(w, h):
    """K14's arithmetic at every qp_scaled (0-63 at 10 bits), both
    roundings, on int16 and int32 inputs and views at an offset; the
    element counts of (2, 1) and (1, 1) blocks are not multiples of 8."""
    rng = np.random.default_rng(w * 11 + h)
    for x in _level_inputs(rng, w, h):
        for qp in range(64):
            for intra in (True, False):
                _same(pq.quant_batch_sep(x, qp, 10, intra),
                      pq.quant_batch_plain(x, qp, 10, intra))
            _same(pq.dequant_batch_sep(x, qp, 10),
                  pq.dequant_batch_plain(x, qp, 10))
