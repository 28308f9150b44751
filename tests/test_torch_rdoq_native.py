"""The native library's C++ rdoq against ops/rdoq.py's numpy body.

``rc_rdoq_levels`` (through ``native.rdoq_levels_native``) must give
``rdoq_levels_numpy``'s int16 levels block for block: every (w, h) the
encoder quantises with it (sides 4 to 32), QP 0-51 at 8 and 10 bits, intra
and inter slices, three lambdas, on seeded Laplacian blocks, all-zero
blocks, one large coefficient, levels at and past 32767 and levels past
the rate table's end (which the C++ leaves to numpy). The intra CU recon
that takes it (``reconstruct_intra_cu_native`` with an rdoq lambda: rdoq,
then sign hiding, inside ``transform_quant_recon``'s C++ twin) must equal
the Python ``reconstruct_intra_cu`` CU for CU.
"""
import numpy as np
import pytest

import uvg266_tpu_torch.native as native
import uvg266_tpu_torch.ops.rdoq as rq
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.control.cu import CU_INTRA, CuInfo
from uvg266_tpu_torch.control.encoder import FramePlanes, reconstruct_intra_cu
from uvg266_tpu_torch.control.params import EncoderControl
from uvg266_tpu_torch.control.partition import qp_to_lambda

SIDES = (4, 8, 16, 32)
LAMBDA_SCALES = (0.25, 1.0, 4.0)


@pytest.fixture(scope="module")
def lib():
    return native.get_lib()


def _blocks(rng, w, h, bitdepth, qp_scaled):
    """The inputs of one (shape, QP): name -> int32 h x w coefficients."""
    lap = [np.clip(np.rint(rng.laplace(0.0, s, (h, w))
                           / (1.0 + np.add.outer(np.arange(h), np.arange(w))
                              * rng.uniform(0.0, 0.5))),
                   -32768, 32767) for s in (3.0, 40.0, 600.0)]
    one = np.zeros((h, w))
    one[rng.integers(h), rng.integers(w)] = rng.choice([-1, 1]) * 30000
    out = {f"laplace{i}": b for i, b in enumerate(lap)}
    out["zero"] = np.zeros((h, w))
    out["one_large"] = one
    # the coefficient whose floor level is 32767, and one past it
    _s, q_bits, _a = rq.quant_params(qp_scaled, rq.LOG2[w], rq.LOG2[h],
                                     bitdepth, False)
    sat = -(-(32767 << q_bits) // _s)
    edge = lap[1].copy()
    edge[0, 0], edge[-1, -1] = sat, -(sat + 2 * (1 << q_bits) // _s + 1)
    out["level_32767"] = edge
    # a level past the rate table: numpy decides the block
    far = lap[0].copy()
    far[h // 2, w // 2] = -(((native._RDOQ_RATES + 5) << q_bits) // _s + 1)
    out["past_table"] = far
    # int64: past the table the coefficient may leave int32 (numpy alone)
    return {k: v.astype(np.int64 if k == "past_table" else np.int32)
            for k, v in out.items()}


@pytest.mark.parametrize("w", SIDES)
@pytest.mark.parametrize("h", SIDES)
def test_native_rdoq_equals_numpy(lib, w, h):
    rng = np.random.default_rng([w, h, 21])
    n_native = n_past = 0
    for qp in range(52):
        for bitdepth in (8, 10):
            qp_scaled = qp + 6 * (bitdepth - 8)
            for j, scale in enumerate(LAMBDA_SCALES):
                lam = qp_to_lambda(qp) * scale
                intra = (qp + j) % 2 == 0
                for name, coef in _blocks(rng, w, h, bitdepth,
                                          qp_scaled).items():
                    want = rq.rdoq_levels_numpy(coef, qp_scaled, bitdepth,
                                                lam, intra)
                    got = native.rdoq_levels_native(coef, qp_scaled,
                                                    bitdepth, lam)
                    where = (name, qp, bitdepth, lam, intra)
                    if got is None:
                        # only blocks with a level past the table's end
                        assert name in ("past_table", "level_32767"), where
                        n_past += 1
                    else:
                        assert got.dtype == np.int16, where
                        np.testing.assert_array_equal(got, want,
                                                      err_msg=str(where))
                        n_native += 1
                    # the entry the encoder calls gives numpy's levels
                    np.testing.assert_array_equal(
                        rq.rdoq_levels(coef, qp_scaled, bitdepth, lam, intra),
                        want, err_msg=str(where))
                    if name == "level_32767" and got is not None:
                        assert np.abs(got).max() == 32767, where
    assert n_past >= 52 * 2 * 3      # every past_table block fell back
    assert n_native >= 52 * 2 * 3 * 5


@pytest.mark.parametrize("shape", [(64, 64), (2, 8), (8, 2), (1, 16),
                                   (16, 1), (2, 2)])
def test_shapes_without_scan_table_left_to_numpy(lib, shape):
    """The C++ has scan tables for sides 4-32, every TU the encoder's
    recon passes it (its TUs stop at 32x32): other blocks (a 64x64 block,
    the ISP sub-partitions, 2x2 chroma) go to numpy, whose levels the
    entry returns."""
    h, w = shape
    coef = np.random.default_rng([w, h]).laplace(0, 40, (h, w)).astype(
        np.int32)
    lam = qp_to_lambda(30)
    assert native.rdoq_levels_native(coef, 30, 8, lam) is None
    np.testing.assert_array_equal(rq.rdoq_levels(coef, 30, 8, lam),
                                  rq.rdoq_levels_numpy(coef, 30, 8, lam))


def test_rdoq_built_without_fused_multiply_add(lib):
    """The products round before the sums, as numpy's do: a * b - c with
    a = b = 1 + 2^-30 and c = 1 + 2^-29 is 0 unless fused."""
    a = 1.0 + 2.0 ** -30
    assert native._LIB_GIL.rc_rdoq_contract_probe(a, a, 1.0 + 2.0 ** -29) \
        == 0.0


# CUs of a 128x64 frame in coding order: a 64x64 CU, then a CTU of
# 32x32, 32x16, 16x16, 8x8, 8x16 and 16x32 CUs
_CUS = ([(0, 0, 64, 64), (64, 0, 32, 32), (96, 0, 32, 16), (96, 16, 32, 16),
         (64, 32, 16, 16)]
        + [(80 + dx, 32 + dy, 8, 8) for dy in (0, 8) for dx in (0, 8)]
        + [(64, 48, 8, 16), (72, 48, 8, 16), (80, 48, 16, 16),
           (96, 32, 16, 32), (112, 32, 16, 32)])


@pytest.mark.parametrize("bitdepth,qp,signhide", [
    (8, 22, True), (8, 27, True), (8, 37, True), (8, 32, False),
    (10, 27, True), (10, 12, True)])
def test_native_intra_cu_with_rdoq_equals_python(lib, bitdepth, qp,
                                                 signhide):
    """rdoq, then sign hiding where the levels sum to 2 or more, in the
    C++ recon, CU for CU against reconstruct_intra_cu with the same
    lambda."""
    rng = np.random.default_rng([bitdepth, qp])
    W, H = 128, 64
    yy, xx = np.mgrid[0:H, 0:W]
    sc = 1 << (bitdepth - 8)
    y = np.clip(128 + 50 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
                + rng.laplace(0, 12, (H, W)), 0, 255)
    u = np.clip(128 + rng.laplace(0, 9, (H // 2, W // 2)), 0, 255)
    v = np.clip(128 + 30 * np.sin(yy[::2, ::2] / 3.0)
                + rng.laplace(0, 5, (H // 2, W // 2)), 0, 255)
    src = FramePlanes(*(np.ascontiguousarray(p.astype(np.int32) * sc)
                        for p in (y, u, v)))
    ctrl = EncoderControl(Config(width=W, height=H, input_bitdepth=bitdepth,
                                 rdoq_enable=True, signhide_enable=signhide))
    lam = qp_to_lambda(qp)
    planes = [FramePlanes(*(np.zeros_like(p) for p in (src.y, src.u, src.v)))
              for _ in range(2)]
    masks = [np.zeros((H // 4, W // 4), dtype=bool) for _ in range(2)]
    n_coded = 0
    for x, yy0, w, h in _CUS:
        mode = int(rng.integers(67))
        cus = [CuInfo(x, yy0, w, h, type=CU_INTRA, intra_mode=mode,
                      intra_mode_chroma=mode, tr_idx=0, qp=qp)
               for _ in range(2)]
        assert native.reconstruct_intra_cu_native(
            cus[0], planes[0], masks[0], ctrl.luma_qp_scaled(qp),
            ctrl.chroma_qp_scaled(qp), bitdepth, signhide, ctrl.cfg.wpp, src,
            lam)
        reconstruct_intra_cu(cus[1], planes[1], masks[1], ctrl, qp, src,
                             signhide=signhide, rdoq_lam=lam)
        where = (x, yy0, w, h, mode)
        assert cus[0].cbf == cus[1].cbf, where
        assert cus[0].coeffs.keys() == cus[1].coeffs.keys(), where
        for k, c in cus[1].coeffs.items():
            np.testing.assert_array_equal(cus[0].coeffs[k], c,
                                          err_msg=str((where, k)))
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(planes[0], p),
                                          getattr(planes[1], p),
                                          err_msg=str((where, p)))
        np.testing.assert_array_equal(masks[0], masks[1])
        n_coded += len(cus[1].coeffs)
    assert n_coded >= len(_CUS)


def test_native_intra_cu_declines_where_numpy_decides(lib):
    """At 14 bits and QP 0 a 32x32 TU can reach levels past the rate
    table: the C++ recon writes nothing and says so, and the caller takes
    the Python recon; without rdoq it reconstructs."""
    src = FramePlanes(*(np.full(s, 100, dtype=np.int32)
                        for s in ((64, 64), (32, 32), (32, 32))))
    rec = FramePlanes(*(np.zeros_like(p) for p in (src.y, src.u, src.v)))
    mask = np.zeros((16, 16), dtype=bool)
    cu = CuInfo(0, 0, 32, 32, type=CU_INTRA, intra_mode=1,
                intra_mode_chroma=1, tr_idx=0, qp=0)
    assert not native.reconstruct_intra_cu_native(
        cu, rec, mask, 0, 0, 14, True, False, src, 1.0)
    assert not mask.any() and not rec.y.any() and not cu.cbf
    assert native.reconstruct_intra_cu_native(
        cu, rec, mask, 0, 0, 14, True, False, src, 0.0)
