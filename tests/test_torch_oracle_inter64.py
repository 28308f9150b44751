"""The port's inter reconstruction of a CU larger than the largest TU.

VVC codes an inter CU wider or taller than the largest transform (32) as
its implicit TUs: a 64x64 CU as four 32x32 luma TUs (and four 16x16 per
chroma plane in 4:2:0), a 64x32 CU as two. control/encoder.py
reconstruct_inter_cu splits the residual the same way in encoder mode (it
sets cu.cbf and cu.coeffs per TU, keys (color, i, j) by TU column and row,
as the transform tree writes and parses them) and in decoder mode (the
oracle's), so the two reconstructions are equal. The JAX reference applies
one inverse transform to the CU's (color, 0, 0) coefficients and raises
there (64x64 against 32x32): a documented difference (ROADMAP, queue 3).
"""
import dataclasses

import numpy as np
import pytest

from uvg266_tpu.cfg import Config as JaxConfig
from uvg266_tpu.control import encoder as jax_encoder
from uvg266_tpu.control.cu import CU_INTER as JAX_CU_INTER
from uvg266_tpu.control.cu import CuInfo as JaxCuInfo
from uvg266_tpu.control.params import EncoderControl as JaxControl
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.consts import COLOR_U, COLOR_V, COLOR_Y
from uvg266_tpu_torch.control.cu import CU_INTER, CuInfo
from uvg266_tpu_torch.control.encoder import FramePlanes, reconstruct_inter_cu
from uvg266_tpu_torch.control.params import EncoderControl

FW, FH = 128, 128


def _planes(rng, bd, smooth):
    mx = (1 << bd) - 1
    yy, xx = np.mgrid[0:FH, 0:FW]
    y = (xx * 1.3 + yy * 0.7 + 40 * np.sin(xx / 7.0)) * (mx / 255) if smooth \
        else rng.integers(0, mx + 1, (FH, FW))
    y = np.clip(y + rng.integers(-8, 9, (FH, FW)), 0, mx).astype(np.int32)
    u = rng.integers(0, mx + 1, (FH // 2, FW // 2)).astype(np.int32)
    v = rng.integers(0, mx + 1, (FH // 2, FW // 2)).astype(np.int32)
    return FramePlanes(y, u, v)


def _empty():
    return FramePlanes(np.zeros((FH, FW), np.int32),
                       np.zeros((FH // 2, FW // 2), np.int32),
                       np.zeros((FH // 2, FW // 2), np.int32))


def _encode_decode(cfg, cu_args, seed, smooth=False):
    """One inter CU through reconstruct_inter_cu in encoder mode, then a
    copy of it (its motion, cbf and coefficients) in decoder mode:
    (encoder CU, encoder recon, decoder recon)."""
    rng = np.random.default_rng(seed)
    bd = cfg.input_bitdepth
    ctrl = EncoderControl(cfg)
    src, ref = _planes(rng, bd, smooth), _planes(rng, bd, smooth)
    x, y, w, h, mv = cu_args
    cu = CuInfo(x, y, w, h, type=CU_INTER, mv=(mv, (0, 0)), mv_ref=(0, 0),
                mv_dir=1, qp=cfg.qp)
    rec_e, rec_d = _empty(), _empty()
    mask = np.zeros((FH // 4, FW // 4), bool)
    reconstruct_inter_cu(cu, rec_e, mask, ctrl, cfg.qp, [ref], src)
    dec = dataclasses.replace(cu, cbf=dict(cu.cbf),
                              coeffs={k: v.copy() for k, v in
                                      cu.coeffs.items()})
    reconstruct_inter_cu(dec, rec_d, np.zeros_like(mask), ctrl, cfg.qp,
                         [ref])
    return cu, rec_e, rec_d


@pytest.mark.parametrize("w,h", [(64, 64), (64, 32), (32, 64), (32, 32),
                                 (16, 64)])
@pytest.mark.parametrize("bd", [8, 10])
def test_large_inter_cu_encoder_and_decoder_agree(w, h, bd):
    """A CU with a coded residual: per-TU keys and shapes, cbf set, and the
    decoder-mode reconstruction equal to the encoder's, in every plane."""
    cfg = Config(width=FW, height=FH, qp=22, input_bitdepth=bd,
                 rdoq_enable=False)
    cu, rec_e, rec_d = _encode_decode(cfg, (0, 64, w, h, (-21, 13)),
                                      seed=w + h + bd)
    tw, th = min(w, 32), min(h, 32)
    keys = {(c, i, j) for c in (COLOR_Y, COLOR_U, COLOR_V)
            for j in range(h // th) for i in range(w // tw)}
    assert set(cu.cbf) == keys
    assert all(cu.cbf[k] for k in keys)           # random residuals: coded
    for (c, _i, _j), q in cu.coeffs.items():
        assert q.shape == ((th, tw) if c == COLOR_Y else (th // 2, tw // 2))
    for p in ("y", "u", "v"):
        np.testing.assert_array_equal(getattr(rec_d, p), getattr(rec_e, p))
    assert rec_e.y[64:64 + h, :w].any()


@pytest.mark.parametrize("opts", [dict(rdoq_enable=True),
                                  dict(dep_quant=True, rdoq_enable=False),
                                  dict(signhide_enable=True,
                                       rdoq_enable=False)])
def test_64x64_inter_cu_quantiser_options(opts):
    """The same with RDOQ, dependent quantisation and sign hiding, on a
    smooth plane (some TUs of the 64x64 CU quantise to zero)."""
    cfg = Config(width=FW, height=FH, qp=32, **opts)
    cu, rec_e, rec_d = _encode_decode(cfg, (64, 0, 64, 64, (8, -4)), seed=3,
                                      smooth=True)
    assert any(cu.cbf.values())
    for p in ("y", "u", "v"):
        np.testing.assert_array_equal(getattr(rec_d, p), getattr(rec_e, p))


def test_reference_cannot_reconstruct_64x64_inter_cu():
    """The documented difference: the JAX reference's decoder mode applies
    one inverse transform to the coefficients of a 64x64 inter CU, coded as
    32x32 TUs, and raises."""
    cfg = Config(width=FW, height=FH, qp=22, rdoq_enable=False)
    cu, _rec_e, _rec_d = _encode_decode(cfg, (0, 0, 64, 64, (16, 16)),
                                        seed=11)
    rng = np.random.default_rng(11)
    _src, ref = _planes(rng, 8, False), _planes(rng, 8, False)
    jcfg = JaxConfig(width=FW, height=FH, qp=22, rdoq_enable=False)
    jcu = JaxCuInfo(0, 0, 64, 64, type=JAX_CU_INTER, mv=cu.mv,
                    mv_ref=(0, 0), mv_dir=1, qp=22)
    jcu.cbf = dict(cu.cbf)
    jcu.coeffs = {k: v.copy() for k, v in cu.coeffs.items()}
    jref = jax_encoder.FramePlanes(ref.y, ref.u, ref.v)
    jrec = jax_encoder.FramePlanes(*(np.zeros_like(p) for p in
                                     (ref.y, ref.u, ref.v)))
    with pytest.raises(ValueError):
        jax_encoder.reconstruct_inter_cu(
            jcu, jrec, np.zeros((FH // 4, FW // 4), bool), JaxControl(jcfg),
            22, [jref])
