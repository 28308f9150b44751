"""The all-intra slice end to end: the same clip through
uvg266_tpu.control.encoder.Encoder (JAX on the CPU) and
uvg266_tpu_torch.control.encoder.Encoder(device="cpu") (the kernels' plain
PyTorch versions) must give byte-identical access units, and the port's
oracle must decode them to the port's reconstruction.
"""
import numpy as np
import pytest
import torch

from uvg266_tpu.cfg import Config as RefConfig
from uvg266_tpu.control.encoder import Encoder as RefEncoder
from uvg266_tpu.control.encoder import FramePlanes as RefPlanes
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes
from uvg266_tpu_torch.oracle.decoder import decode_au

TOOLS = dict(qp=22, gop_len=0, intra_period=1, sao_type=3, alf_type=0,
             deblock_enable=True, rdoq_enable=False, signhide_enable=True,
             dep_quant=False, wpp=False)


def _clip(w, h, n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (xx * 0.3 + yy * 0.2 + 40 * np.sin((xx + 3 * t) / 16.0)
             + 30 * np.cos((yy - 2 * t) / 11.0)
             + 20 * ((xx // 32 + yy // 32 + t) % 2))
        y = np.clip(y + rng.integers(-6, 6, (h, w)), 0, 255).astype(np.int32)
        u = np.clip(128 + 20 * np.sin((xx[::2, ::2] + 5 * t) / 24.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255)
        v = np.clip(128 + 20 * np.cos((yy[::2, ::2] + 4 * t) / 21.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255)
        out.append((y, u.astype(np.int32), v.astype(np.int32)))
    return out


def _encode(enc, planes, clip):
    out = []
    for f in clip:
        out.extend(enc.feed(planes(*f)))
    out.extend(enc.flush())
    return out


@pytest.mark.parametrize("w,h,seed", [(128, 128, 0), (192, 128, 3)])
def test_e2e_byte_identical_to_reference(w, h, seed):
    clip = _clip(w, h, 2, seed)
    ref = _encode(RefEncoder(RefConfig(width=w, height=h, **TOOLS)),
                  RefPlanes, clip)
    enc = Encoder(Config(width=w, height=h, **TOOLS), device="cpu")
    got = _encode(enc, FramePlanes, clip)
    assert len(got) == len(ref) == 2
    for (au, rec, fs, _r, _s), (rau, rrec, _f, _rr, _rs) in zip(got, ref):
        assert au == rau
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(rec, p), getattr(rrec, p))
        dec, info = decode_au(au, enc.cfg, enc.ctrl, fs)
        assert info["headers_ok"] and info["checksum_ok"] is True
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(dec, p), getattr(rec, p))


def test_rdoq_default_byte_identical_to_reference():
    """The Config default (rdoq on) takes the sequential Python finalize,
    which needs ops.me (mv_bits_est)."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (64, 64)).astype(np.int32)
    u = rng.integers(0, 256, (32, 32)).astype(np.int32)
    kw = dict(width=64, height=64, qp=27, gop_len=0, intra_period=1)
    assert Config(**kw).rdoq_enable
    ref = _encode(RefEncoder(RefConfig(**kw)), RefPlanes, [(y, u, u.copy())])
    enc = Encoder(Config(**kw), device="cpu")
    got = _encode(enc, FramePlanes, [(y, u, u.copy())])
    assert got[0][0] == ref[0][0]
    np.testing.assert_array_equal(got[0][1].y, ref[0][1].y)
    dec, info = decode_au(got[0][0], enc.cfg, enc.ctrl, got[0][2])
    assert info["checksum_ok"] is True
    np.testing.assert_array_equal(dec.y, got[0][1].y)


# once refused: every device inter path declines inter slices above 8 bits,
# with MTS or with MIP, and the reference then runs the per-class
# search_combined (tests/test_torch_e2e_combined.py); the rough intra search
@pytest.mark.parametrize("kw", [dict(gop_len=4, input_bitdepth=10),
                                dict(intra_period=64, input_bitdepth=10),
                                dict(gop_len=4, mts=1),
                                dict(gop_len=4, mip=True),
                                dict(intra_rough=True)])
def test_formerly_gated_configs_are_accepted(kw):
    cfg = Config(width=64, height=64, **{**TOOLS, **kw})
    enc = Encoder(cfg, device="cpu")
    assert enc.slice_enc.device == torch.device("cpu")


def test_device_policy():
    cfg = Config(width=64, height=64, **TOOLS)
    assert Encoder(cfg, device="cpu").slice_enc.device == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Encoder(cfg)
