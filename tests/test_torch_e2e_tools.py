"""The all-intra tool paths end to end: MIP (per-class dispatch_blocks with
K10 mip_preds and K12a refs_blocks) and intra MTS (search_blocks with K11
mts_search). The same clip through uvg266_tpu.control.encoder.Encoder (JAX
on the CPU) and uvg266_tpu_torch.control.encoder.Encoder(device="cpu") (the
kernels' plain PyTorch versions) must give byte-identical access units, and
the port's oracle must decode them to the port's reconstruction.
"""
import numpy as np
import pytest

from uvg266_tpu.cfg import Config as RefConfig
from uvg266_tpu.control.encoder import Encoder as RefEncoder
from uvg266_tpu.control.encoder import FramePlanes as RefPlanes
from uvg266_tpu.control.encoder import SliceEncoder as RefSliceEncoder
from uvg266_tpu.control.params import EncoderControl as RefControl
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.control.encoder import (Encoder, FramePlanes,
                                              SliceEncoder)
from uvg266_tpu_torch.control.params import EncoderControl
from uvg266_tpu_torch.oracle.decoder import decode_au

TOOLS = dict(qp=27, gop_len=0, intra_period=1, sao_type=3, alf_type=0,
             deblock_enable=True, rdoq_enable=False, signhide_enable=True,
             dep_quant=False, wpp=False)


def _clip(w, h, n, seed, bd=8):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    sc = 1 << (bd - 8)
    out = []
    for t in range(n):
        y = (xx * 0.9 + yy * 0.4 + 40 * np.sin((xx + 3 * t) / 9.0)
             + 30 * np.cos((yy - 2 * t) / 7.0)
             + 25 * ((xx // 16 + yy // 16 + t) % 2))
        y = np.clip(y + rng.integers(-4, 4, (h, w)), 0, 255).astype(np.int32)
        u = np.clip(128 + 20 * np.sin((xx[::2, ::2] + 5 * t) / 24.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255)
        v = np.clip(128 + 20 * np.cos((yy[::2, ::2] + 4 * t) / 21.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255)
        out.append((y * sc, u.astype(np.int32) * sc, v.astype(np.int32) * sc))
    return out


def _encode(enc, planes, clip):
    out = []
    for f in clip:
        out.extend(enc.feed(planes(*f)))
    out.extend(enc.flush())
    return out


@pytest.mark.parametrize("kw", [dict(mip=True), dict(mts=1),
                                dict(mts=3, mip=True),
                                dict(mip=True, input_bitdepth=10)],
                         ids=["mip", "mts1", "mts3-mip", "mip-10bit"])
def test_e2e_tools_byte_identical_to_reference(kw):
    w, h, n = 64, 64, 2
    bd = kw.get("input_bitdepth", 8)
    clip = _clip(w, h, n, seed=len(kw) + bd, bd=bd)
    opts = {**TOOLS, **kw}
    ref = _encode(RefEncoder(RefConfig(width=w, height=h, **opts)), RefPlanes,
                  clip)
    enc = Encoder(Config(width=w, height=h, **opts), device="cpu")
    got = _encode(enc, FramePlanes, clip)
    assert len(got) == len(ref) == n
    for (au, rec, fs, _r, _s), (rau, rrec, _f, _rr, _rs) in zip(got, ref):
        assert au == rau
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(rec, p), getattr(rrec, p))
        dec, info = decode_au(au, enc.cfg, enc.ctrl, fs)
        assert info["headers_ok"] and info["checksum_ok"] is True
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(dec, p), getattr(rec, p))


def _slice_encoders(**kw):
    opts = {**TOOLS, **kw}
    rcfg = RefConfig(width=96, height=64, **opts)
    cfg = Config(width=96, height=64, **opts)
    return (RefSliceEncoder(rcfg, RefControl(rcfg)),
            SliceEncoder(cfg, EncoderControl(cfg), device="cpu"))


@pytest.mark.parametrize("w,h", [(16, 16), (8, 8), (32, 16)])
def test_dispatch_blocks_off_grid_matches_reference(w, h):
    """One dispatch_blocks call with MIP on at positions that form no grid:
    the position form of the intra combo (K12a -> K2 -> K3 -> K4) and the
    MIP combo (K10, K12a, K3, K4), fetched through _fetch_all."""
    from uvg266_tpu_torch.control.encoder import _fetch_all
    src_y = _clip(96, 64, 1, seed=w + h)[0][0]
    positions = [(0, 0), (96 - w, 0), (5, 3), (96 - w, 64 - h), (w + 1, h + 2),
                 (0, 64 - h), (40, 17)]
    ref_se, se = _slice_encoders(mip=True)
    want_d, want_c = ref_se.dispatch_blocks(src_y, w, h, positions)()
    rsv = se.dispatch_blocks(src_y, w, h, positions)
    assert len(rsv.dev) == 4
    got_d, got_c = rsv()
    assert got_d == want_d
    np.testing.assert_allclose(got_c, np.asarray(want_c),
                               rtol=(w * h - 1) * 2.0 ** -24)
    pre = _fetch_all([rsv, rsv])
    assert len(pre) == 2 and rsv(pre=pre[1])[0] == want_d
    assert any(d.get("mip") for d in got_d)


@pytest.mark.parametrize("w,h", [(8, 8), (16, 8), (16, 16)])
def test_search_blocks_with_mts_matches_reference(w, h):
    """search_blocks with mts=1: K2 -> K3 -> K4, the best prediction gathered
    on the device, then K11; descs (mode and tr_idx) equal, costs within
    K4's tolerance. At 8x8 and 16x8 some blocks of this clip take a
    transform pair other than DCT2."""
    src_y = _clip(96, 64, 1, seed=9)[0][0]
    positions = [(x, y) for y in range(0, 64, h) for x in range(0, 96, w)]
    ref_se, se = _slice_encoders(mts=1)
    want_d, want_c = ref_se.search_blocks(src_y, w, h, positions)
    got_d, got_c = se.search_blocks(src_y, w, h, positions)
    assert got_d == want_d
    assert any(d["tr_idx"] for d in got_d) or (w, h) == (16, 16)
    np.testing.assert_allclose(got_c, np.asarray(want_c),
                               rtol=(w * h - 1) * 2.0 ** -24)
