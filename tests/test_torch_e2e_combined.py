"""The per-class inter search and the rough intra search end to end.

Inter slices above 8 bits, with intra MTS or with MIP, make every device
inter path of the encoder decline: the frame is searched one size class at
a time by search_combined (intra candidates through search_blocks on the
pseudo-recon plane, then K9a fullpel_search, K9b frac_search and K6 per
unique reference, and for B slices a bipred candidate). ``intra_rough``
sends the all-intra per-class dispatch through K12a and the K12c chain.

Each configuration encodes the same clip through
uvg266_tpu.control.encoder.Encoder (JAX on the CPU) and
uvg266_tpu_torch.control.encoder.Encoder(device="cpu") (the kernels' plain
PyTorch versions): the access units and the reconstruction must be
byte-identical, the path must reach its kernels' wrappers, and the port's
oracle must decode every access unit, with its references, to the
reconstruction. The clip and the low-delay configuration are those of
tests/test_e2e_inter.py (lp_config, moving_clip), at 64x64.

The reference's encode runs with a jit cache of its own: its cache keys
("me", w, h, r) and ("rdp", w, h) (uvg266_tpu/control/encoder.py
search_inter_blocks, search_combined) leave out the bit depth, so after an
8-bit encode in the same process a 10-bit one would reuse the 8-bit
interpolation and quantiser. The port takes the bit depth in every call.
"""
import numpy as np
import pytest

import uvg266_tpu.control.encoder as ref_encoder
from uvg266_tpu.cfg import Config as RefConfig
from uvg266_tpu.control.encoder import Encoder as RefEncoder
from uvg266_tpu.control.encoder import FramePlanes as RefPlanes
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.consts import SliceType
from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes, RefLists
from uvg266_tpu_torch.ops import inter, intra_batch, me, rd_cost
from uvg266_tpu_torch.oracle.decoder import decode_au

W = H = 64
# tests/test_e2e_inter.py lp_config
LP = dict(qp=30, gop_len=4, gop_lowdelay=True, intra_period=64, ref_frames=1,
          sao_type=0, alf_type=0, deblock_enable=True, rdoq_enable=False,
          signhide_enable=True, dep_quant=False, wpp=False, tmvp_enable=False)
INTRA = dict(qp=27, gop_len=0, intra_period=1, sao_type=3, alf_type=0,
             deblock_enable=True, rdoq_enable=False, signhide_enable=True,
             dep_quant=False, wpp=False)

_INTER = {"fullpel_search", "frac_search", "rd_cost_pred"}
_ROUGH = {"refs_blocks", "predict67", "satd67", "rough_select",
          "predict_modes", "rough_pick", "rd_cost_pred"}
# case -> (Config options, frames, the wrappers its frames reach)
CASES = {
    "ld-10bit": ({**LP, "input_bitdepth": 10}, 2, _INTER),
    "ld-mip-mts1": ({**LP, "mip": True, "mts": 1}, 2, _INTER),
    "gpb-b-mts3-mip": ({**LP, "ref_frames": 2, "bipred": 1, "mts": 3,
                        "mip": True}, 2, _INTER | {"mc_luma_bi"}),
    "rough-8bit": ({**INTRA, "intra_rough": True}, 2, _ROUGH),
    "rough-10bit": ({**INTRA, "intra_rough": True, "input_bitdepth": 10}, 2,
                    _ROUGH),
}
_WRAPPERS = ((me, "fullpel_search"), (me, "frac_search"),
             (rd_cost, "rd_cost_pred"), (rd_cost, "rough_select"),
             (rd_cost, "rough_pick"), (intra_batch, "refs_blocks"),
             (intra_batch, "predict67"), (intra_batch, "satd67"),
             (intra_batch, "predict_modes"), (inter, "mc_luma_bi"))


def _clip(n, bd):
    """tests/test_e2e_inter.py moving_clip (seed 0): a textured plane in
    global motion of (4, 2) px a frame, scaled to ``bd`` bits."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    base_y = np.clip(120 + 60 * np.sin(xx / 23.0) + 40 * np.cos(yy / 17.0)
                     + rng.integers(-20, 20, (H, W)), 0, 255)
    base_u = 128 + 30 * np.sin(xx[::2, ::2] / 19.0) \
        + 10 * np.cos(yy[::2, ::2] / 11.0)
    base_v = 128 + 30 * np.cos(yy[::2, ::2] / 13.0) \
        + 10 * np.sin(xx[::2, ::2] / 9.0)
    sc = 1 << (bd - 8)
    frames = []
    for t in range(n):
        y = np.roll(np.roll(base_y, 4 * t, axis=1), 2 * t, axis=0)
        u = np.clip(np.roll(np.roll(base_u, 2 * t, axis=1), t, axis=0),
                    0, 255)
        v = np.clip(np.roll(np.roll(base_v, 2 * t, axis=1), t, axis=0),
                    0, 255)
        frames.append(tuple(p.astype(np.int32) * sc for p in (y, u, v)))
    return frames


def _encode(enc, planes, clip):
    out = []
    for f in clip:
        out.extend(enc.feed(planes(*f)))
    out.extend(enc.flush())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_combined_paths_match_reference(case, monkeypatch):
    """One test per configuration, so that each encode runs once however
    the tests are spread over workers."""
    kw, n, reached = CASES[case]
    clip = _clip(n, kw.get("input_bitdepth", 8))
    monkeypatch.setattr(ref_encoder, "_JIT_CACHE", {})
    ref = _encode(RefEncoder(RefConfig(width=W, height=H, **kw)), RefPlanes,
                  clip)

    calls = {}
    for mod, name in _WRAPPERS:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    enc = Encoder(Config(width=W, height=H, **kw), device="cpu")
    got = _encode(enc, FramePlanes, clip)
    monkeypatch.undo()

    assert len(got) == len(ref) == n
    for (au, rec, fs, _r, _s), (rau, rrec, rfs, _rr, _rs) in zip(got, ref):
        assert fs.poc == rfs.poc and fs.slicetype == rfs.slicetype
        assert au == rau, f"poc {fs.poc}"
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(rec, p), getattr(rrec, p))
    assert reached <= set(calls), (reached, calls)
    if kw["gop_len"]:
        assert any(o[2].slicetype != SliceType.I for o in got)
    if "mc_luma_bi" in reached:
        assert any(o[2].slicetype == SliceType.B for o in got)

    dpb = {}
    for (au, rec, fs, _rl, _src) in got:
        pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
        pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
        if fs.slicetype == SliceType.I:
            dpb.clear()
        orl = RefLists(l0=[dpb[q] for q in pocs0], l1=[dpb[q] for q in pocs1],
                       pocs0=pocs0, pocs1=pocs1)
        dec, info = decode_au(au, enc.cfg, enc.ctrl, fs, refs=orl)
        assert info["headers_ok"] and info["checksum_ok"] is True, \
            f"poc {fs.poc}"
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(dec, p), getattr(rec, p))
        dpb[fs.poc] = dec
