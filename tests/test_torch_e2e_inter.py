"""The inter slices end to end: low-delay and random-access clips through
uvg266_tpu.control.encoder.Encoder (JAX on the CPU) and
uvg266_tpu_torch.control.encoder.Encoder(device="cpu") (the kernels' plain
PyTorch versions) must give byte-identical access units and recon, and the
port's oracle must decode them, with their references, to the port's
reconstruction.

The clip and the configurations are tests/test_inter_fused.py's (128x80,
5 frames, QP30), plus bench.py's low-delay tools. Each path is checked to
reach its kernels: the host-ME path K5 (pseudo_recon) and, with rdoq on
(the Config default, no native inter finalize), K8 (leaf_qpel); the
all-device path (ime_algorithm=2) K7 (frame_inter), K6 (rd_cost_pred) and
K8.
"""
import numpy as np
import pytest

from uvg266_tpu.cfg import Config as RefConfig
from uvg266_tpu.control.encoder import Encoder as RefEncoder
from uvg266_tpu.control.encoder import FramePlanes as RefPlanes
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.consts import SliceType
from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes, RefLists
from uvg266_tpu_torch.ops import me_frame, pseudo_recon, rd_cost
from uvg266_tpu_torch.oracle.decoder import decode_au

W, H, N = 128, 80, 5

LD = dict(qp=30, gop_len=4, gop_lowdelay=True, gop_lp_d=3, gop_lp_t=1)
RA = dict(qp=30, gop_len=8, gop_lowdelay=False)
# bench.py:77-80, the low-delay benchmark's tools (rdoq off: native finalize)
LD_BENCH = dict(qp=27, gop_len=4, gop_lowdelay=True, intra_period=64,
                sao_type=0, alf_type=0, deblock_enable=True,
                rdoq_enable=False, signhide_enable=False, dep_quant=False,
                wpp=False)

# config -> the kernel wrappers its P/B frames must reach
CASES = {
    "ld_hostme": (LD, {"pseudo_recon", "leaf_qpel"}),
    "ra_hostme": (RA, {"pseudo_recon", "leaf_qpel"}),
    "ld_bench_hostme": (LD_BENCH, {"pseudo_recon"}),
    "ld_full": ({**LD, "ime_algorithm": 2},
                {"frame_inter", "rd_cost_pred", "leaf_qpel"}),
    "ra_full": ({**RA, "ime_algorithm": 2},
                {"frame_inter", "rd_cost_pred", "leaf_qpel"}),
}
_WRAPPERS = ((pseudo_recon, "pseudo_recon"), (me_frame, "frame_inter"),
             (me_frame, "leaf_qpel"), (rd_cost, "rd_cost_pred"))


def _clip(seed=5):
    """test_inter_fused.py's clip."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(N):
        y = (xx * 0.7 + yy * 0.4 + 35 * np.sin((xx + 4 * t) / 9.0)
             + 25 * np.cos((yy - 3 * t) / 7.0))
        y = np.clip(y + rng.integers(-4, 4, (H, W)), 0, 255)
        u = np.clip(128 + 15 * np.sin((xx[::2, ::2] + 2 * t) / 13.0), 0, 255)
        v = np.clip(128 + 15 * np.cos((yy[::2, ::2] + 5 * t) / 17.0), 0, 255)
        out.append((y.astype(np.int32), u.astype(np.int32),
                    v.astype(np.int32)))
    return out


def _encode(enc, planes, clip):
    out = []
    for f in clip:
        out.extend(enc.feed(planes(*f)))
    out.extend(enc.flush())
    return out


def _encode_port(kw, clip):
    """The port's encode on the CPU, counting the kernel wrappers' calls."""
    calls = {}
    mp = pytest.MonkeyPatch()
    for mod, name in _WRAPPERS:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        mp.setattr(mod, name, counted)
    try:
        enc = Encoder(Config(width=W, height=H, **kw), device="cpu")
        got = _encode(enc, FramePlanes, clip)
    finally:
        mp.undo()
    return enc, got, calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_inter_slices_match_reference(case):
    """One test per configuration, so that each encode runs once however
    the tests are spread over workers."""
    kw, kernels_reached = CASES[case]
    clip = _clip()
    ref = _encode(RefEncoder(RefConfig(width=W, height=H, **kw)), RefPlanes,
                  clip)
    enc, got, calls = _encode_port(kw, clip)

    # byte-identical access units and recon
    assert len(got) == len(ref) == N
    for (au, rec, fs, _r, _s), (rau, rrec, rfs, _rr, _rs) in zip(got, ref):
        assert fs.poc == rfs.poc and fs.slicetype == rfs.slicetype
        assert au == rau, f"poc {fs.poc}"
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(rec, p), getattr(rrec, p))

    # the path's P/B frames went through its kernels
    assert any(fs.slicetype != SliceType.I for (_a, _r, fs, _l, _s) in got)
    assert set(calls) == kernels_reached, calls

    # the port's oracle decodes every AU with its references
    dpb = {}
    for (au, rec, fs, _rl, _src) in got:
        pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
        pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
        if fs.slicetype == SliceType.I:
            dpb.clear()
        orl = RefLists(l0=[dpb[q] for q in pocs0], l1=[dpb[q] for q in pocs1],
                       pocs0=pocs0, pocs1=pocs1)
        dec, info = decode_au(au, enc.cfg, enc.ctrl, fs, refs=orl)
        assert info["checksum_ok"], f"poc {fs.poc} hash"
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(dec, p), getattr(rec, p))
        dpb[fs.poc] = dec
