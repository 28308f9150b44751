"""What the end-to-end tests of the presets and the host tools share
(tests/test_torch_e2e_presets.py, tests/test_torch_e2e_host_tools.py): a
clip, one configuration through uvg266_tpu.control.encoder.Encoder (JAX on
the CPU) and uvg266_tpu_torch.control.encoder.Encoder(device="cpu") (the
kernels' plain PyTorch versions) with the port's kernel wrappers counted,
the byte comparison and the port's oracle.

The reference's jit cache keys ("me", w, h, r) and ("rdp", w, h) leave out
the bit depth (tests/test_torch_e2e_combined.py), so it gets one cache per
bit depth: encodes in one process share compiled functions only where the
bit depth agrees.
"""
import numpy as np
import pytest
import torch

import uvg266_tpu.control.encoder as ref_encoder
from uvg266_tpu.control.encoder import Encoder as RefEncoder
from uvg266_tpu.control.encoder import FramePlanes as RefPlanes
from uvg266_tpu_torch.consts import SliceType
from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes, RefLists
from uvg266_tpu_torch.ops import (intra_batch, me, me_frame, mip,
                                  pseudo_recon, quant, rd_cost, transforms)
from uvg266_tpu_torch.oracle.decoder import decode_au

# every kernel wrapper of the port (K1-K14; K12c as its two selections)
WRAPPERS = ((intra_batch, "refs_blocks_grid"), (intra_batch, "refs_blocks"),
            (intra_batch, "predict67"), (intra_batch, "predict_modes"),
            (intra_batch, "satd67"), (rd_cost, "rd_cost"),
            (rd_cost, "rd_cost_pred"), (rd_cost, "mts_search"),
            (rd_cost, "rough_select"), (rd_cost, "rough_pick"),
            (me, "fullpel_search"), (me, "frac_search"),
            (me_frame, "frame_inter"), (me_frame, "leaf_qpel"),
            (mip, "mip_preds"), (pseudo_recon, "pseudo_recon"),
            (transforms, "fwd_batch"), (transforms, "inv_batch"),
            (quant, "quant_batch"), (quant, "dequant_batch"))
# the wrapper sets of the paths (the fused all-intra search, the host-ME
# inter path's intra screen, search_combined per class)
FUSED = {"refs_blocks_grid", "predict67", "satd67", "rd_cost"}
HOSTME = FUSED | {"pseudo_recon"}
COMBINED = {"predict67", "satd67", "rd_cost", "fullpel_search",
            "frac_search", "rd_cost_pred"}

_REF_CACHES: dict = {}


@pytest.fixture
def one_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores (the test modules use it for every test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clip(w, h, n, bitdepth=8, chroma=True, seed=5):
    """tests/test_inter_fused.py's clip (a moving pattern with noise) at
    w x h, n frames, scaled to ``bitdepth``; luma only with chroma=False."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    sc = 1 << (bitdepth - 8)
    out = []
    for t in range(n):
        y = (xx * 0.7 + yy * 0.4 + 35 * np.sin((xx + 4 * t) / 9.0)
             + 25 * np.cos((yy - 3 * t) / 7.0))
        y = np.clip(y + rng.integers(-4, 4, (h, w)), 0, 255)
        u = np.clip(128 + 15 * np.sin((xx[::2, ::2] + 2 * t) / 13.0), 0, 255)
        v = np.clip(128 + 15 * np.cos((yy[::2, ::2] + 5 * t) / 17.0), 0, 255)
        planes = (y, u, v) if chroma else (y,)
        out.append(tuple(p.astype(np.int32) * sc for p in planes)
                   + ((None, None) if not chroma else ()))
    return out


def encode(enc, planes, frames):
    out = []
    for f in frames:
        out.extend(enc.feed(planes(*f)))
    out.extend(enc.flush())
    return out


def encode_ref(cfg, frames):
    """The reference's encode of ``frames`` with ``cfg`` (its own Config),
    with the jit cache of cfg's bit depth."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_encoder, "_JIT_CACHE",
               _REF_CACHES.setdefault(cfg.input_bitdepth, {}))
    try:
        return encode(RefEncoder(cfg), RefPlanes, frames)
    finally:
        mp.undo()


def counted_calls(run):
    """run() with the port's kernel wrappers counted -> (run's result,
    {wrapper: calls})."""
    calls = {}
    mp = pytest.MonkeyPatch()
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        mp.setattr(mod, name, counted)
    try:
        return run(), calls
    finally:
        mp.undo()


def encode_port(cfg, frames):
    """The port's encode on the CPU, counting its kernel wrappers' calls
    -> (encoder, outputs, {wrapper: calls})."""
    def run():
        enc = Encoder(cfg, device="cpu")
        return enc, encode(enc, FramePlanes, frames)
    (enc, got), calls = counted_calls(run)
    return enc, got, calls


def assert_same(got, ref):
    """Byte-identical access units and recon, frame by frame."""
    assert len(got) == len(ref)
    for (au, rec, fs, _r, _s), (rau, rrec, rfs, _rr, _rs) in zip(got, ref):
        assert fs.poc == rfs.poc and fs.slicetype == rfs.slicetype
        assert au == rau, f"poc {fs.poc}"
        for p in ("y", "u", "v"):
            a, b = getattr(rec, p), getattr(rrec, p)
            assert (a is None) == (b is None), p
            if a is not None:
                np.testing.assert_array_equal(a, b)


def assert_decodes(enc, got):
    """The port's oracle decodes every AU, with its references, to the
    port's recon, every checksum right."""
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
            a, b = getattr(dec, p), getattr(rec, p)
            if b is not None:
                np.testing.assert_array_equal(a, b)
        dpb[fs.poc] = dec


def slice_types(got):
    return "".join({SliceType.I: "I", SliceType.P: "P", SliceType.B: "B"}
                   [o[2].slicetype] for o in got)
