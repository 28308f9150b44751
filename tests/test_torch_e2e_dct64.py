"""The host C++ paths that cost 64x64 blocks, end to end: low-delay clips
with ``host_intra_screen`` (native/inter.cpp fi_host_screen) and with
``pu_depth_inter=(0, 3)`` (fi_me_frame's rd_cost_pred on 64x64 inter
leaves, under the default host ME) through the JAX reference's Encoder and
the port's Encoder(device="cpu"). Each must reach a 64x64 class of its
native call.

The reference's native library reads its 64-point DCT2 from past the end of
its table (it holds sizes 4 to 32), so its 64x64 costs are undefined and its
process can die with SIGSEGV; the port's table holds the 64-point matrix
(tests/test_torch_native_dct64.py holds those costs to K6's plain version).
On this clip 64x64 candidates decide the P slices: from the first P slice on
the reference's bytes are undefined, a documented difference (ROADMAP,
queue 3). The test holds what is defined: the I slice, which no 64x64 host
cost reaches, is byte-identical to the reference's, and in both cases every
access unit of the port decodes through the port's oracle, with its
references, to the port's reconstruction. With ``pu_depth_inter=(0, 3)``
that takes 64x64 inter CUs with a coded residual, which the port's
reconstruct_inter_cu codes and reconstructs as four 32x32 TUs (the
reference's raises there: ROADMAP, queue 3).

The reference encodes in a child process, so that its fault cannot take the
test process down. A child that dies by a signal is run again, up to three
times: that is the reference's fault and says nothing about the port.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from uvg266_tpu_torch import native
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.consts import SliceType
from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes, RefLists
from uvg266_tpu_torch.oracle.decoder import decode_au

W, H, N = 128, 128, 5
LD = dict(qp=30, gop_len=4, gop_lowdelay=True, gop_lp_d=3, gop_lp_t=1)
# config, the native entry that costs 64x64 blocks
CASES = {
    "host_intra_screen": ({**LD, "host_intra_screen": True},
                          "host_screen_native"),
    "pu_depth_inter_0_3": ({**LD, "pu_depth_inter": (0, 3)},
                           "me_frame_native"),
}

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)


def _clip(seed=5):
    """tests/test_torch_e2e_inter.py's clip at W x H."""
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


# the reference's encode, run by a child process: argv = config kwargs as
# JSON, the output path
_REF = """
import json, pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
from test_torch_e2e_dct64 import W, H, _clip
from uvg266_tpu.cfg import Config
from uvg266_tpu.control.encoder import Encoder, FramePlanes
kw = {k: tuple(v) if isinstance(v, list) else v
      for k, v in json.loads(sys.argv[1]).items()}
enc = Encoder(Config(width=W, height=H, **kw))
got = []
for f in _clip():
    got.extend(enc.feed(FramePlanes(*f)))
got.extend(enc.flush())
with open(sys.argv[2], "wb") as fh:
    pickle.dump([(au, rec.y, rec.u, rec.v, fs.poc, int(fs.slicetype))
                 for (au, rec, fs, _r, _s) in got], fh)
"""


def _reference(kw):
    """The JAX reference's encode in a child process: [(au, y, u, v, poc,
    slicetype)]."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join((_ROOT, _TESTS)))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ref.pkl")
        for _attempt in range(3):
            p = subprocess.run([sys.executable, "-c", _REF, json.dumps(kw),
                                out], cwd=_ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=600)
            if p.returncode >= 0:
                break
        assert p.returncode == 0, p.stderr[-2000:]
        with open(out, "rb") as fh:
            return pickle.load(fh)


@pytest.mark.parametrize("case", sorted(CASES))
def test_64x64_host_paths_against_reference(case):
    kw, entry = CASES[case]
    ref = _reference(kw)

    widths = []
    fn = getattr(native, entry)

    def recorded(*a, **k):
        descs = a[-1] if entry == "host_screen_native" else a[8]
        widths.extend(int(d[0]) for d in descs)
        return fn(*a, **k)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, entry, recorded)
    try:
        enc = Encoder(Config(width=W, height=H, **kw), device="cpu")
        got = []
        for f in _clip():
            got.extend(enc.feed(FramePlanes(*f)))
        got.extend(enc.flush())
    finally:
        mp.undo()

    assert 64 in widths, widths
    assert len(got) == len(ref) == N
    for (_au, _rec, fs, _r, _s), (_rau, _ry, _ru, _rv, rpoc, rst) in zip(
            got, ref):
        assert fs.poc == rpoc and int(fs.slicetype) == rst
    # the I slice: no 64x64 host cost reaches it
    (au, rec, fs, _r, _s), (rau, ry, ru, rv, _p, _t) = got[0], ref[0]
    assert fs.slicetype == SliceType.I and au == rau
    for p, rp in (("y", ry), ("u", ru), ("v", rv)):
        np.testing.assert_array_equal(getattr(rec, p), rp)
    # every access unit decodes, with its references, to the port's recon
    dpb = {}
    for (au, rec, fs, _rl, _src) in got:
        pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
        pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
        orl = RefLists(l0=[dpb[q] for q in pocs0], l1=[dpb[q] for q in pocs1],
                       pocs0=pocs0, pocs1=pocs1)
        dec, info = decode_au(au, enc.cfg, enc.ctrl, fs, refs=orl)
        assert info["checksum_ok"], f"poc {fs.poc} hash"
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(dec, p), getattr(rec, p))
        dpb[fs.poc] = dec
