"""chip_smoke.py phase 12's encodes at small frames with the same residues.

Phase 12 runs the reference's 1920x1080 configurations and a 3840x2160
10-bit batch on the card, held to tests/vectors/torch_ctc_digests.json.
Here the same configurations (chip_smoke.ctc_config) encode the same clip
(tools/bdrate.py synth_clip, seed 7) at frames whose sizes leave the same
remainders as those sizes do, through uvg266_tpu.control.encoder (JAX on
the CPU) and uvg266_tpu_torch (device="cpu", the kernels' plain versions):
access units and recon byte-identical, each path's launch counts.

- 128x120 as 1920x1080: 120 mod 64 = 56, mod 32 = 24, mod 16 = 8, so the
  last CTU row is partial at every class size and the screen pads the
  plane to 128 rows.
- 128x112 as 3840x2160: mod 64 = 48, mod 32 = 16, mod 16 = 0; 10-bit
  all-intra through SliceEncoder.dispatch_frames_search with three frames
  in one batch, then encode_frame(prefetch=...), as bench.py drives it.

The fixture's own checks: tools/ctc_digests.py's digest function agrees
between the packages, and the file covers every phase-12 encode frame by
frame and records how it was made.
"""
import json
import os
import sys

import pytest

from torch_e2e_common import (COMBINED, FUSED, HOSTME, assert_same,
                              counted_calls, encode_port, encode_ref,
                              one_thread, slice_types)
from uvg266_tpu_torch.control.params import EncoderControl
from uvg266_tpu_torch.control.partition import PartitionSearch
from uvg266_tpu_torch.tools import bdrate
from uvg266_tpu_torch.tools import encode as tenc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import chip_smoke as cs  # noqa: E402
import ctc_digests  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

W, H = 128, 120                 # 1920x1080's residues
UHD_W, UHD_H = 128, 112         # 3840x2160's residues
# phase-12 label -> (frames here, slice types, the wrappers its path reaches)
CASES = {
    "1080p allintra q22": (2, "II", FUSED),
    "1080p lowdelay q22": (3, "IPP", HOSTME),
    "1080p ra8 q27": (3, "IPB", HOSTME),
    "1080p default q27": (2, "IP", HOSTME | {"leaf_qpel"}),
    "1080p ld10 q27": (2, "IP", COMBINED | {"refs_blocks_grid"}),
}


def _frames(cfg, n, w, h):
    return cs.ctc_clip(w, h, n, cfg.input_bitdepth)


def _n_classes(cfg):
    """The size classes with a block inside the frame."""
    return len(cs.search_classes(PartitionSearch(EncoderControl(cfg), cfg,
                                                 qp=cfg.qp)))


@pytest.mark.parametrize("label", sorted(CASES))
def test_1080p_configuration_matches_reference(label):
    n, types, reached = CASES[label]
    cfg = cs.ctc_config(label, W, H)
    frames = _frames(cfg, n, W, H)
    ref = encode_ref(ctc_digests.jax_config(cfg), frames)
    enc, got, calls = encode_port(cfg, frames)
    assert slice_types(got) == types
    assert_same(got, ref)
    assert set(calls) == reached, calls
    n_p = types.count("P") + types.count("B")
    if "ld10" in label:
        # the I frame's fused search, then search_blocks per class and K9a,
        # K9b and K6 per inter class (16x16 and 8x8) and reference
        n_cls = _n_classes(cfg)
        assert calls["refs_blocks_grid"] == n_cls
        assert all(calls[k] == 2 * n_cls
                   for k in ("predict67", "satd67", "rd_cost")), calls
        assert all(calls[k] == 2 for k in ("fullpel_search", "frac_search",
                                           "rd_cost_pred")), calls
        return
    # K1-K4 once per class and frame (the I search, the P/B screen), K5
    # once per P/B frame, K8 once per P frame with inter leaves
    n_cls = len(enc.slice_enc._fused_entries_c)
    assert all(calls[k] == n * n_cls for k in FUSED), calls
    assert calls.get("pseudo_recon", 0) == n_p
    if "default" in label:
        assert calls["leaf_qpel"] == 1


def test_2160p_batch_matches_reference():
    """Three 10-bit all-intra frames in one dispatch_frames_search batch:
    K1-K4 once per class for the batch, the frames equal the reference's
    same batch."""
    label = "2160p ai10 q22"
    cfg = cs.ctc_config(label, UHD_W, UHD_H)
    got, calls = counted_calls(
        lambda: ctc_digests.digests("port", label, UHD_W, UHD_H))
    assert len(got) == 3
    assert got == ctc_digests.digests("jax", label, UHD_W, UHD_H)
    assert _n_classes(cfg) == 4
    assert calls == dict.fromkeys(FUSED, 4), calls


def test_reference_batch_of_one_equals_port_batch_of_three():
    """The fixture's reference encodes the 3840x2160 batch one frame a
    batch (its memory); the port's batch of three gives the same frames."""
    label = "2160p ai10 q22"
    three = ctc_digests.digests("port", label, UHD_W, UHD_H)
    assert three == ctc_digests.digests("jax", label, UHD_W, UHD_H,
                                        batch=1)


def test_fixture_digests_agree_between_packages():
    """tools/ctc_digests.py's digest function on both packages at 128x120
    (all-intra, one frame)."""
    port = ctc_digests.digests("port", "1080p allintra q22", W, H, 1)
    ref = ctc_digests.digests("jax", "1080p allintra q22", W, H, 1)
    assert port == ref and len(port) == 1
    assert set(port[0]) == {"type", "au", "au_bytes", "recon", "rec_out"}


def test_fixture_covers_phase_12():
    """An entry per phase-12 encode, one per frame, both packages equal
    (the 10-bit LD P frame apart, for the reason its entry gives), with the
    clip, seed, Config and package versions it was made with."""
    with open(os.path.join(ROOT, cs.CTC_FIXTURE)) as fh:
        fx = json.load(fh)
    assert fx["seed"] == 7 and "synth_clip" in fx["clip"]
    assert {"python", "numpy", "torch", "jax"} <= set(fx["versions"])
    assert set(fx["encodes"]) == set(cs.CTC)
    for label, (conf, qp, n, entry, w, h) in cs.CTC.items():
        e = fx["encodes"][label]
        assert (e["configuration"], e["qp"], e["frames"], e["entry"],
                e["width"], e["height"]) == (conf, qp, n, entry, w, h)
        # equal frame by frame, but where the entry says which frames
        # differ and why (the 10-bit LD P frame: K9a's float32 rounding)
        assert len(e["port"]) == n == len(e["jax"]), label
        differ = e.get("reference_differs", {}).get("frames", [])
        assert [i for i in range(n)
                if e["jax"][i] != e["port"][i]] == differ, label
        assert not differ or label == "1080p ld10 q27"
        cfg = cs.ctc_config(label)
        assert e["config"]["width"] == cfg.width
        assert e["config"]["qp"] == cfg.qp
        assert e["bitdepth"] == cfg.input_bitdepth
    for label, n in cs.CTC_CPU:
        assert n <= fx["encodes"][label]["frames"]


@pytest.mark.parametrize("conf", sorted(bdrate.CONFIGS))
def test_cli_config_is_the_clis(conf, tmp_path, monkeypatch):
    """chip_smoke.py builds the CLI's configurations with cli_config; the
    CLI's main encodes with the same Config."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(cfg, device="cuda"):
        seen["cfg"] = cfg
        raise Stop
    monkeypatch.setattr(tenc, "Encoder", capture)
    yuv = tmp_path / "in.yuv"
    bdrate.write_yuv(bdrate.synth_clip(W, H, 1), str(yuv))
    flags = bdrate.CONFIGS[conf][1] + ["-q", "27"]
    with pytest.raises(Stop):
        tenc.main(["-i", str(yuv), "--input-res", f"{W}x{H}", "-o",
                   str(tmp_path / "out.vvc"), "--device", "cpu", *flags])
    assert seen["cfg"] == tenc.cli_config(flags, W, H)


@pytest.mark.parametrize("w", (16, 8))
def test_reference_fullpel_costs_round_apart_at_10_bits(w):
    """Why the 1920x1080 10-bit LD P frame differs between the packages
    (the fixture's reference_differs): blocks of that frame against the I
    frame's recon (tests/vectors/k9a_10bit_1080p.npz, QP27, r = 16), where
    K9a's float32 cost b2 - 2 corr + r2 rounds apart. The reference sums
    corr and r2 in its float32 convolution, the port rounds exact integer
    sums once; each package's cost of its own choice lies within n * 2^-24
    (b2 + 2 corr + r2) of the exact cost, and the two choose other MVs."""
    import jax
    import numpy as np
    import torch

    from uvg266_tpu.control.partition import qp_to_lambda
    from uvg266_tpu.ops.me import make_fullpel_search_fn, make_mv_penalty
    from uvg266_tpu_torch.ops.me import fullpel_search_plain
    from uvg266_tpu_torch.ops.tables import me_penalties
    r = 16
    v = np.load(os.path.join(ROOT, "tests", "vectors", "k9a_10bit_1080p.npz"))
    win = v[f"win{w}"].astype(np.int32)
    blk = v[f"blk{w}"].astype(np.int32)
    lam = qp_to_lambda(27, False)
    pen = make_mv_penalty(r, np.sqrt(lam))
    jx, jy, jc = (np.asarray(t) for t in jax.jit(
        make_fullpel_search_fn(w, w, r))(win, blk, pen))
    tpen, _ = me_penalties(lam, r, "cpu")
    for k in range(win.shape[0]):
        # the window as a plane of its own, the block at (r, r)
        org = torch.tensor([r], dtype=torch.int32)
        px, py, pc = (t.numpy() for t in fullpel_search_plain(
            torch.from_numpy(win[k]), torch.from_numpy(blk[k][None]), org,
            org, r, tpen))
        assert (jx[k], jy[k]) != (px[0], py[0]), k
        for dx, dy, got in ((jx[k], jy[k], jc[k]), (px[0], py[0], pc[0])):
            wv = win[k, r + dy:r + dy + w, r + dx:r + dx + w].astype(np.int64)
            b = blk[k].astype(np.int64)
            b2, corr, r2 = (b * b).sum(), (b * wv).sum(), (wv * wv).sum()
            exact = float(b2 - 2 * corr + r2) + float(pen[dy + r, dx + r])
            bound = w * w * 2.0 ** -24 * float(b2 + 2 * corr + r2)
            assert abs(float(got) - exact) <= bound, (k, got, exact, bound)
