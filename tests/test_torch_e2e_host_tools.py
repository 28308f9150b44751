"""The host tools that no preset turns on, the sizes off the 16-sample
grid, and the frames under 64 samples, end to end.

Each configuration encodes tests/test_inter_fused.py's clip (3 frames)
through uvg266_tpu.control.encoder.Encoder (JAX on the CPU) and
uvg266_tpu_torch.control.encoder.Encoder(device="cpu") (the kernels' plain
PyTorch versions): the access units and the recon must be byte-identical,
the path must reach its kernels' wrappers, and the port's oracle must
decode every access unit, with its references, to the port's recon. The
options not named keep the Config defaults (low delay GOP 4, rdoq on,
WPP on).

Below 64 samples in a dimension (72x40, 40x72) the 64x64 class of the
partition lattice has no block inside the frame. The reference then hands
the empty class to build_refs_grid, whose empty position arrays are
float64, and raises IndexError; the port drops such a class
before any host work or launch (control/partition.py, its costs stay INF)
and encodes. Those cases run on the port alone, and one test shows the
reference raising: a documented difference (ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

from torch_e2e_common import (COMBINED, FUSED, HOSTME, WRAPPERS,
                              assert_decodes, assert_same, clip, encode_port,
                              encode_ref, one_thread, slice_types)
from uvg266_tpu.cfg import Config as RefConfig
from uvg266_tpu_torch.cfg import Config, make_config
from uvg266_tpu_torch.consts import ChromaFormat
from uvg266_tpu_torch.ops import (intra_batch, me, me_frame, mip,
                                  pseudo_recon, quant, rd_cost, transforms)

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

N = 3
AI = dict(gop_len=0, intra_period=1)
RA = dict(gop_len=8, gop_lowdelay=False)
# the wrappers of the host-ME path with rdoq on (K8 refines the inter
# leaves), of the all-device dense search (ime_algorithm=2) and of the
# all-intra search with MTS (search_blocks, K11 up to 32x32; no MIP
# candidates there, as in the reference)
LD = HOSTME | {"leaf_qpel"}
DENSE = FUSED | {"frame_inter", "rd_cost_pred", "leaf_qpel"}
INTRA_MTS = {"predict67", "satd67", "rd_cost", "mts_search"}

# case -> (width, height, Config options, slice types, wrappers reached)
CASES = {
    "alf2-intra": (128, 80, {**AI, "alf_type": 2}, "III", FUSED),
    "alf1-ld": (128, 80, {"alf_type": 1}, "IPP", LD),
    "tiles2x2-intra": (128, 80, {**AI, "tiles_width_count": 2,
                                 "tiles_height_count": 2}, "III", FUSED),
    "tiles2x2-ld": (128, 80, {"tiles_width_count": 2,
                              "tiles_height_count": 2}, "IPP", LD),
    "slices2": (128, 80, {"slices": 2}, "IPP", LD),
    "lmcs-intra": (128, 80, {**AI, "lmcs_enable": True}, "III", FUSED),
    # dispatch_inter_search declines LMCS: the P frames are searched when
    # they are encoded, not a pipeline step ahead
    "lmcs-ld": (128, 80, {"lmcs_enable": True}, "IPP", LD),
    "ibc": (128, 80, {"ibc": 1}, "IPP", LD),
    "trskip": (128, 80, {"trskip_enable": True}, "IPP", LD),
    "scaling-list2": (128, 80, {"scaling_list": 2}, "IPP", LD),
    # rc_algorithm is "lambda" (R-lambda) or "oba"
    "rc-lambda": (128, 80, {"target_bitrate": 200000,
                            "rc_algorithm": "lambda"}, "IPP", LD),
    "rc-oba": (128, 80, {"target_bitrate": 200000, "rc_algorithm": "oba"},
               "IPP", LD),
    "vaq": (128, 80, {"vaq": 1}, "IPP", LD),
    "amvr-tmvp": (128, 80, {"amvr": 1, "tmvp_enable": True}, "IPP", LD),
    "ra8": (128, 80, RA, "IPB", LD),
    "yuv400": (128, 80, {"input_format": ChromaFormat.CSP_400}, "IPP", LD),
    # sizes off the 16-sample grid
    "136x72-intra": (136, 72, AI, "III", FUSED),
    "136x72-ld-dense": (136, 72, {"ime_algorithm": 2}, "IPP", DENSE),
    # above 8 bits every device inter path declines: search_combined per
    # class on the P frames, the fused search on the I frame
    "136x72-ld-10bit": (136, 72, {"input_bitdepth": 10}, "IPP",
                        COMBINED | {"refs_blocks_grid"}),
    # no inter leaf is chosen in these P frames: K8 has none to refine
    "100x60-ld": (100, 60, {}, "IPP", HOSTME),
    "100x60-ra8": (100, 60, RA, "IPB", LD),
    "100x60-intra-mip-mts3": (100, 60, {**AI, "mip": True, "mts": 3}, "III",
                              INTRA_MTS),
}

# frames under 64 samples: configuration -> (Config options or a preset)
SMALL = {
    "ld": {},
    "ld-10bit": {"input_bitdepth": 10},
    "intra-mts1": {**AI, "mts": 1},
    "slow": "slow",
}
SMALL_SIZES = ((72, 40), (40, 72))


def _frames(cfg):
    """The clip at cfg's size and bit depth, luma only at 4:0:0."""
    return clip(cfg.width, cfg.height, N, bitdepth=cfg.input_bitdepth,
                chroma=cfg.input_format != ChromaFormat.CSP_400)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_tool_matches_reference(case):
    """One test per configuration, so that each encode runs once however
    the tests are spread over workers."""
    w, h, kw, types, reached = CASES[case]
    cfg = Config(width=w, height=h, **kw)
    frames = _frames(cfg)
    ref = encode_ref(RefConfig(width=w, height=h, **kw), frames)
    enc, got, calls = encode_port(cfg, frames)
    assert slice_types(got) == types
    assert_same(got, ref)
    assert set(calls) == reached, calls
    assert_decodes(enc, got)


def _small_config(Cfg, make, name, w, h):
    kw = SMALL[name]
    if isinstance(kw, str):
        return make(kw, width=w, height=h)
    return Cfg(width=w, height=h, **kw)


@pytest.mark.parametrize("size", SMALL_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_frame_encodes_on_the_port(name, size):
    """Under 64 samples the port skips the empty 64x64 class (no wrapper
    sees an empty batch: each refuses one) and encodes."""
    w, h = size
    cfg = _small_config(Config, make_config, name, w, h)
    enc, got, calls = encode_port(cfg, _frames(cfg))
    assert slice_types(got) == ("III" if cfg.gop_len == 0 else "IPP")
    assert {"predict67", "satd67", "rd_cost"} <= set(calls), calls
    for au, rec, _fs, _rl, _src in got:
        assert au and rec.y.shape == (h, w)
    assert_decodes(enc, got)


@pytest.mark.parametrize("size", SMALL_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ("ld", "intra-mts1"))
def test_reference_cannot_encode_under_64_samples(name, size):
    """The documented difference: the reference hands the empty 64x64 class
    to build_refs_grid and raises (the defaults' LD at the first
    P frame's per-class search, all-intra MTS at the first frame)."""
    w, h = size
    cfg = _small_config(RefConfig, None, name, w, h)
    with pytest.raises(IndexError, match="must be of integer"):
        encode_ref(cfg, _frames(cfg))


def _empty_calls():
    """Each kernel wrapper called with an empty batch (CPU tensors)."""
    i32 = dict(dtype=torch.int32)
    e = np.zeros(0, dtype=np.int32)
    plane = torch.zeros((16, 16), **i32)
    blocks = torch.zeros((0, 8, 8), **i32)
    refs = torch.zeros((0, 4 * intra_batch.REF_LEN), **i32)
    s1 = torch.zeros((0, 35), **i32)
    pen = torch.zeros(49)
    return {
        "refs_blocks_grid": lambda: intra_batch.refs_blocks_grid(
            plane, 8, 8, (0, 0, 8, 8, 0, 0)),
        "refs_blocks": lambda: intra_batch.refs_blocks(plane, e, e, 8, 8),
        "predict67": lambda: intra_batch.predict67(refs, {}),
        "predict_modes": lambda: intra_batch.predict_modes(
            refs, torch.zeros((0, 4), **i32), {}),
        "satd67": lambda: intra_batch.satd67(
            torch.zeros((0, 67, 8, 8), **i32), blocks),
        "rd_cost": lambda: rd_cost.rd_cost(
            torch.zeros((0, 67, 8, 8), **i32), blocks, s1, 22, 1.0, None,
            None, {}, 8),
        "rd_cost_pred": lambda: rd_cost.rd_cost_pred(
            blocks, blocks, 22, 1.0, None, None, {}, 8),
        "mts_search": lambda: rd_cost.mts_search(blocks, blocks, 22, 1.0,
                                                 None, {}, 8),
        "rough_select": lambda: rd_cost.rough_select(s1, 1.0, None, None),
        "rough_pick": lambda: rd_cost.rough_pick(s1, None, None, 1.0, None,
                                                 None, None, None),
        "fullpel_search": lambda: me.fullpel_search(
            plane, blocks, torch.zeros(0, **i32), torch.zeros(0, **i32), 16,
            None, 8),
        "frac_search": lambda: me.frac_search(
            plane, blocks, torch.zeros(0, **i32), torch.zeros(0, **i32),
            None, None, pen, 8),
        "frame_inter": lambda: me_frame.frame_inter(
            plane, torch.zeros((48, 48), **i32), None, None, ()),
        "leaf_qpel": lambda: me_frame.leaf_qpel(
            torch.zeros((0, 18, 18), **i32), blocks, torch.zeros(0, **i32), 0,
            pen),
        "mip_preds": lambda: mip.mip_preds(plane, e, e, 8, 8, 8, None),
        "pseudo_recon": lambda: pseudo_recon.pseudo_recon(
            torch.zeros((0, 0), **i32), 22),
        "fwd_batch": lambda: transforms.fwd_batch(blocks),
        "inv_batch": lambda: transforms.inv_batch(blocks),
        "quant_batch": lambda: quant.quant_batch(blocks, 22),
        "dequant_batch": lambda: quant.dequant_batch(blocks, 22),
    }


@pytest.mark.parametrize("wrapper", [name for _m, name in WRAPPERS])
def test_wrapper_refuses_an_empty_batch(wrapper):
    """A launch over zero blocks is an invalid configuration on the card:
    every wrapper refuses an empty batch on every device rather than
    return quietly, so the encodes above show that none is asked for one."""
    with pytest.raises(ValueError, match="empty batch"):
        _empty_calls()[wrapper]()
