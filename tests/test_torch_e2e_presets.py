"""Every preset end to end: the port against the reference.

Each preset is built with each package's own ``make_config(preset,
width=..., height=...)`` and encodes tests/test_inter_fused.py's clip, 3
low-delay frames at the preset's GOP (the Config default, GOP 4), at
128x80 (64x64 for veryslow and placebo: their BT/TT depths 2 and 3 and
the dual tree make the reference's per-class compile the slowest).
uvg266_tpu.control.encoder.Encoder (JAX on the CPU) and
uvg266_tpu_torch.control.encoder.Encoder(device="cpu") (the kernels' plain
PyTorch versions) must give byte-identical access units and recon, the
path must reach its kernels' wrappers, and the port's oracle must decode
every access unit, with its references, to the port's recon.

slower, veryslow and placebo set ``pu_depth_inter=(0, 3)``: a 64x64 inter
candidate, whose host cost the reference computes by reading past its
64-point DCT table (its P/B bytes are undefined there; the port reads a
full table, ROADMAP queue 3). They are compared at ``pu_depth_inter=(1,
3)``; the presets as they stand run on the port alone, where their I slice
must equal the compared run's (pu_depth_inter does not touch I slices) and
their P slices must decode through the oracle.
tests/test_torch_e2e_dct64.py runs the reference on 64x64 candidates in a
child process.
"""
import pytest

from torch_e2e_common import (COMBINED, FUSED, HOSTME, assert_decodes,
                              assert_same, clip, encode, encode_port,
                              encode_ref, one_thread, slice_types)
from uvg266_tpu.cfg import make_config as ref_make_config
from uvg266_tpu_torch import trace
from uvg266_tpu_torch.cfg import PRESETS, make_config
from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes
from uvg266_tpu_torch.control.partition import PartitionSearch

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

N = 3
# the presets whose pu_depth_inter reaches a 64x64 inter candidate
DCT64 = ("slower", "veryslow", "placebo")
# preset -> the wrappers its frames reach: the fused all-intra search and
# the host-ME intra screen (with rdoq on, K8 refines the inter leaves),
# or with MTS search_blocks and search_combined per class (K11 up to 32x32)
REACHED = {
    **dict.fromkeys(("ultrafast", "superfast", "veryfast", "faster"), HOSTME),
    **dict.fromkeys(("fast", "medium", "slow"), HOSTME | {"leaf_qpel"}),
    **dict.fromkeys(DCT64, COMBINED | {"mts_search"}),
}


def _size(preset):
    return (64, 64) if preset in ("veryslow", "placebo") else (128, 80)


def _options(preset):
    w, h = _size(preset)
    return dict(width=w, height=h,
                **({"pu_depth_inter": (1, 3)} if preset in DCT64 else {}))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_matches_reference(preset):
    """One test per preset, so that each encode runs once however the
    tests are spread over workers."""
    w, h = _size(preset)
    frames = clip(w, h, N)
    ref = encode_ref(ref_make_config(preset, **_options(preset)), frames)
    enc, got, calls = encode_port(make_config(preset, **_options(preset)),
                                  frames)
    assert slice_types(got) == "IPP"
    assert_same(got, ref)
    assert set(calls) == REACHED[preset], calls
    if REACHED[preset] >= FUSED:
        # K1-K4 once per class and frame (I frame and P-frame screen):
        # under slow the BT/TT classes too
        n_cls = sum(1 for c in PartitionSearch(enc.ctrl, enc.cfg)._classes()
                    if c[3])
        assert n_cls == (12 if enc.cfg.max_btt_depth[0] else 4)
        assert all(calls[k] == N * n_cls for k in FUSED), calls
    assert_decodes(enc, got)


@pytest.mark.parametrize("preset", DCT64)
def test_preset_as_it_stands_on_the_port(preset):
    """The preset with its own pu_depth_inter=(0, 3): the I slice equals
    the compared configuration's, the P slices decode through the oracle."""
    w, h = _size(preset)
    frames = clip(w, h, N)
    enc, got, calls = encode_port(make_config(preset, width=w, height=h),
                                  frames)
    assert enc.cfg.pu_depth_inter == (0, 3)
    _e, cmp_got, _c = encode_port(make_config(preset, **_options(preset)),
                                  frames[:1])
    assert_same(got[:1], cmp_got)
    assert slice_types(got) == "IPP"
    assert set(calls) == REACHED[preset], calls
    assert_decodes(enc, got)


@pytest.mark.parametrize("preset", ("fast", "medium"))
def test_intra_cus_take_native_recon_under_rdoq(preset):
    """With rdoq on, every intra CU of the Python finalize takes the C++
    recon and its C++ rdoq (tracer counters ``intra_native`` and
    ``intra_python``), and the access units and recon equal those of the
    Python recon (``force_python_intra_recon``)."""
    cfg = make_config(preset, **_options(preset))
    assert cfg.rdoq_enable
    frames = clip(*_size(preset), N)
    trace.start()
    try:
        enc = Encoder(cfg, device="cpu")
        got = encode(enc, FramePlanes, frames)
    finally:
        recs = trace.stop()
    calls = {}
    for (_frame, name), (n, _total) in recs.counters.items():
        calls[name] = calls.get(name, 0) + n
    assert calls.get("intra_native", 0) > 0, calls
    assert calls.get("intra_python", 0) == 0, calls
    py = Encoder(cfg, device="cpu")
    py.slice_enc.force_python_intra_recon = True
    want = encode(py, FramePlanes, frames)
    assert slice_types(got) == "IPP"
    assert_same(got, want)

