"""``correct`` tells a sound run from its control and from a broken timed
path: the control (the reference in the precision below the program's in
the program's place) fails a cell's numbers, on the CPU at a small size
and on the card at the cell's size; and a run whose timed path is broken
underneath (the harness driven on the CPU, past its look for a card)
comes out not correct."""
import numpy as np
import pytest

import control
from harness import cli, spec

SMALL = {"ultrafast_1080p.ai_pipelined": {"width": 200, "height": 136},
         "medium_480p.ld": {"width": 200, "height": 144}}
SEEDS = (2**31 + 11, 2**32 + 7, 5)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(name):
    cell = spec.Cell(spec.benchmark(), name)
    for seed in SEEDS:
        got = control.control(cell, seed, "cpu", 2.0, SMALL[name])
        assert not got["control_passes"], got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "size there")
    cell = spec.Cell(spec.benchmark(), name)
    for seed in SEEDS:
        got = control.control(cell, seed, "cuda", 20.0)
        assert not got["control_passes"], got


def _cell(name, **traffic):
    cell = spec.Cell(spec.benchmark(), name)
    cell.traffic = {**cell.traffic, **traffic}
    return cell


def _run(cell, name):
    return cli.run_cell(cell, 2**35 + 3, 2.0, False, device="cpu",
                        overrides=SMALL[name])


def test_a_sound_run_is_correct():
    name = "ultrafast_1080p.ai_pipelined"
    out = _run(_cell(name, check_frames=9, check_rate=0), name)
    assert out["correct"], out["checks"]
    assert out["checks"]["frames_checked"]["value"] == 9


def test_an_altered_mode_is_not_correct(monkeypatch):
    from uvg266_tpu_torch.control.encoder import SliceEncoder
    orig = SliceEncoder.dispatch_frames_search

    def altered(self, fss, sps):
        def alter(r):
            def resolve():
                ctus = r()
                leaf = next(ctus[0].leaves())
                leaf.cu_desc = {**leaf.cu_desc,
                                "mode": (leaf.cu_desc["mode"] + 33) % 67}
                return ctus
            return resolve
        return [alter(r) for r in orig(self, fss, sps)]
    monkeypatch.setattr(SliceEncoder, "dispatch_frames_search", altered)
    name = "ultrafast_1080p.ai_pipelined"
    out = _run(_cell(name, check_frames=9, check_rate=0), name)
    assert not out["correct"]
    assert out["checks"]["mode_gap"]["value"] > \
        out["checks"]["mode_gap"]["limit"]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from uvg266_tpu_torch.control.encoder import SliceEncoder
    orig = SliceEncoder.dispatch_frames_search

    def half(self, fss, sps):
        k = (len(fss) + 1) // 2
        rs = orig(self, fss[:k], sps[:k])
        return rs + [rs[-1]] * (len(fss) - k)
    monkeypatch.setattr(SliceEncoder, "dispatch_frames_search", half)
    name = "ultrafast_1080p.ai_pipelined"
    out = _run(_cell(name, check_frames=9, check_rate=0), name)
    assert not out["correct"]


def _screen_fault(monkeypatch, change):
    from uvg266_tpu_torch.control.encoder import SliceEncoder
    orig = SliceEncoder._launch_intra_screen
    state = {}

    def broken(self, entries, src_y, qp):
        fetch = orig(self, entries, src_y, qp)
        return lambda: change(np.array(fetch(), copy=True), state)
    monkeypatch.setattr(SliceEncoder, "_launch_intra_screen", broken)
    name = "medium_480p.ld"
    return _run(_cell(name, check_frames=4, check_rate=0), name)


def test_an_altered_screen_is_not_correct(monkeypatch):
    def alter(flat, _state):
        flat[0] = (flat[0] + 33) % 67
        return flat
    out = _screen_fault(monkeypatch, alter)
    assert not out["correct"]
    assert out["checks"]["mode_gap"]["value"] > \
        out["checks"]["mode_gap"]["limit"]


def test_a_screen_that_keeps_its_state_is_not_correct(monkeypatch):
    def stale(flat, state):
        return state.setdefault("first", flat)
    out = _screen_fault(monkeypatch, stale)
    assert not out["correct"]


def _ld():
    name = "medium_480p.ld"
    return cli.run_cell(_cell(name, check_frames=4, check_rate=0,
                              rdoq_every=3), 2**35 + 3, 4.0, False,
                        device="cpu", overrides=SMALL[name])


def test_a_sound_low_delay_run_is_correct():
    out = _ld()
    assert out["correct"], out["checks"]
    assert out["checks"]["frames_checked"]["value"] >= 1
    assert out["checks"]["rdoq_calls_checked"]["value"] >= 1


def _over(out, key):
    assert not out["correct"]
    assert out["checks"][key]["value"] > out["checks"][key]["limit"], \
        out["checks"]


def test_an_altered_motion_vector_is_not_correct(monkeypatch):
    import uvg266_tpu_torch.native as nat
    orig = nat.me_frame_native

    def altered(*args, **kw):
        mvs, costs = orig(*args, **kw)
        mvs = mvs.copy()
        mvs[..., 0] += 1
        return mvs, costs
    monkeypatch.setattr(nat, "me_frame_native", altered)
    _over(_ld(), "me_rd_gap")


def test_a_motion_search_that_keeps_its_state_is_not_correct(monkeypatch):
    import uvg266_tpu_torch.native as nat
    orig = nat.me_frame_native
    state = {}

    def stale(*args, **kw):
        mvs, costs = orig(*args, **kw)
        m0, c0 = state.setdefault("first", (mvs, costs))
        rows = np.arange(len(mvs)) % len(m0)    # the first call's, per ref
        return m0[rows].copy(), c0[rows].copy()
    monkeypatch.setattr(nat, "me_frame_native", stale)
    _over(_ld(), "me_rd_gap")


def test_an_altered_leaf_refinement_is_not_correct(monkeypatch):
    import uvg266_tpu_torch.ops.me_frame as mf
    orig = mf.leaf_qpel

    def altered(*args, **kw):
        best, cost, seg = orig(*args, **kw)
        seg = seg.clone()
        seg[:, 24] += 7
        return best, cost, seg
    monkeypatch.setattr(mf, "leaf_qpel", altered)
    _over(_ld(), "qpel_gap")


def test_an_altered_refined_vector_is_not_correct(monkeypatch):
    from uvg266_tpu_torch.control.encoder import SliceEncoder
    orig = SliceEncoder._refine_inter_leaves

    def altered(self, ctus, *args):
        orig(self, ctus, *args)
        for node in ctus:
            for leaf in node.leaves():
                d = leaf.cu_desc
                if d.get("type") == "inter":
                    d["mv"] = (d["mv"][0] + 4, d["mv"][1])
    monkeypatch.setattr(SliceEncoder, "_refine_inter_leaves", altered)
    _over(_ld(), "qpel_mv_miss")


def test_altered_rdoq_levels_are_not_correct(monkeypatch):
    import uvg266_tpu_torch.ops.rdoq as rq
    orig = rq.rdoq_levels

    def altered(*args, **kw):
        out = orig(*args, **kw).copy()
        out.flat[0] += 1
        return out
    monkeypatch.setattr(rq, "rdoq_levels", altered)
    _over(_ld(), "rdoq_miss")


def test_the_reference_rdoq_is_the_ports_copy():
    from uvg266_tpu_torch.ops.rdoq import rdoq_levels

    import reference.rdoq as rr
    rng = np.random.default_rng(2**33 + 9)
    for w, h in ((4, 4), (8, 4), (8, 8), (16, 8), (16, 16), (32, 32),
                 (64, 64), (4, 16)):
        for qp in (22, 27, 37):
            coef = rng.integers(-900, 900, (h, w)) * \
                (rng.random((h, w)) < 0.3)
            for intra in (True, False):
                want = rdoq_levels(coef, qp, 8, 57.0, intra)
                assert np.array_equal(
                    rr.rdoq_levels(coef, qp, 8, 57.0, intra), want)
