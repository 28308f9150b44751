"""The port's mesh encoders in the sharded layout, on the CPU.

A mesh built with ``devices=[...]`` (or, on a machine with the cards, with
no device) runs one launch set a shard, each on its listed device: shard
(g, t) of MeshEncoder searches frame g's tile t, and each closed-GOP run of
MeshGopEncoder is a launch set of its own. ``["cpu"] * n`` reaches that
code here, as the reference's tests reach theirs on the 8 virtual CPU
devices of conftest.py. Held: the JAX MeshEncoder on those 8 devices (AUs
and recons equal, frame_rd_stats within FRAME_RD_RTOL), the batched layout
(device="cpu": the search results, AUs, recons and frame RD stats equal),
plain Encoders for the closed-GOP runs, and each slot's own call for the
group dispatcher (tolerance 0).
"""
import numpy as np
import pytest
import torch

from test_torch_mesh import (FRAME_RD_RTOL, _check_gop_mesh, _planes,
                             _run_slots, _screen, intra_cfg, mkframe)
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.control import encoder as enc_mod
from uvg266_tpu_torch.control.encoder import FramePlanes
from uvg266_tpu_torch.parallel import (MeshEncoder, build_gop_mesh,
                                       build_mesh)
from uvg266_tpu_torch.parallel.mesh import _MeshGroupDispatch

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, so that parallel test workers (and the
    mesh's host threads) do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_frames(got, want):
    assert len(got) == len(want)
    for i, ((au_a, rec_a), (au_b, rec_b)) in enumerate(zip(got, want)):
        assert au_a == au_b, f"frame {i}: bitstream differs"
        for p in ("y", "u", "v"):
            assert np.array_equal(np.asarray(getattr(rec_a, p)),
                                  np.asarray(getattr(rec_b, p))), (i, p)


@pytest.mark.parametrize("tools", [{}, {"mip": True}], ids=["plain", "mip"])
def test_sharded_mesh_matches_jax_mesh_encoder(tools):
    """The port's MeshEncoder, one launch set a shard on 8 CPU devices,
    against the JAX MeshEncoder on the 8 virtual devices: one batch of 2
    frames at 256x128 with 2x2 tiles."""
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from uvg266_tpu.cfg import Config as JConfig
    from uvg266_tpu.control.encoder import FramePlanes as JPlanes
    from uvg266_tpu.parallel import MeshEncoder as JMesh
    from uvg266_tpu.parallel import build_mesh as jbuild
    clip = [mkframe(256, 128, i) for i in range(2)]
    jm = JMesh(JConfig(**intra_cfg(tools)), jbuild(8))
    want = jm.encode([JPlanes(*f) for f in clip])
    tm = MeshEncoder(Config(**intra_cfg(tools)), build_mesh(8, devices=CPU8))
    assert tm._shards is not None
    _same_frames(tm.encode([FramePlanes(*f) for f in clip]), want)
    np.testing.assert_allclose(tm.frame_rd_stats, jm.frame_rd_stats,
                               rtol=FRAME_RD_RTOL)


@pytest.mark.parametrize("tools", [{}, {"mip": True}, {"intra_rough": True},
                                   {"max_btt_depth": (1, 1, 1)}],
                         ids=["plain", "mip", "rough", "btt"])
def test_sharded_mesh_equals_batched_layout(tools, monkeypatch):
    """The sharded layout against the batched one (device="cpu"): one
    _frames_search a shard with a tile's blocks (K1 on the tile's grid,
    K12a where the tile's positions form none), one for the whole batch
    there; each batch's search results equal value for value, then every
    AU, recon and frame RD stat. 200x136: the tiles split the class
    lattices unevenly; "btt" adds the BT and TT classes (offset grids)."""
    kw = {**intra_cfg(tools), "width": 200, "height": 136}
    clip = [FramePlanes(*mkframe(200, 136, i)) for i in range(2)]
    calls = []
    search = enc_mod._frames_search

    def counting(classes, *a, **k):
        calls.append(len(classes))
        return search(classes, *a, **k)
    monkeypatch.setattr(enc_mod, "_frames_search", counting)
    batched = MeshEncoder(Config(**kw), build_mesh(8, device="cpu"))
    sharded = MeshEncoder(Config(**kw), build_mesh(8, devices=CPU8))
    srcs = [np.ascontiguousarray(f.y, dtype=np.int32) for f in clip]
    want = batched._search_flat(kw["qp"], srcs)
    n_cls = len([c for c in batched._search_classes()[1] if c["positions"]])
    assert calls == [n_cls]
    calls.clear()
    got = sharded._search_flat(kw["qp"], srcs)
    plan, total = sharded._tile_plan()
    assert calls == [len(c) for c, _d in plan] * 2 and want.shape[1] == total
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # every value of a batch row comes from exactly one shard
    idx = np.concatenate([d for _c, d in plan])
    assert np.array_equal(np.sort(idx), np.arange(total))
    _same_frames(sharded.encode(clip), batched.encode(clip))
    assert sharded.frame_rd_stats == batched.frame_rd_stats


@pytest.mark.parametrize("case", ["lowdelay", "ra8"])
def test_sharded_gop_mesh_byte_identical(case):
    """MeshGopEncoder with one launch set a run (two CPU devices) against a
    plain Encoder a run, every step through the dispatcher, no fallback."""
    if case == "lowdelay":
        kw, L = dict(qp=30, gop_len=4, gop_lowdelay=True, intra_period=64,
                     ref_frames=1, sao_type=3, deblock_enable=True,
                     rdoq_enable=False, wpp=False), 4
    else:
        kw, L = dict(qp=30, gop_len=8, gop_lowdelay=False, bipred=1,
                     intra_period=64, ref_frames=2, sao_type=3,
                     deblock_enable=True, rdoq_enable=False, wpp=False), 8
    menc = _check_gop_mesh(kw, G=2, L=L, devices=["cpu"] * 2)
    assert [s for (_d, _st, s) in menc.disp.sets] == [(0,), (1,)]


@pytest.mark.parametrize("kind", ["pframe", "frame"])
def test_sharded_group_dispatch_equal_single_calls(kind):
    """Slots at two QPs, one launch set each: each slot gets what its own
    call gives, in one batched step."""
    key, args, single = _screen(kind)
    qps = [27, 32, 27]
    planes = _planes(3)
    disp = _MeshGroupDispatch(build_gop_mesh(3, devices=["cpu"] * 3), 3)
    assert len(disp.sets) == 3
    never = [lambda: pytest.fail("fell back")] * 3
    res, errs = _run_slots(disp, [(key, args(p, q), f) for p, q, f
                                  in zip(planes, qps, never)])
    assert errs == [None] * 3
    for s in range(3):
        assert np.array_equal(res[s], single(planes[s], qps[s])), s
    assert disp.n_batched == 1 and disp.n_fallback == 0


def test_mesh_without_the_cards_raises():
    """No device: the first n cards. On a machine with fewer than 8 the
    mesh raises, naming both counts, and never folds the shards onto one
    card (decided here, on the machine the test runs on)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= 8:
        assert not build_mesh(8).batched
        return
    with pytest.raises(RuntimeError, match=f"8 shards takes the first 8 "
                       f"CUDA devices and this machine has {have}"):
        build_mesh(8)
    with pytest.raises(RuntimeError, match=f"has {have}"):
        MeshEncoder(Config(**intra_cfg({})), build_mesh(8))
