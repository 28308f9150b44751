"""The port's mesh encoders (uvg266_tpu_torch.parallel) on the CPU.

On one card the mesh is a logical grid: the 'gop' axis batches frames (or
closed-GOP runs) into one launch per kernel; the 'tile' axis must equal the
config's tile count. Finalize and entropy run per frame on the host, so
each mesh encode must be byte-identical to the port's plain Encoder with
the same Config (the port twins of tests/test_multichip.py, at its sizes:
256x128 x 3 frames; 128x80 x G*L). One case is also held to the JAX
MeshEncoder on the 8 virtual CPU devices of conftest.py: AUs equal,
frame_rd_stats within 1e-5 relative (the port sums the float32 block costs
in float64 on the host, XLA in float32 over 'tile'). The group dispatcher
is held on crafted slots: tolerance 0 against each slot's own call.
"""
import threading

import numpy as np
import pytest
import torch

from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.control.encoder import (Encoder, FramePlanes,
                                              _get_frame_combo_fn,
                                              _get_pframe_intra_combo_fn)
from uvg266_tpu_torch.control.partition import PartitionSearch, qp_to_lambda
from uvg266_tpu_torch.ops.tables import frame_tables
from uvg266_tpu_torch.parallel import (MeshEncoder, MeshGopEncoder,
                                       build_gop_mesh, build_mesh,
                                       tile_grid_for)
from uvg266_tpu_torch.parallel.mesh import _MeshGroupDispatch

FRAME_RD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, so that parallel test workers (and the
    mesh's host threads) do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mkframe(w, h, i):
    rng = np.random.default_rng(40 + i)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip((xx * 2 + yy + i * 17) % 255
                + rng.integers(-20, 21, (h, w)), 0, 255).astype(np.int32)
    u = (y[::2, ::2] // 2 + 40).astype(np.int32)
    v = (y[::2, ::2] // 3 + 60).astype(np.int32)
    return y, u, v


def intra_cfg(tools):
    return dict(width=256, height=128, qp=32, gop_len=0, intra_period=1,
                tiles_width_count=2, tiles_height_count=2, wpp=False,
                **tools)


def encode_single(cfg, frames):
    enc = Encoder(cfg, device="cpu")
    out = []
    for f in frames:
        out += [(au, rec) for (au, rec, *_r) in enc.feed(f)]
    out += [(au, rec) for (au, rec, *_r) in enc.flush()]
    return out


@pytest.mark.parametrize("tools", [
    {},
    {"mip": True, "sao_type": 3, "deblock_enable": True},
    {"intra_rough": True},
], ids=["plain", "mip-sao-deblock", "rough"])
def test_mesh_encode_byte_identical(tools):
    frames = [FramePlanes(*mkframe(256, 128, i)) for i in range(3)]
    ref = encode_single(Config(**intra_cfg(tools)), frames)
    mesh = build_mesh(8, device="cpu")          # ('gop', 'tile') = (2, 4)
    assert mesh.shape == {"gop": 2, "tile": 4}
    menc = MeshEncoder(Config(**intra_cfg(tools)), mesh)
    got = menc.encode(frames)
    assert len(got) == len(ref) == 3
    for i, ((au_m, rec_m), (au_s, rec_s)) in enumerate(zip(got, ref)):
        assert au_m == au_s, f"frame {i}: bitstream differs"
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(rec_m, p), getattr(rec_s, p))
    assert len(menc.frame_rd_stats) == 3
    assert all(s > 0 for s in menc.frame_rd_stats)


def test_mesh_encoder_matches_jax_mesh_encoder():
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from uvg266_tpu.cfg import Config as JConfig
    from uvg266_tpu.control.encoder import FramePlanes as JPlanes
    from uvg266_tpu.parallel import MeshEncoder as JMesh
    from uvg266_tpu.parallel import build_mesh as jbuild
    clip = [mkframe(256, 128, i) for i in range(3)]
    jm = JMesh(JConfig(**intra_cfg({})), jbuild(8))
    want = jm.encode([JPlanes(*f) for f in clip])
    tm = MeshEncoder(Config(**intra_cfg({})), build_mesh(8, device="cpu"))
    got = tm.encode([FramePlanes(*f) for f in clip])
    for i, ((au_t, rec_t), (au_j, rec_j)) in enumerate(zip(got, want)):
        assert au_t == au_j, f"frame {i}: port mesh != JAX mesh"
        assert np.array_equal(rec_t.y, np.asarray(rec_j.y))
    np.testing.assert_allclose(tm.frame_rd_stats, jm.frame_rd_stats,
                               rtol=FRAME_RD_RTOL)


def _mesh_clip(w, h, n, seed=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = np.clip(110 + 70 * np.sin((xx + 3 * t) / 21.0)
                    + 40 * np.cos((yy + 2 * t) / 13.0)
                    + rng.integers(-10, 10, (h, w)), 0, 255)
        u = np.clip(128 + 25 * np.sin(xx[::2, ::2] / 11.0), 0, 255)
        v = np.clip(128 + 25 * np.cos(yy[::2, ::2] / 9.0), 0, 255)
        frames.append(FramePlanes(y.astype(np.int32), u.astype(np.int32),
                                  v.astype(np.int32)))
    return frames


def _check_gop_mesh(cfg_kw, G, L, w=128, h=80):
    """MeshGopEncoder output must be byte-identical to encoding each
    closed-GOP run with a plain Encoder, every step through the batched
    group dispatch."""
    frames = _mesh_clip(w, h, G * L)
    menc = MeshGopEncoder(Config(width=w, height=h, **cfg_kw),
                          build_gop_mesh(G, device="cpu"))
    res = menc.encode(frames)
    assert len(res) == G
    for g in range(G):
        enc = Encoder(Config(width=w, height=h, **cfg_kw), device="cpu")
        ref_outs = []
        for f in frames[g * L:(g + 1) * L]:
            ref_outs.extend(enc.feed(f))
        ref_outs.extend(enc.flush())
        assert len(res[g]) == len(ref_outs) == L
        for i, ((au_m, *_a), (au_r, *_b)) in enumerate(zip(res[g],
                                                           ref_outs)):
            assert au_m == au_r, f"gop {g} result {i} differs"
    # one batched call a frame of each run: the IDR's search, then each
    # P/B frame's intra screen
    assert menc.disp.n_batched == L and menc.disp.n_fallback == 0


def test_gop_mesh_lowdelay_byte_identical():
    _check_gop_mesh(dict(qp=30, gop_len=4, gop_lowdelay=True,
                         intra_period=64, ref_frames=1, sao_type=3,
                         deblock_enable=True, rdoq_enable=False,
                         wpp=False), G=4, L=4)


def test_gop_mesh_ra8_byte_identical():
    _check_gop_mesh(dict(qp=30, gop_len=8, gop_lowdelay=False, bipred=1,
                         intra_period=64, ref_frames=2, sao_type=3,
                         deblock_enable=True, rdoq_enable=False,
                         wpp=False), G=2, L=8)


# --- the group dispatcher on crafted slots ----------------------------------

W, H = 96, 64


def _screen(kind):
    """(key, args(plane, qp) -> a slot's arguments, single(plane, qp) ->
    the flat vector the slot's own call gives) of the P/B intra screen or
    an IDR's frame search."""
    cfg = Config(width=W, height=H, qp=27, gop_len=4, gop_lowdelay=True,
                 intra_period=64, rdoq_enable=False, wpp=False)
    enc = Encoder(cfg, device="cpu")
    ps = PartitionSearch(enc.ctrl, cfg, qp=27, is_intra=kind == "frame")
    entries = enc.slice_enc._fused_entries(ps)
    classes = tuple((w, h, g) for (_k, w, h, _p, g) in entries)
    intra = kind == "frame"
    if intra:
        key = ("frame_intra", classes, 8)
        fn = _get_frame_combo_fn(classes, 8)
    else:
        key = ("pframe_intra", classes, H, W, 8)
        fn = _get_pframe_intra_combo_fn(classes, H, W, 8)

    def args(plane, qp):
        return (plane, enc.ctrl.luma_qp_scaled(qp),
                float(np.float32(qp_to_lambda(qp, intra))), qp)

    def single(plane, qp):
        _p, qps, lam, _qp = args(plane, qp)
        tabs = frame_tables(qp, "cpu")
        return fn(torch.from_numpy(plane), qps, lam, tabs["wts"],
                  tabs["mode_bits"]).numpy()

    return key, args, single


def _run_slots(disp, calls):
    """calls[s] = (key, args, fallback): run every slot on its own thread
    -> (results, exceptions) per slot."""
    res = [None] * len(calls)
    errs = [None] * len(calls)

    def work(s):
        try:
            res[s] = disp.run(s, *calls[s])
        except BaseException as e:      # noqa: BLE001 (collected per slot)
            errs[s] = e

    threads = [threading.Thread(target=work, args=(s,))
               for s in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a slot did not return"
    return res, errs


def _planes(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("kind", ["pframe", "frame"])
def test_group_dispatch_mixed_qps_equal_single_calls(kind):
    """Slots at two QPs (not next to each other) run as two K4 (and K5)
    groups of one batch; each slot gets what its own call gives."""
    key, args, single = _screen(kind)
    qps = [27, 32, 27]
    planes = _planes(3)
    disp = _MeshGroupDispatch(build_gop_mesh(3, device="cpu"), 3)
    never = [lambda: pytest.fail("fell back")] * 3
    res, errs = _run_slots(disp, [(key, args(p, q), f) for p, q, f
                                  in zip(planes, qps, never)])
    assert errs == [None] * 3
    for s in range(3):
        assert np.array_equal(res[s], single(planes[s], qps[s])), s
    assert disp.n_batched == 1 and disp.n_fallback == 0


def test_group_dispatch_divergent_keys_fall_back_and_count():
    key, args, single = _screen("pframe")
    fkey, fargs, fsingle = _screen("frame")
    planes = _planes(2, seed=6)
    disp = _MeshGroupDispatch(build_gop_mesh(2, device="cpu"), 2)
    calls = [(key, args(planes[0], 27), lambda: single(planes[0], 27)),
             (fkey, fargs(planes[1], 30), lambda: fsingle(planes[1], 30))]
    res, errs = _run_slots(disp, calls)
    assert errs == [None, None]
    assert np.array_equal(res[0], single(planes[0], 27))
    assert np.array_equal(res[1], fsingle(planes[1], 30))
    assert disp.n_batched == 0 and disp.n_fallback == 2


def test_group_dispatch_barrier_timeout_falls_back():
    key, args, single = _screen("pframe")
    plane = _planes(1, seed=7)[0]
    disp = _MeshGroupDispatch(build_gop_mesh(2, device="cpu"), 2)
    disp.TIMEOUT_S = 0.2                    # slot 1 never arrives
    res, errs = _run_slots(disp, [(key, args(plane, 27),
                                   lambda: single(plane, 27))])
    assert errs == [None]
    assert np.array_equal(res[0], single(plane, 27))
    assert disp.n_batched == 0 and disp.n_fallback == 1


def test_group_dispatch_error_reaches_every_slot(monkeypatch):
    """The batched call catches nothing: its exception is raised in every
    slot, and no slot falls back."""
    key, args, _single = _screen("pframe")
    planes = _planes(3, seed=8)
    disp = _MeshGroupDispatch(build_gop_mesh(3, device="cpu"), 3)

    def broken(_key, _args):
        raise RuntimeError("kernel refused the launch")
    monkeypatch.setattr(disp, "_batched", broken)
    never = lambda: pytest.fail("fell back")    # noqa: E731
    res, errs = _run_slots(disp, [(key, args(p, 27), never)
                                  for p in planes])
    assert res == [None] * 3
    assert all(isinstance(e, RuntimeError) and "refused" in str(e)
               for e in errs)
    assert disp.n_batched == 0 and disp.n_fallback == 0


def test_meshes_default_to_the_card():
    """build_mesh / build_gop_mesh default to the CUDA device and raise
    without one; the mesh shape rule is the reference's."""
    if torch.cuda.is_available():
        assert build_mesh(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_mesh(8)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_gop_mesh(2)
    assert build_mesh(8, device="cpu").shape == {"gop": 2, "tile": 4}
    assert build_mesh(6, device="cpu").shape == {"gop": 2, "tile": 3}
    assert build_mesh(3, device="cpu").shape == {"gop": 1, "tile": 3}
    assert build_mesh(2, device="cpu").shape == {"gop": 1, "tile": 2}
    assert build_mesh(8, n_gop=4, device="cpu").shape == {"gop": 4,
                                                          "tile": 2}
    assert build_gop_mesh(3, device="cpu").shape == {"gop": 3}
    assert tile_grid_for(4) == (2, 2) and tile_grid_for(6) == (3, 2)
    with pytest.raises(ValueError, match="tile"):
        MeshEncoder(Config(**intra_cfg({})), build_mesh(8, n_gop=4,
                                                        device="cpu"))
