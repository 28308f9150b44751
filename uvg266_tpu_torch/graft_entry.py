"""Entry points of the port: the fused search step, and the mesh dry run.

The flagship compute path of the encoder is the fused batched intra
search: reference construction on the card (K12a), all-67-mode prediction
(K2), SATD (K3) and the transform-domain RD cost (K4), the phase-1 kernel
chain of the two-phase encoder design. Both entry points run on the card
unless the caller passes device="cpu" (the kernels' plain versions).
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def _example_frame(W=128, H=128, nblk=32, w=16, h=16, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (H, W)).astype(np.int32)
    gw = W // w
    idx = rng.permutation(gw * (H // h))[:nblk]
    xs = ((idx % gw) * w).astype(np.int32)
    ys = ((idx // gw) * h).astype(np.int32)
    return src, xs, ys


def entry(device=None):
    """Returns (fn, example_args): the fused search step (K12a refs_blocks
    -> K2 predict67 -> K3 satd67 -> K4 rd_cost at 16x16, QP 22) and its
    inputs on the device, fn(src [H, W] int32 tensor, xs, ys [B] int32)
    -> (best [B] int32, costs [B] float32)."""
    from .ops.fast_cost_tables import FAST_COEFF_WTS
    from .ops.intra_batch import predict67, refs_blocks, satd67
    from .ops.rd_cost import rd_cost
    from .ops.tables import device_tables

    dev = resolve_device(device)
    w = h = 16
    tabs = device_tables(w, h, 8, str(dev))
    wts = torch.from_numpy(np.asarray(FAST_COEFF_WTS[22],
                                      dtype=np.float32)).to(dev)
    mode_bits = torch.full((67,), 5.0, dtype=torch.float32, device=dev)
    lam = float(np.float32(5.74))

    def search_step(src, xs, ys):
        refs, blocks = refs_blocks(src, xs, ys, w, h)
        preds = predict67(refs, tabs)
        best, costs, _ = rd_cost(preds, blocks, satd67(preds, blocks), 22,
                                 lam, wts, mode_bits, tabs, 8)
        return best, costs

    src, xs, ys = _example_frame()
    return search_step, (torch.from_numpy(src).to(dev), xs, ys)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Encode real frames with the phase-1 search batched over an
    n-shard ('gop', 'tile') mesh on one card (parallel.mesh).

    - 'tile' axis: the config's tile grid (one tile a shard); on one card
      every tile's blocks ride the same launches, and the per-frame RD
      stat sums all of them.
    - 'gop' axis: data-parallel over frames (the OWF analogue): that many
      frames' searches ride one launch per kernel and class.

    Finalize and the per-tile CABAC substreams run on the host, and the
    bitstream is asserted byte-identical to the plain Encoder with the
    same config; then the closed-GOP mesh (RA8 B-pyramid) likewise, run by
    run."""
    from .cfg import Config
    from .control.encoder import Encoder, FramePlanes
    from .parallel import (MeshEncoder, MeshGopEncoder, build_gop_mesh,
                           build_mesh, tile_grid_for)

    mesh = build_mesh(n_devices, device=device)
    dev = mesh.device
    n_gop, n_tile = mesh.shape["gop"], mesh.shape["tile"]
    tw, th = tile_grid_for(n_tile)
    W, H = 128 * tw, 64 * th            # 2x1 CTUs per tile
    cfg = Config(width=W, height=H, qp=32, gop_len=0, intra_period=1,
                 tiles_width_count=tw, tiles_height_count=th, wpp=False)

    rng = np.random.default_rng(11)
    frames = []
    for i in range(max(2, n_gop)):
        xx, yy = np.meshgrid(np.arange(W), np.arange(H))
        y = np.clip((xx + 2 * yy + 31 * i) % 251
                    + rng.integers(-16, 17, (H, W)), 0, 255).astype(np.int32)
        u = (y[::2, ::2] // 2 + 50).astype(np.int32)
        v = (y[::2, ::2] // 3 + 70).astype(np.int32)
        frames.append(FramePlanes(y, u, v))

    menc = MeshEncoder(cfg, mesh)
    got = menc.encode(frames)
    assert len(menc.frame_rd_stats) == len(frames)
    assert all(s > 0 for s in menc.frame_rd_stats)

    enc = Encoder(Config(width=W, height=H, qp=32, gop_len=0,
                         intra_period=1, tiles_width_count=tw,
                         tiles_height_count=th, wpp=False), device=dev)
    singles = []
    for f in frames:
        singles += [au for (au, *_r) in enc.feed(f)]
    singles += [au for (au, *_r) in enc.flush()]
    for i, au in enumerate(singles):
        assert got[i][0] == au, \
            f"frame {i}: mesh bitstream != single-device bitstream"

    # --- closed-GOP inter batching (RA8 B-pyramid over a 'gop' mesh) ---
    # Every shard owns an IDR-led run; per-frame GOP QP offsets apply;
    # the source-only device phase rides one batched launch per kernel for
    # all runs; host finalize/entropy threads per run. Byte identity with
    # the plain Encoder is asserted per run.
    G = min(n_devices, 4)
    L = 8
    gmesh = build_gop_mesh(G, device=dev)
    gcfg = Config(width=128, height=80, qp=30, gop_len=8,
                  gop_lowdelay=False, bipred=1, intra_period=64,
                  ref_frames=2, sao_type=3, deblock_enable=True,
                  rdoq_enable=False, wpp=False)
    gframes = []
    for i in range(G * L):
        xx, yy = np.meshgrid(np.arange(128), np.arange(80))
        y = np.clip((2 * xx + yy + 17 * i) % 240
                    + rng.integers(-12, 13, (80, 128)), 0,
                    255).astype(np.int32)
        gframes.append(FramePlanes(y, (y[::2, ::2] // 2 + 60).astype(
            np.int32), (y[::2, ::2] // 3 + 80).astype(np.int32)))
    gm = MeshGopEncoder(gcfg, gmesh)
    res = gm.encode(gframes)
    assert gm.disp.n_fallback == 0, "gop mesh fell back to per-run calls"
    for g in range(G):
        enc_g = Encoder(Config(width=128, height=80, qp=30, gop_len=8,
                               gop_lowdelay=False, bipred=1,
                               intra_period=64, ref_frames=2, sao_type=3,
                               deblock_enable=True, rdoq_enable=False,
                               wpp=False), device=dev)
        ref_outs = []
        for f in gframes[g * L:(g + 1) * L]:
            ref_outs.extend(enc_g.feed(f))
        ref_outs.extend(enc_g.flush())
        assert len(res[g]) == len(ref_outs) == L
        for i, ((au_m, *_a), (au_r, *_b)) in enumerate(zip(res[g],
                                                           ref_outs)):
            assert au_m == au_r, \
                f"gop {g} frame {i}: mesh AU != single-device AU"
