#!/usr/bin/env python3
"""Device times of the port's K6 rd_cost_pred, K4 rd_cost, K1
refs_blocks_grid and K12a refs_blocks on an NVIDIA card, so that two
checkouts' sources can be compared in one call.

    python3 tools/k6_k1_times.py [--root DIR]

Imports uvg266_tpu_torch from DIR (default: this checkout), builds the
sources it runs and times, on chip_smoke.py's synthetic clip (832x480):

  K6   the dense path's inter classes (32x32, 16x16, 8x8) on K7's winning
       predictions, frame 1 against frame 0, 8 bits, QP27 (one reference:
       their sum is "a dense reference"); search_combined's classes of the
       10-bit LD path (16x16, 8x8) on K9b's winning predictions at 10 bits;
       the rough chain's 32x8 class on K12c's winners at QP22 with the
       intra slice's quant rounding 171.
  K4   the four all-intra classes (64x64 B=91 .. 8x8 B=6240) of frame 0,
       8 bits, QP22, over the 67 modes.
  K1   the four all-intra classes (their sum is "a frame") and the 32x8
       BT child class on its grid, src alone (the all-intra form); the
       four classes again with frame 0's K5 pseudo-reconstruction at QP27
       as the separate reference plane (the P/B intra screen's form),
       one frame.
  K12a the MIP path's four classes at their positions, through its C
       entry (the wrapper copies the positions from the host, which a
       CUDA graph cannot capture).

Each wrapper's output is held against its plain version first. Each device
time is one call's share of 20 calls captured in a CUDA graph and replayed,
beside CUDA events over 20 calls from the host. Prints the card and its
power limit, one line per kernel and class, the sums, and a JSON line of
the times in ms.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose uvg266_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from uvg266_tpu_torch import kernels
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import SliceEncoder
    from uvg266_tpu_torch.control.params import EncoderControl
    from uvg266_tpu_torch.control.partition import (PartitionSearch,
                                                    qp_to_lambda)
    from uvg266_tpu_torch.ops import intra_batch as ib
    from uvg266_tpu_torch.ops import me
    from uvg266_tpu_torch.ops import me_frame as mf
    from uvg266_tpu_torch.ops import pseudo_recon as pr
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops.tables import (device_tables, frame_tables,
                                             me_penalties, rough_modes)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(kernels.CSRC)}", flush=True)
    kernels.build(["rd_cost_pred", "rd_cost", "refs_blocks_grid",
                   "predict67", "satd67", "frame_inter", "pseudo_recon",
                   "fullpel_search", "frac_search", "predict_modes",
                   "rough_refine"])
    dev = torch.device("cuda")
    H, W = cs.H, cs.W
    frames = cs.synth_clip(W, H, 2)
    f0 = torch.from_numpy(frames[0][0]).to(dev)
    out = {}

    def fail(what):
        print(f"FAIL: {what} differs from its plain version", flush=True)
        return 1

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)) \
            if isinstance(a, tuple) else torch.equal(a, b)

    def time_it(name, fn):
        out[name] = (cs.graph_ms(torch, fn, 20), cs.time_ms(torch, fn, 20))

    # --- K6 -----------------------------------------------------------------
    dcfg = cs.dense_config(Config)
    dctrl = EncoderControl(dcfg)
    probe = SliceEncoder(dcfg, dctrl, device=dev)
    iclasses = cs.inter_classes(probe, probe._fused_entries(
        PartitionSearch(dctrl, dcfg, qp=cs.LD_QP)))
    cur, ref_pad, pen, bits_tab = cs.k7_inputs(torch, frames, dev)
    found = mf.frame_inter(cur, ref_pad, pen, bits_tab, iclasses, cs.R)
    lam_i = float(np.float32(qp_to_lambda(cs.LD_QP, False)))
    ft27 = frame_tables(cs.LD_QP, "cuda")
    for (w, h, _g), (_idx, pred, blk, extra) in zip(iclasses, found):
        a = (pred, blk, cs.LD_QP, lam_i, ft27["wts"], extra,
             device_tables(w, h, 8, "cuda"), 8)
        if not same(rc.rd_cost_pred(*a), rc.rd_cost_pred_plain(*a)):
            return fail(f"rd_cost_pred dense {w}x{h}")
        time_it(f"rd_cost_pred dense {w}x{h} B={blk.shape[0]}",
                lambda a=a: rc.rd_cost_pred(*a))
    del found
    # search_combined's classes at 10 bits, on K9b's winners
    l10cfg = cs.ld10_config(Config)
    ps10 = PartitionSearch(EncoderControl(l10cfg), l10cfg, qp=cs.LD_QP,
                           is_intra=False)
    lo, hi = l10cfg.pu_depth_inter
    me_cls = [c for c in cs.search_classes(ps10)
              if lo <= (64 // max(c[0], c[1])).bit_length() - 1 <= hi]
    pen_me, fpen = me_penalties(qp_to_lambda(cs.LD_QP, False), cs.R, "cuda")
    r10, s10 = (torch.from_numpy(frames[i][0] * 4).to(dev) for i in (0, 1))
    for (w, h, pos) in me_cls:
        xs_d, ys_d = ib.positions_on([p[0] for p in pos], [p[1] for p in pos],
                                     w, h, H, W, dev)
        blk = me.windows(s10, xs_d, ys_d, w, h, 0).to(torch.int32)
        mvx, mvy, _c = me.fullpel_search(r10, blk, xs_d, ys_d, cs.R, pen_me,
                                         10)
        _b, pred, _fc = me.frac_search(r10, blk, xs_d, ys_d, mvx, mvy, fpen,
                                       10, winner_only=True)
        extra = torch.full((len(pos),), 4.0, dtype=torch.float32, device=dev)
        a = (pred, blk, cs.LD_QP + 12, lam_i, ft27["wts"], extra,
             device_tables(w, h, 10, "cuda"), 10)
        if not same(rc.rd_cost_pred(*a), rc.rd_cost_pred_plain(*a)):
            return fail(f"rd_cost_pred 10-bit {w}x{h}")
        time_it(f"rd_cost_pred 10-bit {w}x{h} B={len(pos)}",
                lambda a=a: rc.rd_cost_pred(*a))
    # the rough chain's 32x8 class, intra rounding
    w, h = 32, 8
    xs = np.tile(np.arange(W // w, dtype=np.int32) * w, H // h)
    ys = np.repeat(np.arange(H // h, dtype=np.int32) * h, W // w)
    tabs = device_tables(w, h, 8, "cuda")
    ft = frame_tables(cs.QP, "cuda")
    lam = float(np.float32(qp_to_lambda(cs.QP)))
    m1 = rough_modes("cuda")
    refs, blocks = ib.refs_blocks(f0, xs, ys, w, h)
    p1 = ib.predict67(refs, tabs, m1)
    s1 = ib.satd67(p1, blocks)
    refine = rc.rough_select(s1, lam, ft["mode_bits"], m1)
    p2 = ib.predict_modes(refs, refine, tabs)
    _bm, _sb, extra, pred = rc.rough_pick(s1, ib.satd67(p2, blocks), refine,
                                          lam, ft["mode_bits"], m1, p1, p2)
    a = (pred, blocks, cs.QP, lam, ft["wts"], extra, tabs, 8, True)
    if not same(rc.rd_cost_pred(*a), rc.rd_cost_pred_plain(*a)):
        return fail("rd_cost_pred rough 32x8")
    time_it(f"rd_cost_pred rough {w}x{h} B={xs.size}",
            lambda a=a: rc.rd_cost_pred(*a))
    del p1, p2, s1, refs, blocks, pred

    # --- K4, K1, K12a on the all-intra classes ------------------------------
    cfg = cs.bench_config(Config)
    ctrl = EncoderControl(cfg)
    entries = SliceEncoder(cfg, ctrl, device=dev)._fused_entries(
        PartitionSearch(ctrl, cfg, qp=cs.QP))
    pseudo = pr.pseudo_recon(f0, cs.LD_QP, 8)
    for (_k, w, h, positions, g) in entries:
        B = g[4] * g[5]
        tabs = device_tables(w, h, 8, "cuda")
        refs, blocks = ib.refs_blocks_grid(f0, w, h, g)
        if not same((refs, blocks), ib.refs_blocks_grid_plain(f0, w, h, g)):
            return fail(f"refs_blocks_grid {w}x{h}")
        time_it(f"refs_blocks_grid {w}x{h} B={B}",
                lambda w=w, h=h, g=g: ib.refs_blocks_grid(f0, w, h, g))
        if not same(ib.refs_blocks_grid(f0, w, h, g, pseudo),
                    ib.refs_blocks_grid_plain(f0, w, h, g, pseudo)):
            return fail(f"refs_blocks_grid refsrc {w}x{h}")
        time_it(f"refs_blocks_grid refsrc {w}x{h} B={B}",
                lambda w=w, h=h, g=g: ib.refs_blocks_grid(f0, w, h, g,
                                                          pseudo))
        preds = ib.predict67(refs, tabs)
        satds = ib.satd67(preds, blocks)
        a = (preds, blocks, satds, cs.QP, lam, ft["wts"], ft["mode_bits"],
             tabs, 8)
        if not same(rc.rd_cost(*a), rc.rd_cost_plain(*a)):
            return fail(f"rd_cost {w}x{h}")
        time_it(f"rd_cost {w}x{h} B={B}", lambda a=a: rc.rd_cost(*a))
        del preds, satds, a
        # K12a at the class's positions, through its C entry
        xs = np.array([p[0] for p in positions], dtype=np.int32)
        ys = np.array([p[1] for p in positions], dtype=np.int32)
        want = ib.refs_blocks_plain(f0, xs, ys, w, h)
        if not same(ib.refs_blocks(f0, xs, ys, w, h), want):
            return fail(f"refs_blocks {w}x{h}")
        xd, yd = ib.positions_on(xs, ys, w, h, H, W, dev)
        r_out, b_out = torch.empty_like(want[0]), torch.empty_like(want[1])

        def k12a(xd=xd, yd=yd, B=len(positions), w=w, h=h, r_out=r_out,
                 b_out=b_out):
            kernels.launch("refs_blocks", dev, f0.data_ptr(), H, W,
                           xd.data_ptr(), yd.data_ptr(), B, w, h,
                           r_out.data_ptr(), b_out.data_ptr())
        k12a()
        if not same((r_out, b_out), want):
            return fail(f"refs_blocks C entry {w}x{h}")
        time_it(f"refs_blocks {w}x{h} B={len(positions)}", k12a)
    w, h = 32, 8
    g = (0, 0, w, h, W // w, H // h)
    if not same(ib.refs_blocks_grid(f0, w, h, g),
                ib.refs_blocks_grid_plain(f0, w, h, g)):
        return fail("refs_blocks_grid 32x8")
    time_it(f"refs_blocks_grid {w}x{h} B={g[4] * g[5]}",
            lambda: ib.refs_blocks_grid(f0, w, h, g))
    torch.cuda.synchronize()

    for name, (g_ms, e_ms) in out.items():
        print(f"  {name}: {g_ms:.4f} ms device (graph), {e_ms:.4f} ms events",
              flush=True)
    sums = {
        "rd_cost_pred a dense reference": "rd_cost_pred dense ",
        "rd_cost_pred a 10-bit reference": "rd_cost_pred 10-bit ",
        "rd_cost a frame": "rd_cost ",
        "refs_blocks_grid a frame": "refs_blocks_grid ",
        "refs_blocks_grid refsrc a frame": "refs_blocks_grid refsrc ",
        "refs_blocks a frame": "refs_blocks ",
    }
    for label, prefix in sums.items():
        names = [n for n in out if n.startswith(prefix)
                 and "32x8" not in n
                 and not (prefix == "refs_blocks_grid " and "refsrc" in n)]
        print(f"  {label}: {sum(out[n][0] for n in names):.4f} ms device "
              f"(graph), {sum(out[n][1] for n in names):.4f} ms events",
              flush=True)
    print(json.dumps({n: {"device_ms": v[0], "event_ms": v[1]}
                      for n, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
