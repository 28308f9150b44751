#!/usr/bin/env python3
"""Device times of the port's K12c rough_refine (its two selection stages
and the whole chain), the chain's other kernels, and K13/K14 on an NVIDIA
card, so that two checkouts' sources can be compared in one call.

    python3 tools/k12c_times.py [--root DIR]

Imports uvg266_tpu_torch from DIR (default: this checkout), builds the
sources it runs and times, on chip_smoke.py's synthetic clip:

  K12c  on the rough path's classes (search_classes of rough_config,
        832x480) at QP22, 8 bits, frame 0 (their sum is "a frame"): stage 1
        (rough_select: the refine lists from the 35 stage-1 SATDs), stage 2
        (rough_pick: the winner of the 39 costs and its prediction) and the
        whole chain (rough_refine: K2 at 35 modes, K3, stage 1, K12b, K3,
        stage 2, K6, seven launches).
  chain the chain's other kernels on the same inputs: K2 predict67 at the
        35 stage-1 modes, K3 satd67 at 35 and at 4 candidates, K12b
        predict_modes on stage 1's lists, K6 rd_cost_pred on stage 2's
        winner (quant rounding 171).
  floor one 1-element add_ replayed in the same kind of graph: the card's
        launch floor, which stage 1 is read against.
  K13, K14  fwd_transform, inv_transform, quant_levels and dequant_levels
        (DCT2, 8 bits, QP22) on the frame's residuals at the four all-intra
        classes, as chip_smoke.py phase 4d times them.

Each wrapper's output is held against its plain version first. Each device
time is one call's share of 20 calls captured in a CUDA graph and replayed,
beside CUDA events over 20 calls from the host. Prints the card and its
power limit, one line per kernel and class with its bound (chip_smoke.py
work(), this checkout's count), the sums, and a JSON line of the times in
ms.
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
    # the samples each angular mode reads, from this checkout (K12b's bound
    # counts the function's work, whichever checkout is timed)
    from uvg266_tpu_torch.ops.tables import mode_reads
    sizes = (4, 8, 16, 32, 64)
    reads = {(w, h): mode_reads(w, h) for w in sizes for h in sizes}
    for m in [m for m in sys.modules if m.startswith("uvg266_tpu_torch")]:
        del sys.modules[m]
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
    from uvg266_tpu_torch.ops import quant as qu
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops import transforms as tr
    from uvg266_tpu_torch.ops.tables import (device_tables, frame_tables,
                                             rough_modes)
    from uvg266_tpu_torch.ops.tr_matrices import DCT2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(kernels.CSRC)}", flush=True)
    kernels.build(["rough_refine", "predict67", "satd67", "predict_modes",
                   "rd_cost_pred", "refs_blocks", "fwd_transform",
                   "quant_levels"])
    dev = torch.device("cuda")
    H, W = cs.H, cs.W
    f0 = torch.from_numpy(cs.synth_clip(W, H, 1)[0][0]).to(dev)
    out = {}
    bounds = {}

    def fail(what):
        print(f"FAIL: {what} differs from its plain version", flush=True)
        return 1

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)) \
            if isinstance(a, tuple) else torch.equal(a, b)

    def time_it(name, fn, wk=None):
        out[name] = (cs.graph_ms(torch, fn, 20), cs.time_ms(torch, fn, 20))
        if wk is not None:
            b, o = cs.work(**wk)
            bounds[name] = max(b / cs.HBM_BYTES_PER_S,
                               o / cs.OPS_PER_S) * 1e3

    # --- the launch floor ---------------------------------------------------
    cs.warm_up(torch)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    time_it("floor add_ 1 element", lambda: one.add_(1))

    # --- K12c and its chain, the rough classes --------------------------------
    rcfg = cs.rough_config(Config)
    ft = frame_tables(cs.QP, "cuda")
    lam = float(np.float32(qp_to_lambda(cs.QP)))
    mb = ft["mode_bits"]
    m1 = rough_modes("cuda")
    for (w, h, pos) in cs.search_classes(PartitionSearch(EncoderControl(rcfg),
                                                         rcfg, qp=cs.QP)):
        B = len(pos)
        xs = np.array([p[0] for p in pos], dtype=np.int32)
        ys = np.array([p[1] for p in pos], dtype=np.int32)
        tabs = device_tables(w, h, 8, "cuda")
        refs, blocks = ib.refs_blocks(f0, xs, ys, w, h)
        p1 = ib.predict67(refs, tabs, m1)
        s1 = ib.satd67(p1, blocks)
        refine = rc.rough_select(s1, lam, mb, m1)
        if not same(refine, rc.rough_select_plain(s1, lam, mb, m1)):
            return fail(f"rough_select {w}x{h}")
        p2 = ib.predict_modes(refs, refine, tabs)
        s2 = ib.satd67(p2, blocks)
        pk = (s1, s2, refine, lam, mb, m1, p1, p2)
        picked = rc.rough_pick(*pk)
        if not same(picked, rc.rough_pick_plain(*pk)):
            return fail(f"rough_pick {w}x{h}")
        _bm, _sb, extra, pred = picked
        r_args = (refs, blocks, cs.QP, lam, ft["wts"], mb, tabs, 8, m1)
        if not same(rc.rough_refine(*r_args), rc.rough_refine_plain(*r_args)):
            return fail(f"rough_refine {w}x{h}")
        k6 = (pred, blocks, cs.QP, lam, ft["wts"], extra, tabs, 8, True)
        shape = dict(B=B, w=w, h=h, H_=H, W_=W)
        rs = cs.ref_samples(reads[(w, h)], refine)
        cls = f"{w}x{h} B={B}"
        time_it(f"rough_select {cls}",
                lambda s1=s1: rc.rough_select(s1, lam, mb, m1),
                dict(name="rough_select", **shape))
        time_it(f"rough_pick {cls}", lambda pk=pk: rc.rough_pick(*pk),
                dict(name="rough_pick", **shape))
        time_it(f"rough_refine {cls}",
                lambda r_args=r_args: rc.rough_refine(*r_args),
                dict(name="rough_refine", ref_samples=rs, **shape))
        time_it(f"predict67 M=35 {cls}",
                lambda refs=refs, tabs=tabs: ib.predict67(refs, tabs, m1),
                dict(name="predict67", M=35, **shape))
        time_it(f"satd67 M=35 {cls}",
                lambda p1=p1, blocks=blocks: ib.satd67(p1, blocks),
                dict(name="satd67", M=35, **shape))
        time_it(f"predict_modes {cls}",
                lambda refs=refs, refine=refine, tabs=tabs:
                ib.predict_modes(refs, refine, tabs),
                dict(name="predict_modes", R=4, ref_samples=rs, **shape))
        time_it(f"satd67 M=4 {cls}",
                lambda p2=p2, blocks=blocks: ib.satd67(p2, blocks),
                dict(name="satd67", M=4, **shape))
        time_it(f"rd_cost_pred {cls}",
                lambda k6=k6: rc.rd_cost_pred(*k6),
                dict(name="rd_cost_pred", **shape))
        del refs, blocks, p1, p2, s1, s2, refine, pk, picked, pred, k6
        del r_args

    # --- K13 and K14, the all-intra classes ---------------------------------
    cfg = cs.bench_config(Config)
    ctrl = EncoderControl(cfg)
    entries = SliceEncoder(cfg, ctrl, device=dev)._fused_entries(
        PartitionSearch(ctrl, cfg, qp=cs.QP))
    for (_k, w, h, _positions, _g) in entries:
        hh, ww = H // h * h, W // w * w
        x = (f0[:hh, :ww].reshape(hh // h, h, ww // w, w).transpose(1, 2)
             .reshape(-1, h, w).contiguous() - 128)
        c = tr.fwd_batch(x, DCT2, DCT2, 8)
        lv = qu.quant_batch(c, cs.QP, 8)
        dq = qu.dequant_batch(lv, cs.QP, 8)
        for name, kern, plain in (
                ("fwd_transform", lambda x=x: tr.fwd_batch(x, DCT2, DCT2, 8),
                 lambda x=x: tr.fwd_batch_plain(x, DCT2, DCT2, 8)),
                ("inv_transform",
                 lambda dq=dq: tr.inv_batch(dq, DCT2, DCT2, 8),
                 lambda dq=dq: tr.inv_batch_plain(dq, DCT2, DCT2, 8)),
                ("quant_levels", lambda c=c: qu.quant_batch(c, cs.QP, 8),
                 lambda c=c: qu.quant_batch_plain(c, cs.QP, 8)),
                ("dequant_levels",
                 lambda lv=lv: qu.dequant_batch(lv, cs.QP, 8),
                 lambda lv=lv: qu.dequant_batch_plain(lv, cs.QP, 8))):
            if not same(kern(), plain()):
                return fail(f"{name} {w}x{h}")
            time_it(f"{name} {w}x{h} B={x.shape[0]}", kern,
                    dict(name=name, B=x.shape[0], w=w, h=h, H_=H, W_=W))
        del x, c, lv, dq
    torch.cuda.synchronize()

    for name, (g_ms, e_ms) in out.items():
        bd_ = bounds.get(name)
        print(f"  {name}: {g_ms:.4f} ms device (graph), {e_ms:.4f} ms events"
              + ("" if bd_ is None else f", bound {bd_:.5f} ms"), flush=True)
    for prefix in ("rough_select ", "rough_pick ", "rough_refine ",
                   "predict67 M=35 ", "satd67 M=35 ", "predict_modes ",
                   "satd67 M=4 ", "rd_cost_pred ", "fwd_transform ",
                   "inv_transform ", "quant_levels ", "dequant_levels "):
        names = [n for n in out if n.startswith(prefix)]
        print(f"  {prefix}a frame: {sum(out[n][0] for n in names):.4f} ms "
              f"device (graph), {sum(out[n][1] for n in names):.4f} ms "
              f"events, bound {sum(bounds[n] for n in names):.5f} ms",
              flush=True)
    print(json.dumps({n: {"device_ms": v[0], "event_ms": v[1],
                          "bound_ms": bounds.get(n)}
                      for n, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
