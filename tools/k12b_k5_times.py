#!/usr/bin/env python3
"""Device times of the port's K12b predict_modes, K5 pseudo_recon, the two
K12c selection stages and K2 predict67 on an NVIDIA card, so that two
checkouts' sources can be compared in one call.

    python3 tools/k12b_k5_times.py [--root DIR]

Imports uvg266_tpu_torch from DIR (default: this checkout), builds the
sources it runs and times, on chip_smoke.py's synthetic clip:

  K12b  the rough path's classes (search_classes of rough_config, 832x480)
        at R = 4 on the refine lists of K12c stage 1 at QP22, 8 bits, frame
        0 (their sum is "a frame").
  K12c  stage 1 (rough_select: the refine lists from the 35 stage-1 SATDs)
        and stage 2 (rough_pick: the winner of the 39 costs and its
        prediction) on the same classes.
  K5    the 832x480 plane of the LD path at qp_scaled 27, 8 bits (frame
        0), and the clip at 1920x1088 at 8 bits (qp_scaled 27) and at 10
        bits (the samples times 4, qp_scaled 39).
  floor one 1-element add_ replayed in the same kind of graph: the card's
        launch floor, which K5's time at 832x480 is read against.
  K2    the four all-intra classes (67 modes; their sum is "a frame") and
        the rough path's classes at the 35 stage-1 modes.

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
    from uvg266_tpu_torch.ops import pseudo_recon as pr
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops.tables import (device_tables, frame_tables,
                                             rough_modes)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(kernels.CSRC)}", flush=True)
    kernels.build(["predict_modes", "pseudo_recon", "rough_refine",
                   "predict67", "satd67", "refs_blocks_grid"])
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

    # --- K12b, K12c's selections and K2 at 35 modes, the rough classes -------
    rcfg = cs.rough_config(Config)
    ft = frame_tables(cs.QP, "cuda")
    lam = float(np.float32(qp_to_lambda(cs.QP)))
    m1 = rough_modes("cuda")
    for (w, h, pos) in cs.search_classes(PartitionSearch(EncoderControl(rcfg),
                                                         rcfg, qp=cs.QP)):
        B = len(pos)
        xs = np.array([p[0] for p in pos], dtype=np.int32)
        ys = np.array([p[1] for p in pos], dtype=np.int32)
        tabs = device_tables(w, h, 8, "cuda")
        refs, blocks = ib.refs_blocks(f0, xs, ys, w, h)
        p1 = ib.predict67(refs, tabs, m1)
        if not same(p1, ib.predict67_plain(refs, tabs, m1)):
            return fail(f"predict67 M=35 {w}x{h}")
        s1 = ib.satd67(p1, blocks)
        refine = rc.rough_select(s1, lam, ft["mode_bits"], m1)
        if not same(refine, rc.rough_select_plain(s1, lam, ft["mode_bits"],
                                                  m1)):
            return fail(f"rough_select {w}x{h}")
        p2 = ib.predict_modes(refs, refine, tabs)
        if not same(p2, ib.predict_modes_plain(refs, refine, tabs)):
            return fail(f"predict_modes {w}x{h}")
        s2 = ib.satd67(p2, blocks)
        pk = (s1, s2, refine, lam, ft["mode_bits"], m1, p1, p2)
        if not same(rc.rough_pick(*pk), rc.rough_pick_plain(*pk)):
            return fail(f"rough_pick {w}x{h}")
        shape = dict(B=B, w=w, h=h, H_=H, W_=W)
        time_it(f"predict_modes {w}x{h} B={B}",
                lambda refs=refs, refine=refine, tabs=tabs:
                ib.predict_modes(refs, refine, tabs),
                dict(name="predict_modes", R=4,
                     ref_samples=cs.ref_samples(reads[(w, h)], refine),
                     **shape))
        time_it(f"rough_select {w}x{h} B={B}",
                lambda s1=s1: rc.rough_select(s1, lam, ft["mode_bits"], m1),
                dict(name="rough_select", **shape))
        time_it(f"rough_pick {w}x{h} B={B}",
                lambda pk=pk: rc.rough_pick(*pk),
                dict(name="rough_pick", **shape))
        time_it(f"predict67 M=35 {w}x{h} B={B}",
                lambda refs=refs, tabs=tabs: ib.predict67(refs, tabs, m1),
                dict(name="predict67", M=35, **shape))
        del refs, blocks, p1, p2, s1, s2, refine, pk

    # --- K2 at 67 modes, the all-intra classes -------------------------------
    cfg = cs.bench_config(Config)
    ctrl = EncoderControl(cfg)
    entries = SliceEncoder(cfg, ctrl, device=dev)._fused_entries(
        PartitionSearch(ctrl, cfg, qp=cs.QP))
    for (_k, w, h, _positions, g) in entries:
        B = g[4] * g[5]
        tabs = device_tables(w, h, 8, "cuda")
        refs, _blocks = ib.refs_blocks_grid(f0, w, h, g)
        if not same(ib.predict67(refs, tabs), ib.predict67_plain(refs, tabs)):
            return fail(f"predict67 {w}x{h}")
        time_it(f"predict67 {w}x{h} B={B}",
                lambda refs=refs, tabs=tabs: ib.predict67(refs, tabs),
                dict(name="predict67", B=B, w=w, h=h, H_=H, W_=W))
        del refs, _blocks

    # --- K5 -----------------------------------------------------------------
    big = torch.from_numpy(cs.synth_clip(1920, 1088, 1)[0][0]).to(dev)
    for tag, plane, qps, bd in (("832x480 8-bit", f0, cs.LD_QP, 8),
                                ("1920x1088 8-bit", big, cs.LD_QP, 8),
                                ("1920x1088 10-bit", big * 4, cs.LD_QP + 12,
                                 10)):
        plane = plane.contiguous()
        if not same(pr.pseudo_recon(plane, qps, bd),
                    pr.pseudo_recon_plain(plane, qps, bd)):
            return fail(f"pseudo_recon {tag}")
        Hp, Wp = plane.shape
        time_it(f"pseudo_recon {tag}",
                lambda plane=plane, qps=qps, bd=bd:
                pr.pseudo_recon(plane, qps, bd),
                dict(name="pseudo_recon", B=0, w=16, h=16, H_=Hp, W_=Wp))
    torch.cuda.synchronize()

    for name, (g_ms, e_ms) in out.items():
        bd_ = bounds.get(name)
        print(f"  {name}: {g_ms:.4f} ms device (graph), {e_ms:.4f} ms events"
              + ("" if bd_ is None else f", bound {bd_:.5f} ms"), flush=True)
    sums = {"predict_modes a frame": "predict_modes ",
            "rough_select a frame": "rough_select ",
            "rough_pick a frame": "rough_pick ",
            "predict67 M=35 a frame": "predict67 M=35 ",
            "predict67 a frame": "predict67 "}
    for label, prefix in sums.items():
        names = [n for n in out if n.startswith(prefix)
                 and not (prefix == "predict67 " and "M=35" in n)]
        print(f"  {label}: {sum(out[n][0] for n in names):.4f} ms device "
              f"(graph), {sum(out[n][1] for n in names):.4f} ms events, bound "
              f"{sum(bounds[n] for n in names):.5f} ms", flush=True)
    print(json.dumps({n: {"device_ms": v[0], "event_ms": v[1],
                          "bound_ms": bounds.get(n)}
                      for n, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
