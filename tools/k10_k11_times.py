#!/usr/bin/env python3
"""Per-class device times of the port's K10 mip_preds and K11 mts_search on
an NVIDIA card, so that two checkouts' sources can be compared in one call.

    python3 tools/k10_k11_times.py [--root DIR]

Imports uvg266_tpu_torch from DIR (default: this checkout), builds its
sources and times each kernel at the classes of an 832x480 frame (64x64
B=91, 32x32 B=390, 16x16 B=1560, 8x8 B=6240 on the block grid; K11 up to
32x32) on frame 0 of chip_smoke.py's synthetic clip at 8 bits, QP22: K10
by its C entry (the wrapper copies the positions from the host, which a
CUDA graph cannot capture), K11 through its wrapper on K4's winning
prediction. Each time is one call's share of 20 calls captured in a CUDA
graph and replayed (the device time), beside CUDA events over 20 calls
from the host. Both outputs are held against the plain versions first.
Prints the card and its power limit, one line per kernel and class, and
a JSON line of the times in ms.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, QP = 480, 832, 22
CLASSES = ((64, 64), (32, 32), (16, 16), (8, 8))


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
    from chip_smoke import graph_ms, synth_clip, time_ms
    from uvg266_tpu_torch import kernels
    from uvg266_tpu_torch.control.partition import qp_to_lambda
    from uvg266_tpu_torch.ops import intra_batch as ib
    from uvg266_tpu_torch.ops import mip as mp
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops.tables import (device_mts_tables, device_tables,
                                             frame_tables, mip_matrix)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(kernels.CSRC)}", flush=True)
    kernels.build(["mip_preds", "mts_search", "refs_blocks_grid",
                   "predict67", "satd67", "rd_cost"])
    dev = torch.device("cuda")
    src = torch.from_numpy(synth_clip(W, H, 1)[0][0]).to(dev)
    lam = float(np.float32(qp_to_lambda(QP)))
    ft = frame_tables(QP, "cuda")
    out = {}
    for (w, h) in CLASSES:
        nx, ny = W // w, H // h
        xs = np.tile(np.arange(nx, dtype=np.int32) * w, ny)
        ys = np.repeat(np.arange(ny, dtype=np.int32) * h, nx)
        B = xs.size
        size_id, n_modes, _rb, _rp, _uh, _uv = mp.mip_geometry(w, h)
        mat = mip_matrix(size_id, "cuda")
        want = mp.mip_preds_plain(src, xs, ys, w, h, 8, mat)
        if not torch.equal(mp.mip_preds(src, xs, ys, w, h, 8, mat), want):
            print(f"FAIL: mip_preds {w}x{h} differs from its plain version")
            return 1
        xd, yd = ib.positions_on(xs, ys, w, h, H, W, dev)
        pout = torch.empty_like(want)

        def k10():
            kernels.launch("mip_preds", dev, src.data_ptr(), H, W,
                           xd.data_ptr(), yd.data_ptr(), B, w, h, 8,
                           mat.data_ptr(), pout.data_ptr())
        out[f"mip_preds {w}x{h}"] = (graph_ms(torch, k10, 20),
                                     time_ms(torch, k10, 20))
        if max(w, h) <= 32:
            g = (0, 0, w, h, nx, ny)
            tabs = device_tables(w, h, 8, "cuda")
            refs, blocks = ib.refs_blocks_grid(src, w, h, g)
            preds = ib.predict67(refs, tabs)
            best = rc.rd_cost(preds, blocks, ib.satd67(preds, blocks), QP,
                              lam, ft["wts"], ft["mode_bits"], tabs, 8)[0]
            pred = preds[torch.arange(B, device=dev), best.long()]
            del preds
            t_args = (pred.contiguous(), blocks, QP, lam, ft["wts"],
                      device_mts_tables(w, h, "cuda"), 8)
            for a, b in zip(rc.mts_search(*t_args),
                            rc.mts_search_plain(*t_args)):
                if not torch.equal(a, b):
                    print(f"FAIL: mts_search {w}x{h} differs from its plain "
                          "version")
                    return 1
            out[f"mts_search {w}x{h}"] = (
                graph_ms(torch, lambda: rc.mts_search(*t_args), 20),
                time_ms(torch, lambda: rc.mts_search(*t_args), 20))
        torch.cuda.synchronize()
    for name, (g_ms, e_ms) in out.items():
        print(f"  {name}: {g_ms:.4f} ms device (graph), {e_ms:.4f} ms events",
              flush=True)
    for k in ("mip_preds", "mts_search"):
        tot = sum(v[0] for n, v in out.items() if n.startswith(k))
        print(f"  {k} per frame: {tot:.4f} ms device (graph)", flush=True)
    print(json.dumps({n: {"device_ms": v[0], "event_ms": v[1]}
                      for n, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
