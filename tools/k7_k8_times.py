#!/usr/bin/env python3
"""Device times of the port's K7 frame_inter and K8 leaf_qpel by pass on an
NVIDIA card, so that two checkouts' sources can be compared in one call.

    python3 tools/k7_k8_times.py [--root DIR]

Imports uvg266_tpu_torch from DIR (default: this checkout), builds its two
sources and times, on chip_smoke.py's phase 4 inputs (its synthetic clip,
832x480, 8 bits):

  K7  frame 1 against frame 0, r = 16, the dense path's inter classes
      (32x32, 16x16, 8x8): the whole call through its wrapper, and the
      tile pass alone (its C entry with no class); the class pass is the
      difference. Beside them the reference's own formulation of the tile
      pass as a PyTorch chain (chip_smoke.k7_library: grouped conv2d,
      conv2d, b^2, b^2 - 2 corr + r^2 in float32, TF32 off), with its
      largest difference from the kernel's map.
  K8  the 16x16 set (6240 tiles, 1560 leaves) and the 64x64 set (6240
      tiles, 91 leaves): the whole call through its wrapper, and the tile
      pass alone (its C entry with no leaf); the segment pass is the
      difference.

Each device time is one call's share of 20 calls captured in a CUDA graph
and replayed, beside CUDA events over 20 calls from the host. Both
wrappers' outputs are held against the plain versions first. Prints the
card and its power limit, one line per kernel and pass, and a JSON line of
the times in ms.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

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
    from uvg266_tpu_torch.control.partition import PartitionSearch
    from uvg266_tpu_torch.ops import me_frame as mf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(kernels.CSRC)}", flush=True)
    kernels.build(["frame_inter", "leaf_qpel"])
    dev = torch.device("cuda")
    frames = cs.synth_clip(cs.W, cs.H, 2)
    H, W, R = cs.H, cs.W, cs.R
    dcfg = cs.dense_config(Config)
    dctrl = EncoderControl(dcfg)
    probe = SliceEncoder(dcfg, dctrl, device=dev)
    iclasses = cs.inter_classes(probe, probe._fused_entries(
        PartitionSearch(dctrl, dcfg, qp=cs.LD_QP)))
    cur, ref_pad, pen, bits_tab = cs.k7_inputs(torch, frames, dev)
    out = {}

    def k7():
        return mf.frame_inter(cur, ref_pad, pen, bits_tab, iclasses, R)
    found = k7()
    for got_c, want_c in zip(found, mf.frame_inter_plain(
            cur, ref_pad, pen, bits_tab, iclasses, R)):
        if not all(torch.equal(a, b) for a, b in zip(got_c, want_c)):
            print("FAIL: frame_inter differs from its plain version")
            return 1
    nn = 2 * R + 1
    ssd = torch.empty(((H // 8) * (W // 8), nn * nn), dtype=torch.int32,
                      device=dev)

    def k7_tile():
        cs.k7_tile_pass(kernels, cur, ref_pad, R, pen, bits_tab, ssd)
    chain = cs.k7_library(torch, cur, ref_pad, R)
    k7_tile()
    lib_d = (chain().double().reshape(ssd.shape) - ssd.double()).abs().max()
    out["frame_inter whole"] = (cs.graph_ms(torch, k7, 20),
                                cs.time_ms(torch, k7, 20))
    out["frame_inter tile"] = (cs.graph_ms(torch, k7_tile, 20),
                               cs.time_ms(torch, k7_tile, 20))
    out["frame_inter library chain"] = (None, cs.time_ms(torch, chain, 20))
    del ssd, chain

    pen49 = cs.k8_pen(torch, dev)
    idx32 = {(w, h): (g, f[0]) for (w, h, g), f in zip(iclasses, found)}
    leaves = cs.k8_leaves(idx32.get((32, 32)))
    for s in (16, 64):
        wins, blks, ids, nl = cs.k8_tiles(torch, leaves[s], frames[0][0],
                                          frames[1][0], dev)
        nt = wins.shape[0]
        a = (wins, blks, ids, nl, pen49, 8)
        if not all(torch.equal(x, y) for x, y in zip(mf.leaf_qpel(*a),
                                                     mf.leaf_qpel_plain(*a))):
            print(f"FAIL: leaf_qpel {s}x{s} differs from its plain version")
            return 1
        satd = torch.empty((nt, 49), dtype=torch.int32, device=dev)
        tag = f"leaf_qpel {s}x{s} ({nt} tiles, {nl} leaves)"
        out[f"{tag} whole"] = (cs.graph_ms(torch, lambda: mf.leaf_qpel(*a),
                                           20),
                               cs.time_ms(torch, lambda: mf.leaf_qpel(*a),
                                          20))

        def k8_tile():
            cs.k8_tile_pass(kernels, wins, blks, ids, pen49, 8, satd)
        out[f"{tag} tile"] = (cs.graph_ms(torch, k8_tile, 20),
                              cs.time_ms(torch, k8_tile, 20))
    torch.cuda.synchronize()
    for name, (g_ms, e_ms) in out.items():
        dev_s = "" if g_ms is None else f"{g_ms:.4f} ms device (graph), "
        print(f"  {name}: {dev_s}{e_ms:.4f} ms events", flush=True)
    for name in [n for n in out if n.endswith(" whole")]:
        base = name[:-len(" whole")]
        rest = "class" if base == "frame_inter" else "segment"
        print(f"  {base} {rest} pass: "
              f"{out[name][0] - out[base + ' tile'][0]:.4f} ms device "
              "(whole - tile)", flush=True)
    print(f"  frame_inter library chain: largest |chain - tile map| "
          f"{lib_d.item():.1f}", flush=True)
    print(json.dumps({n: {"device_ms": v[0], "event_ms": v[1]}
                      for n, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
