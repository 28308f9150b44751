#!/usr/bin/env python3
"""Why the 1920x1080 10-bit LD P frame differs between the packages.

    python3 tools/k9a_rounding.py [--write-vector]

Encodes chip_smoke.py phase 12's "1080p ld10 q27" clip (2 frames, I P)
through the port on the CPU, records each call of the P frame's per-class
inter search (SliceEncoder.search_inter_blocks: the 16x16 and 8x8 classes)
and replays it through the JAX package on the CPU:

- the full-pel search alone (K9a against the reference's
  make_fullpel_search_fn on the same windows): how many blocks take
  another MV, and for those whose exact integer cost (SSD plus the
  penalty) is lower;
- the whole per-class search (K9a, K9b, the mvd bits, K6): how many MVs
  differ, and on the blocks with equal MVs the largest relative
  difference of the float32 RD costs.

--write-vector saves the first four blocks of each class whose full-pel
MVs differ (their 2r+16 windows, blocks and positions) to
tests/vectors/k9a_10bit_1080p.npz, which
tests/test_torch_e2e_sizes.py::test_reference_fullpel_costs_round_apart_at_10_bits
reads. About two minutes on 8 cores.
"""
from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

LABEL = "1080p ld10 q27"
VECTOR = os.path.join(ROOT, "tests", "vectors", "k9a_10bit_1080p.npz")


def record_port_calls():
    """The port's search_inter_blocks calls on LABEL's P frame (CPU)."""
    from uvg266_tpu_torch.control import encoder as pe
    calls = []
    orig = pe.SliceEncoder.search_inter_blocks

    def recorded(self, src_y, ref_y, w, h, positions, search_range=16):
        out = orig(self, src_y, ref_y, w, h, positions, search_range)
        calls.append({"src_y": src_y.copy(), "ref_y": ref_y.copy(), "w": w,
                      "h": h, "positions": list(positions),
                      "r": search_range, "qp": self.frame_qp, "out": out})
        return out
    pe.SliceEncoder.search_inter_blocks = recorded
    try:
        cfg = cs.ctc_config(LABEL)
        cs.ctc_encode(cs.port_api("cpu"), cfg,
                      cs.ctc_clip(cfg.width, cfg.height, 2, 10), "encoder")
    finally:
        pe.SliceEncoder.search_inter_blocks = orig
    return calls


def fullpel_both(c):
    """Both packages' full-pel search on call c -> (windows, blocks,
    penalty, reference (mvx, mvy), port (mvx, mvy))."""
    import jax
    import torch

    from uvg266_tpu.control.partition import qp_to_lambda
    from uvg266_tpu.ops.inter import fetch_extended_block
    from uvg266_tpu.ops.me import make_fullpel_search_fn, make_mv_penalty
    from uvg266_tpu_torch.ops.intra_batch import positions_on
    from uvg266_tpu_torch.ops.me import fullpel_search_plain
    from uvg266_tpu_torch.ops.tables import me_penalties
    w, h, r, pos = c["w"], c["h"], c["r"], c["positions"]
    lam = qp_to_lambda(c["qp"], False)
    pen = make_mv_penalty(r, np.sqrt(lam))
    win = np.stack([fetch_extended_block(c["ref_y"], x, y, w, h, r, r, r, r)
                    for x, y in pos]).astype(np.int32)
    blk = np.stack([c["src_y"][y:y + h, x:x + w]
                    for x, y in pos]).astype(np.int32)
    jx, jy, _ = (np.asarray(t) for t in jax.jit(
        make_fullpel_search_fn(w, h, r))(win, blk, pen))
    xs, ys = positions_on([p[0] for p in pos], [p[1] for p in pos], w, h,
                          *c["ref_y"].shape, "cpu")
    px, py, _ = (t.numpy() for t in fullpel_search_plain(
        torch.from_numpy(c["ref_y"].astype(np.int32)), torch.from_numpy(blk),
        xs, ys, r, me_penalties(lam, r, "cpu")[0]))
    return win, blk, pen, (jx, jy), (px, py)


def exact_cost(win, blk, pen, r, dx, dy):
    h, w = blk.shape
    wv = win[r + dy:r + dy + h, r + dx:r + dx + w].astype(np.int64)
    d = blk.astype(np.int64) - wv
    return float((d * d).sum()) + float(np.float32(pen[dy + r, dx + r]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write-vector", action="store_true")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(os.cpu_count() or 8)
    from uvg266_tpu.control.encoder import SliceEncoder
    from uvg266_tpu.control.params import EncoderControl
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from ctc_digests import jax_config
    calls = record_port_calls()
    rcfg = jax_config(cs.ctc_config(LABEL))
    se = SliceEncoder(rcfg, EncoderControl(rcfg))
    vec = {}
    for c in calls:
        w, r = c["w"], c["r"]
        win, blk, pen, (jx, jy), (px, py) = fullpel_both(c)
        flips = np.nonzero((jx != px) | (jy != py))[0]
        ref_worse = sum(
            exact_cost(win[k], blk[k], pen, r, jx[k], jy[k])
            > exact_cost(win[k], blk[k], pen, r, px[k], py[k])
            for k in flips)
        port_worse = sum(
            exact_cost(win[k], blk[k], pen, r, px[k], py[k])
            > exact_cost(win[k], blk[k], pen, r, jx[k], jy[k])
            for k in flips)
        se.frame_qp = c["qp"]
        descs, costs = se.search_inter_blocks(c["src_y"], c["ref_y"], w,
                                              c["h"], c["positions"], r)
        pdescs, pcosts = c["out"]
        same = [k for k in range(len(descs))
                if descs[k]["mv"] == pdescs[k]["mv"]]
        a = np.asarray(costs, np.float64)[same]
        b = np.asarray(pcosts, np.float64)[same]
        rel = float((np.abs(a - b) / np.maximum(np.abs(a), 1.0)).max())
        print(f"{w}x{c['h']}: {len(c['positions'])} blocks; full-pel MV "
              f"differs on {len(flips)} (exact cost higher for the "
              f"reference's choice on {ref_worse}, the port's on "
              f"{port_worse}); after K9b, {len(descs) - len(same)} MVs "
              f"differ; on the {len(same)} equal MVs the RD costs differ on "
              f"{int((a != b).sum())}, at most {rel:.3g} relative",
              flush=True)
        pick = flips[:4]
        vec[f"win{w}"] = win[pick].astype(np.int16)
        vec[f"blk{w}"] = blk[pick].astype(np.int16)
        vec[f"pos{w}"] = np.array([c["positions"][k] for k in pick],
                                  np.int32)
    if args.write_vector:
        np.savez_compressed(VECTOR, **vec)
        print(f"wrote {VECTOR}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
