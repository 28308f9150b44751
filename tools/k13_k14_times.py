#!/usr/bin/env python3
"""Device times of the port's K13 (fwd_transform, inv_transform) and K14
(quant_levels, dequant_levels) on an NVIDIA card, so that two checkouts'
sources can be compared in one call.

    python3 tools/k13_k14_times.py [--root DIR]

Imports uvg266_tpu_torch from DIR (default: this checkout), builds
transform.cu and quant.cu and times, on chip_smoke.py's synthetic clip
(frame 0, 8 bits, QP22, DCT2), at the four all-intra classes of 832x480
(64x64 B=91, 32x32 B=390, 16x16 B=1560, 8x8 B=6240; their sum is "a
frame"), each device time one call's share of 20 calls captured in a CUDA
graph and replayed:

  entry    each C entry alone, on the round trip's data: fwd_transform on
           the frame's residuals (int32), quant_levels on its coefficients
           (int16 where the checkout's entry reads them in place; a
           checkout whose entry takes int32 gets them converted outside the
           graph), dequant_levels on the levels, inv_transform on the
           dequantised coefficients;
  wrapper  fwd_batch, quant_batch, dequant_batch and inv_batch on the same
           inputs (quant_batch on the int16 coefficients): what a caller
           pays, any conversion a wrapper launches included;
  convert  the int16 coefficients' .to(torch.int32) alone;
  mts      the two transform entries at the four DST7 / DCT8 pairs, at the
           classes up to 32x32;
  floor    one 1-element add_: the launch floor.

Every output is held against its plain version (the C entries against the
wrappers') first. Prints the card and its power limit, one line per kernel
and class with its bound (chip_smoke.py work(), this checkout's count), the
sums a frame, and a JSON line of the times in ms.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TR_NAMES = {0: "DCT2", 1: "DCT8", 2: "DST7"}     # ops/tr_matrices.py


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose uvg266_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.root))
    from uvg266_tpu_torch import kernels
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import SliceEncoder
    from uvg266_tpu_torch.control.params import EncoderControl
    from uvg266_tpu_torch.control.partition import PartitionSearch
    from uvg266_tpu_torch.ops import quant as qu
    from uvg266_tpu_torch.ops import transforms as tr
    from uvg266_tpu_torch.ops import tr_matrices as tm
    from uvg266_tpu_torch.ops.tr_matrices import DCT2, DCT8, DST7

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(kernels.CSRC)}", flush=True)
    kernels.build(["fwd_transform", "quant_levels"])
    # the C entries' forms: this design's (the transform types, int32
    # matrices, the quantisers' element size) or the earlier one's
    new = len(kernels.SIGNATURES["fwd_transform"]) == 14
    print(f"entry form: {'int32 matrices, int16 levels' if new else 'int8 matrices, int32 levels'}",
          flush=True)
    dev = torch.device("cuda")
    H, W = cs.H, cs.W
    f0 = torch.from_numpy(cs.synth_clip(W, H, 1)[0][0]).to(dev)
    out, bounds = {}, {}

    def fail(what):
        print(f"FAIL: {what} differs", flush=True)
        return 1

    def time_it(label, fn, wk=None):
        out[label] = cs.graph_ms(torch, fn, 20)
        if wk is not None:
            b, o = cs.work(**wk)
            bounds[label] = max(b / cs.HBM_BYTES_PER_S,
                                o / cs.OPS_PER_S) * 1e3

    def mats(th, tv, w, h, inverse):
        if new:
            return (th, tv, tm.device_matrix32(th, w, "cuda", inverse).data_ptr(),
                    tm.device_matrix32(tv, h, "cuda", inverse).data_ptr())
        return (tm.device_matrix(th, w, "cuda").data_ptr(),
                tm.device_matrix(tv, h, "cuda").data_ptr())

    def fwd_entry(x, w, h, th, tv, o):
        s1, s2 = tr.fwd_shifts(w, h, 8)
        kw, kh = tr.zero_out(w, th, tv, h)
        kernels.launch("fwd_transform", dev, x.data_ptr(), x.shape[0], w, h,
                       *mats(th, tv, w, h, False), s1, s2, kw, kh,
                       o.data_ptr())

    def inv_entry(c, w, h, th, tv, o):
        s1, s2 = tr.inv_shifts(8)
        kernels.launch("inv_transform", dev, c.data_ptr(), c.shape[0], w, h,
                       *mats(th, tv, w, h, True), s1, s2, o.data_ptr())

    def level_entry(name, x, consts, o):
        kernels.launch(name, dev, x.data_ptr(), x.numel(),
                       *((x.element_size(),) if new else ()), *consts,
                       o.data_ptr())

    cs.warm_up(torch)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    time_it("floor add_ 1 element", lambda: one.add_(1))

    cfg = cs.bench_config(Config)
    ctrl = EncoderControl(cfg)
    entries = SliceEncoder(cfg, ctrl, device=dev)._fused_entries(
        PartitionSearch(ctrl, cfg, qp=cs.QP))
    for (_k, w, h, _positions, _g) in entries:
        hh, ww = H // h * h, W // w * w
        x = (f0[:hh, :ww].reshape(hh // h, h, ww // w, w).transpose(1, 2)
             .reshape(-1, h, w).contiguous() - 128)
        B = x.shape[0]
        c = tr.fwd_batch(x, DCT2, DCT2, 8)
        lv = qu.quant_batch(c, cs.QP, 8)
        dq = qu.dequant_batch(lv, cs.QP, 8)
        rec = tr.inv_batch(dq, DCT2, DCT2, 8)
        for name, got, want in (
                ("fwd_batch", c, tr.fwd_batch_plain(x, DCT2, DCT2, 8)),
                ("quant_batch", lv, qu.quant_batch_plain(c, cs.QP, 8)),
                ("dequant_batch", dq, qu.dequant_batch_plain(lv, cs.QP, 8)),
                ("inv_batch", rec, tr.inv_batch_plain(dq, DCT2, DCT2, 8))):
            if got.dtype != want.dtype or not torch.equal(got, want):
                return fail(f"{name} {w}x{h} against its plain version")
        cq = c if new else c.to(torch.int32)
        qc = qu.quant_batch_consts(w, h, 8, True, cs.QP)
        dc = qu.dequant_batch_consts(w, h, 8, cs.QP)
        o16, o32 = torch.empty_like(c), torch.empty_like(lv)
        shape = dict(B=B, w=w, h=h, H_=H, W_=W)
        cls = f"{w}x{h} B={B}"
        calls = (
            ("fwd_transform", lambda x=x, o=o16: fwd_entry(x, w, h, DCT2, DCT2, o),
             o16, c, dict(name="fwd_transform", **shape)),
            ("quant_levels", lambda cq=cq, o=o32: level_entry("quant_levels", cq, qc, o),
             o32, lv, dict(name="quant_levels", in_bytes=cq.element_size(), **shape)),
            ("dequant_levels", lambda lv=lv, o=o32: level_entry("dequant_levels", lv, dc, o),
             o32, dq, dict(name="dequant_levels", **shape)),
            ("inv_transform", lambda dq=dq, o=o16: inv_entry(dq, w, h, DCT2, DCT2, o),
             o16, rec, dict(name="inv_transform", **shape)))
        for name, call, got, want, wk in calls:
            call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                return fail(f"{name} {w}x{h} C entry against the wrapper")
            time_it(f"entry {name} {cls}", call, wk)
        time_it(f"wrapper fwd_batch {cls}",
                lambda x=x: tr.fwd_batch(x, DCT2, DCT2, 8))
        time_it(f"wrapper quant_batch {cls}",
                lambda c=c: qu.quant_batch(c, cs.QP, 8))
        time_it(f"wrapper dequant_batch {cls}",
                lambda lv=lv: qu.dequant_batch(lv, cs.QP, 8))
        time_it(f"wrapper inv_batch {cls}",
                lambda dq=dq: tr.inv_batch(dq, DCT2, DCT2, 8))
        time_it(f"convert int16 to int32 {cls}", lambda c=c: c.to(torch.int32))
        if max(w, h) <= 32:
            for th, tv in ((DST7, DST7), (DCT8, DST7), (DST7, DCT8),
                           (DCT8, DCT8)):
                cm = tr.fwd_batch(x, th, tv, 8)
                ci = torch.cat([cm[: B // 2].to(torch.int32),
                                x[B // 2:] * 16])
                ri = tr.inv_batch(ci, th, tv, 8)
                if not (torch.equal(cm, tr.fwd_batch_plain(x, th, tv, 8)) and
                        torch.equal(ri, tr.inv_batch_plain(ci, th, tv, 8))):
                    return fail(f"MTS {th}/{tv} {w}x{h} against the plain "
                                "versions")
                pair = f"{TR_NAMES[th]}/{TR_NAMES[tv]}"
                time_it(f"mts fwd_transform {pair} {cls}",
                        lambda x=x, th=th, tv=tv, o=o16:
                        fwd_entry(x, w, h, th, tv, o),
                        dict(name="fwd_transform", **shape))
                time_it(f"mts inv_transform {pair} {cls}",
                        lambda ci=ci, th=th, tv=tv, o=o16:
                        inv_entry(ci, w, h, th, tv, o),
                        dict(name="inv_transform", **shape))
        del x, c, lv, dq, rec, cq, o16, o32
    torch.cuda.synchronize()

    for label, ms in out.items():
        bd_ = bounds.get(label)
        print(f"  {label}: {ms:.4f} ms device (graph)"
              + ("" if bd_ is None else f", bound {bd_:.5f} ms"), flush=True)
    prefixes = [f"entry {n} " for n in ("fwd_transform", "quant_levels",
                                         "dequant_levels", "inv_transform")]
    prefixes += [f"wrapper {n} " for n in ("fwd_batch", "quant_batch",
                                           "dequant_batch", "inv_batch")]
    prefixes += ["convert int16 to int32 "]
    for prefix in prefixes:
        names = [n for n in out if n.startswith(prefix)]
        bsum = (f", bound {sum(bounds[n] for n in names):.5f} ms"
                if all(n in bounds for n in names) else "")
        print(f"  {prefix}a frame: {sum(out[n] for n in names):.4f} ms "
              f"device (graph){bsum}", flush=True)
    print(json.dumps({n: {"device_ms": v, "bound_ms": bounds.get(n)}
                      for n, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
