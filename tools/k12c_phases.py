#!/usr/bin/env python3
"""Split the port's K12c selection stages (csrc/rough_refine.cu) by phase,
on an NVIDIA card.

    python3 tools/k12c_phases.py

Builds edited copies of uvg266_tpu_torch/csrc/rough_refine.cu with nvcc
(the package's flags) into a temporary directory and times each through
its C entry on a CUDA graph of 20 calls, at the rough path's classes of an
832x480 frame (chip_smoke.py's clip, frame 0, 8 bits, QP22: the stage-1
SATDs of K2 and K3, stage 1's refine lists, K12b's and K3's refine SATDs):

  stage 1  base; ballot (the warp argmin as a shuffle tree of the cost
           alone, fminf, then the first index holding it from two
           __ballot_sync, in place of the tree on the key (cost, index));
           redux (two __reduce_min_sync on an order-preserving key of the
           cost, then the index); no_pen (the penalties 0: no load of m1
           or the mode bits); one_argmin (no second reduction: i2 = i1);
           no_argmin (no reduction: lane 0's own slots).
  stage 2  base; ballot; redux; no_copy (the scan and the three values
           only); no_scan (k = 0 without the scan: the loads of the costs,
           the copy); beside them a copy_ of the winner's bytes (B*h*w
           int32, PyTorch's copy of the same bytes).

Variants that compute the function (base, ballot, redux) are held against
the plain versions. An edit that no longer matches the source
fails the script. Prints the card and its power limit, then one line per
class and variant in ms, and each variant's sum over the classes.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from uvg266_tpu_torch import kernels  # noqa: E402

ARGMIN = ("""#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float oc = __shfl_xor_sync(FULL, c, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (oc < c || (oc == c && oi < i)) {
      c = oc;
      i = oi;
    }
  }""", """  const unsigned u = __float_as_uint(c);
  const unsigned key = u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31)
                            | 0x80000000u);
  const unsigned m = __reduce_min_sync(FULL, key);
  i = __reduce_min_sync(FULL, key == m ? i : NONE);
  c = __uint_as_float((m & 0x80000000u) ? (m ^ 0x80000000u) : ~m);""")
BALLOT = (ARGMIN[0], """  float mc = c;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    mc = fminf(mc, __shfl_xor_sync(FULL, mc, o));
  const unsigned lo = __ballot_sync(FULL, c == mc && i < 32);
  const unsigned hi = __ballot_sync(FULL, c == mc && i >= 32);
  i = lo ? __ffs(lo) - 1 : 31 + __ffs(hi);
  c = mc;""")
STAGE1 = {
    "base": [],
    "ballot": [BALLOT],
    "redux": [ARGMIN],
    "no_pen": [("  const float pa = v0 ? __fmul_rn(ls, mode_bits[m1[j0]]) : 0.f;\n"
                "  const float pb = v1 ? __fmul_rn(ls, mode_bits[m1[j1]]) : 0.f;",
                "  const float pa = 0.f, pb = 0.f;")],
    "one_argmin": [("  lane_min(ca, ia, cb, ib, c, i2);\n  warp_argmin(c, i2);",
                    "  i2 = i1;")],
    "no_argmin": [("  warp_argmin(c, i1);", ""),
                  ("  lane_min(ca, ia, cb, ib, c, i2);\n  warp_argmin(c, i2);",
                   "  i2 = i1;")],
}
STAGE2 = {
    "base": [],
    "ballot": [BALLOT],
    "redux": [ARGMIN],
    "no_copy": [("  for (int t = 0; t < G::IT; ++t)\n"
                 "    if (q0 + t * G::STEP < G::Q) dst[q0 + t * G::STEP] = w[t];",
                 "  for (int t = 0; t < 0; ++t)\n"
                 "    if (q0 + t * G::STEP < G::Q) dst[q0 + t * G::STEP] = w[t];")],
    "no_scan": [("  warp_argmin(ck, k);", "  k = 0;")],
}
FUNCTION = ("base", "ballot", "redux")


def build(tmp, variants, tag):
    with open(os.path.join(kernels.CSRC, "rough_refine.cu")) as fh:
        src = fh.read()
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, edits in variants.items():
        s = src
        for a, b in edits:
            if a not in s:
                sys.exit(f"rough_refine variant {name}: the source no longer "
                         f"holds {a!r}")
            s = s.replace(a, b)
        path = os.path.join(tmp, f"rough_refine_{tag}_{name}.cu")
        with open(path, "w") as fh:
            fh.write(s)
        out = path[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *flags, "-I", kernels.CSRC, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"rough_refine variant {name}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(out), "rough_refine")
        fn.argtypes = kernels.SIGNATURES["rough_refine"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.params import EncoderControl
    from uvg266_tpu_torch.control.partition import (PartitionSearch,
                                                    qp_to_lambda)
    from uvg266_tpu_torch.ops import intra_batch as ib
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops.tables import (device_tables, frame_tables,
                                             rough_modes)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    f0 = torch.from_numpy(cs.synth_clip(cs.W, cs.H, 1)[0][0]).to(dev)

    def check(name, rc_):
        if rc_:
            raise RuntimeError(f"{name}: error {rc_}")

    sums = {}
    with tempfile.TemporaryDirectory() as tmp:
        st1 = build(tmp, STAGE1, "s1")
        st2 = build(tmp, STAGE2, "s2")
        cs.warm_up(torch)
        rcfg = cs.rough_config(Config)
        mb = frame_tables(cs.QP, "cuda")["mode_bits"]
        lam = float(np.float32(qp_to_lambda(cs.QP)))
        m1 = rough_modes("cuda")
        for (w, h, pos) in cs.search_classes(
                PartitionSearch(EncoderControl(rcfg), rcfg, qp=cs.QP)):
            B = len(pos)
            xs = np.array([p[0] for p in pos], dtype=np.int32)
            ys = np.array([p[1] for p in pos], dtype=np.int32)
            tabs = device_tables(w, h, 8, "cuda")
            refs, blocks = ib.refs_blocks(f0, xs, ys, w, h)
            p1 = ib.predict67(refs, tabs, m1)
            s1 = ib.satd67(p1, blocks)
            want1 = rc.rough_select_plain(s1, lam, mb, m1)
            p2 = ib.predict_modes(refs, want1, tabs)
            s2 = ib.satd67(p2, blocks)
            want2 = rc.rough_pick_plain(s1, s2, want1, lam, mb, m1, p1, p2)
            refine = torch.empty_like(want1)
            outs = [torch.empty_like(t) for t in want2]
            ptr = [t.data_ptr() for t in outs]
            for stage, fns, want, got in ((1, st1, (want1,), (refine,)),
                                          (2, st2, want2, outs)):
                for name, fn in fns.items():
                    def call(fn=fn, name=name, stage=stage):
                        check(name, fn(
                            stage, B, 35, h * w, lam, s1.data_ptr(),
                            s2.data_ptr(), refine.data_ptr() if stage == 1
                            else want1.data_ptr(), mb.data_ptr(),
                            m1.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                            *ptr, torch.cuda.current_stream().cuda_stream))
                    call()
                    torch.cuda.synchronize()
                    tag = ("" if name not in FUNCTION else " (equal)"
                           if all(torch.equal(a, b) for a, b in
                                  zip(got, want)) else " (DIFFERS)")
                    ms = cs.graph_ms(torch, call, 20)
                    key = f"stage {stage} {name}"
                    sums[key] = sums.get(key, 0.0) + ms
                    print(f"{key} {w}x{h} B={B}: {ms:.4f} ms{tag}",
                          flush=True)
            src = p1[:, 0]
            ms = cs.graph_ms(torch, lambda: outs[3].copy_(src), 20)
            sums["copy_ of the winner's bytes"] = \
                sums.get("copy_ of the winner's bytes", 0.0) + ms
            print(f"copy_ of the winner's bytes {w}x{h} B={B}: {ms:.4f} ms",
                  flush=True)
            del refs, blocks, p1, s1, p2, s2, outs
    for key, ms in sums.items():
        print(f"{key} a frame: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
