#!/usr/bin/env python3
"""Split the port's K12b predict_modes and K5 pseudo_recon times by phase,
on an NVIDIA card.

    python3 tools/k12b_k5_phases.py

Builds edited copies of uvg266_tpu_torch/csrc/predict_modes.cu and
pseudo_recon.cu with nvcc (the package's flags) into a temporary directory
and times each through its C entry on a CUDA graph of 20 calls:

  K12b at the rough path's classes of an 832x480 frame (chip_smoke.py's
       clip, frame 0, 8 bits, the refine lists of K12c stage 1 at QP22):
       base; no_quad (the output loop stores a constant: the staging, the
       extended references and the stores); no_ext (no extended
       references); no_ext_quad; no_refs (no reference samples staged);
       stores_only (the mode lists read, the stores and the launch);
       out1024 and out4096 (1024 or 4096 output ints a thread block, not
       2048); beside them a zero_ of the output tensor, PyTorch's fill of
       the same bytes.
  K5   at 832x480 and 1920x1088, 8 bits, qp_scaled 27: base; tpb8 (8
       tiles a thread block, not 4); io_only (the loads, the DC and the
       stores, no transform pass).

An edit that no longer matches the source fails the script. Prints the card
and its power limit, then one line per class and variant in ms.
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

QUAD = ("    angular_quad(d[D_SD] < 0 ? ext + su * G::EXT : r + d[D_MAIN], "
        "r, d, cub,\n                 oy, ox, max_pix, v);",
        "    v[0] = v[1] = v[2] = v[3] = su;")
EXT = ("  for (int su = tid >> 5; su < nsu; su += THREADS / 32) {",
       "  for (int su = tid >> 5; su < 0; su += THREADS / 32) {")
REFS = ("  for (int i = tid; i < nb * rc_.nr; i += THREADS) {",
        "  for (int i = tid; i < 0; i += THREADS) {")
OUT = "constexpr int OUT_INTS = 2048;"
K12B = {
    "base": [],
    "no_quad": [QUAD],
    "no_ext": [EXT],
    "no_ext_quad": [EXT, QUAD],
    "no_refs": [REFS],
    "stores_only": [EXT, QUAD, REFS],
    "out1024": [(OUT, "constexpr int OUT_INTS = 1024;")],
    "out4096": [(OUT, "constexpr int OUT_INTS = 4096;")],
}
TPB = "constexpr int TPB = 4;"
K5 = {
    "base": [],
    "tpb8": [(TPB, "constexpr int TPB = 8;")],
    "io_only": [("  __syncthreads();                     // the coefficients\n"
                 "  if (active) {",
                 "  __syncthreads();                     // the coefficients\n"
                 "  if (false) {"),
                ("  if (active) {\n    // column k = y",
                 "  if (false) {\n    // column k = y"),
                ("    load_row(s2 + y * LSW, v);\n"
                 "    uvg::inv_line16(v, cf, 1 << (p.i2 - 1), o);",
                 "#pragma unroll\n"
                 "    for (int x = 0; x < T; ++x) o[x] = v[x];")],
}


def build(tmp, source, entry, variants):
    with open(os.path.join(kernels.CSRC, f"{source}.cu")) as fh:
        src = fh.read()
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, edits in variants.items():
        s = src
        for a, b in edits:
            if a not in s:
                sys.exit(f"{source} variant {name}: the source no longer "
                         f"holds {a!r}")
            s = s.replace(a, b)
        path = os.path.join(tmp, f"{source}_{name}.cu")
        with open(path, "w") as fh:
            fh.write(s)
        out = os.path.join(tmp, f"{source}_{name}.so")
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *flags, "-I", kernels.CSRC, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{source} variant {name}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(out), entry)
        fn.argtypes = kernels.SIGNATURES[entry]
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
    from uvg266_tpu_torch.ops import pseudo_recon as pr
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops.rd_cost import quant_consts
    from uvg266_tpu_torch.ops.tables import (device_tables, frame_tables,
                                             rough_modes)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    H, W = cs.H, cs.W
    f0 = torch.from_numpy(cs.synth_clip(W, H, 1)[0][0]).to(dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(name, rc_):
        if rc_:
            raise RuntimeError(f"{name}: error {rc_}")

    with tempfile.TemporaryDirectory() as tmp:
        k12b = build(tmp, "predict_modes", "predict_modes", K12B)
        k5 = build(tmp, "pseudo_recon", "pseudo_recon", K5)
        cs.warm_up(torch)
        rcfg = cs.rough_config(Config)
        ft = frame_tables(cs.QP, "cuda")
        lam = float(np.float32(qp_to_lambda(cs.QP)))
        m1 = rough_modes("cuda")
        for (w, h, pos) in cs.search_classes(
                PartitionSearch(EncoderControl(rcfg), rcfg, qp=cs.QP)):
            B = len(pos)
            xs = np.array([p[0] for p in pos], dtype=np.int32)
            ys = np.array([p[1] for p in pos], dtype=np.int32)
            tabs = device_tables(w, h, 8, "cuda")
            refs, blocks = ib.refs_blocks(f0, xs, ys, w, h)
            refine = rc.rough_select(ib.satd67(ib.predict67(refs, tabs, m1),
                                               blocks), lam,
                                     ft["mode_bits"], m1)
            want = ib.predict_modes_plain(refs, refine, tabs)
            preds = torch.empty_like(want)
            for name, fn in k12b.items():
                def call(fn=fn, name=name):
                    check(name, fn(
                        refs.data_ptr(), refine.data_ptr(), B, 4, w, h, 255,
                        ib.compact_desc_host(w, h).ctypes.data,
                        tabs["ext_max"],
                        *tabs["reach"], preds.data_ptr(), stream()))
                call()
                torch.cuda.synchronize()
                tag = ("" if not name.startswith(("base", "out")) else
                       " (equal)" if torch.equal(preds, want) else
                       " (DIFFERS)")
                print(f"predict_modes {w}x{h} B={B} {name}: "
                      f"{cs.graph_ms(torch, call, 20):.4f} ms{tag}",
                      flush=True)
            print(f"predict_modes {w}x{h} B={B} zero_ of its output: "
                  f"{cs.graph_ms(torch, preds.zero_, 20):.4f} ms", flush=True)
        big = torch.from_numpy(cs.synth_clip(1920, 1088, 1)[0][0]).to(dev)
        c = quant_consts(16, 16, 8, cs.LD_QP)
        mat = pr._dct16("cuda")
        for plane in (f0, big):
            Hp, Wp = plane.shape
            want = pr.pseudo_recon_plain(plane, cs.LD_QP, 8)
            out = torch.empty_like(plane)
            for name, fn in k5.items():
                def call(fn=fn, name=name):
                    check(name, fn(
                        plane.data_ptr(), Hp, Wp, mat.data_ptr(), 8,
                        c["q_bits"], c["scale"], c["add"], c["iscale"],
                        c["dq_shift"], out.data_ptr(), stream()))
                call()
                torch.cuda.synchronize()
                tag = ("" if name == "io_only" else
                       " (equal)" if torch.equal(out, want) else " (DIFFERS)")
                print(f"pseudo_recon {Wp}x{Hp} {name}: "
                      f"{cs.graph_ms(torch, call, 20):.4f} ms{tag}",
                      flush=True)


if __name__ == "__main__":
    main()
