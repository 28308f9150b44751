#!/usr/bin/env python3
"""Split the port's K9a fullpel_search time by phase, on an NVIDIA card.

    python3 tools/k9a_phases.py

Builds edited copies of uvg266_tpu_torch/csrc/fullpel_search.cu with nvcc
(the package's flags) into a temporary directory and times each on a CUDA
graph of 20 calls at the 10-bit LD classes of an 832x480 frame (16x16
B=1560, 8x8 B=6240, r = 16, random 10-bit plane and blocks):

  base     the kernel as it is;
  no_corr  without the corr loop (the phases around it: windows, column
           sums, costs, the argmin), and further without the window load,
           the column sums or the costs (the argmin then reads what the
           shared memory holds), or all three;
  nb1/nb4  one or four blocks a thread block below 32x32.

An edit that no longer matches the source fails the script. Prints the card
and its power limit, then one line per class and variant in ms.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from uvg266_tpu_torch import kernels  # noqa: E402
from uvg266_tpu_torch.ops import intra_batch as ib  # noqa: E402
from uvg266_tpu_torch.ops.tables import me_penalties  # noqa: E402

NB_LINE = "  int NB = KS == 1 ? 2 : 1;"
NB_KERNEL = "  const int NB = WT ? 2 : NB_, KS = WT ? 1 : KS_;"
NO_CORR = ("  if (active) {\n    const int rows = h / KS",
           "  if (false) {\n    const int rows = h / KS")
NO_WINDOW = ("  for (int q0 = threadIdx.x; q0 < total; q0 += 8 * blockDim.x) {",
             "  for (int q0 = threadIdx.x; q0 < 0; q0 += 8 * blockDim.x) {")
NO_COLSUM = ("  for (int q = tid; q < g.chunks * ncols; q += blockDim.x) {",
             "  for (int q = tid; q < 0; q += blockDim.x) {")
NO_COST = ("  if (active && ks == 0) {\n    const unsigned* cs",
           "  if (false) {\n    const unsigned* cs")
VARIANTS = {
    "base": [],
    "no_corr": [NO_CORR],
    "no_corr_window": [NO_CORR, NO_WINDOW],
    "no_corr_colsum": [NO_CORR, NO_COLSUM],
    "no_corr_cost": [NO_CORR, NO_COST],
    "no_corr_window_colsum_cost": [NO_CORR, NO_WINDOW, NO_COLSUM, NO_COST],
    "nb1": [(NB_LINE, "  int NB = 1;"),
            (NB_KERNEL, "  const int NB = WT ? 1 : NB_, KS = WT ? 1 : KS_;")],
    "nb4": [(NB_LINE, "  int NB = KS == 1 ? 4 : 1;"),
            (NB_KERNEL, "  const int NB = WT ? 4 : NB_, KS = WT ? 1 : KS_;")],
}
H, W, R = 480, 832, 16


def build(tmp):
    with open(os.path.join(kernels.CSRC, "fullpel_search.cu")) as fh:
        src = fh.read()
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, edits in VARIANTS.items():
        s = src
        for a, b in edits:
            if a not in s:
                sys.exit(f"variant {name}: the source no longer holds {a!r}")
            s = s.replace(a, b)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(s)
        out = os.path.join(tmp, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *flags, "-I", kernels.CSRC, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(out).fullpel_search
        fn.argtypes = kernels.SIGNATURES["fullpel_search"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def graph_ms(call, n=20, reps=5):
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            call()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * reps)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.integers(0, 1024, (H, W)).astype(np.int32)) \
        .to(dev)
    pen, _ = me_penalties(57.9, R, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(tmp)
        for (w, h) in ((16, 16), (8, 8)):
            pos = [(x, y) for y in range(0, H, h) for x in range(0, W, w)]
            xs, ys = ib.positions_on([p[0] for p in pos],
                                     [p[1] for p in pos], w, h, H, W, dev)
            B = len(pos)
            blocks = torch.from_numpy(rng.integers(
                0, 1024, (B, h, w)).astype(np.int32)).to(dev)
            out = (torch.empty(B, dtype=torch.int32, device=dev),
                   torch.empty(B, dtype=torch.int32, device=dev),
                   torch.empty(B, dtype=torch.float32, device=dev))
            for name, fn in fns.items():
                def call(fn=fn, name=name):
                    rc = fn(ref.data_ptr(), H, W, blocks.data_ptr(),
                            xs.data_ptr(), ys.data_ptr(), B, w, h, R,
                            pen.data_ptr(), *(o.data_ptr() for o in out),
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: error {rc}")
                print(f"{w}x{h} {name}: {graph_ms(call):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
