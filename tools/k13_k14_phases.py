#!/usr/bin/env python3
"""Split the port's K13 transforms (csrc/transform.cu) by phase, and time
design variants of K13 and K14 (csrc/quant.cu), on an NVIDIA card.

    python3 tools/k13_k14_phases.py

Builds edited copies of uvg266_tpu_torch/csrc/transform.cu and quant.cu
with nvcc (the package's flags) into a temporary directory and times each
through its C entries on a CUDA graph of 20 calls, at the four all-intra
classes of an 832x480 frame (chip_smoke.py's clip, frame 0, 8 bits, QP22,
DCT2: the forward on the frame's residuals, the inverse on their
dequantised coefficients). K13 (fwd_transform, inv_transform):

  base     the source as it is (64x64: 128 threads a thread block; below
           it 1024 samples a thread block);
  io       no pass: the loads into shared memory, the barriers and the
           stores only;
  pass1    the first pass only (the forward's rows, the inverse's columns);
  pass2    the second pass only (the forward's kept columns, the inverse's
           rows);
  nt64, nt256, nt512  64x64 with 64, 256 or 512 threads a thread block;
  s2048    2048 samples a thread block below 64x64;
  nopack   the inverse's row pass one product an instruction, not two
           (__dp2a_lo pairs);
  nozero   the inverse always in full, never the shortcut for coefficients
           that are zero outside a 64-point dimension's kept half;

and K14 through its C entries on the round trip's data (quant_levels on the
int16 coefficients, dequant_levels on the levels): base (128 threads a
thread block), t64 and t256.

The variants that compute the function (all but io, pass1 and pass2) are
held against the plain versions. An edit that no longer matches the source
fails the script. Prints the card and its power limit, each variant's
SASS instruction count of its 64x64 kernels (cuobjdump, where the toolkit
has it), one line per class, direction and variant in ms, and each
variant's sum a frame.
"""
import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from uvg266_tpu_torch import kernels  # noqa: E402

ROWS_F = ("tasks<G::NT, G::U * H, G::G1F>", "tasks<G::NT, 0, G::G1F>")
COLS_F = ("tasks<G::NT, G::U * G::KW, G::G2F>", "tasks<G::NT, 0, G::G2F>")
COLS_I = ("tasks<G::NT, G::U * CW, G1>", "tasks<G::NT, 0, G1>")
ROWS_I = ("tasks<G::NT, G::U * H, G::G2I>", "tasks<G::NT, 0, G::G2I>")
NT64 = "constexpr int NT_64X64 = 128;"
SAMPLES = "constexpr int SAMPLES = 1024;"
PACK = "constexpr bool PACK_ROWS = true;"
ZERO = ("static constexpr bool ZERO_OUT = ZW < W || ZH < H;",
        "static constexpr bool ZERO_OUT = false;")
VARIANTS = {
    "base": [],
    "io": [ROWS_F, COLS_F, COLS_I, ROWS_I],
    "pass1": [COLS_F, ROWS_I],
    "pass2": [ROWS_F, COLS_I],
    "nt64": [(NT64, NT64.replace("128", "64"))],
    "nt256": [(NT64, NT64.replace("128", "256"))],
    "nt512": [(NT64, NT64.replace("128", "512"))],
    "s2048": [(SAMPLES, SAMPLES.replace("1024", "2048"))],
    "nopack": [(PACK, PACK.replace("true", "false"))],
    "nozero": [ZERO],
}
FUNCTION = ("base", "nt64", "nt256", "nt512", "s2048", "nopack", "nozero")
QTHREADS = "constexpr int THREADS = 128;"
QVARIANTS = {
    "base": [],
    "t256": [(QTHREADS, QTHREADS.replace("128", "256"))],
    "t64": [(QTHREADS, QTHREADS.replace("128", "64"))],
}


def build(tmp, source, variants, entries):
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
        out = path[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *flags, "-I", kernels.CSRC, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return procs, entries


def sass_size(lib, marker):
    """Instructions of the kernels in lib whose names hold marker (the
    64x64 instances: ILi64ELi64E), from cuobjdump -sass; None without
    cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True).stdout
    sizes, name = {}, None
    for ln in dump.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif name and marker in name and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            sizes[name] = sizes.get(name, 0) + 1
    return sizes


def load(built):
    procs, entries = built
    fns = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{log}")
        sizes = sass_size(out, "ILi64ELi64E")
        if sizes:
            print(f"{name}: SASS instructions of the 64x64 kernels: "
                  + ", ".join(f"{k[:40]} {v}" for k, v in sizes.items()),
                  flush=True)
        lib = ctypes.CDLL(out)
        fns[name] = []
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = kernels.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[name].append(fn)
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import SliceEncoder
    from uvg266_tpu_torch.control.params import EncoderControl
    from uvg266_tpu_torch.control.partition import PartitionSearch
    from uvg266_tpu_torch.ops import quant as qu
    from uvg266_tpu_torch.ops import transforms as tr
    from uvg266_tpu_torch.ops.tr_matrices import DCT2, device_matrix32

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    H, W = cs.H, cs.W
    f0 = torch.from_numpy(cs.synth_clip(W, H, 1)[0][0]).to(dev)

    def check(name, rc_):
        if rc_:
            raise RuntimeError(f"{name}: error {rc_}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def timed(key, cls, call, out, want, compare):
        call()
        torch.cuda.synchronize()
        tag = ("" if not compare else " (equal)" if torch.equal(out, want)
               else " (DIFFERS)")
        ms = cs.graph_ms(torch, call, 20)
        sums[key] = sums.get(key, 0.0) + ms
        print(f"{key} {cls}: {ms:.4f} ms{tag}", flush=True)

    sums = {}
    with tempfile.TemporaryDirectory() as tmp:
        tb = build(tmp, "transform", VARIANTS,
                   ("fwd_transform", "inv_transform"))
        qb = build(tmp, "quant", QVARIANTS,
                   ("quant_levels", "dequant_levels"))
        fns, qfns = load(tb), load(qb)
        cs.warm_up(torch)
        cfg = cs.bench_config(Config)
        ctrl = EncoderControl(cfg)
        entries = SliceEncoder(cfg, ctrl, device=dev)._fused_entries(
            PartitionSearch(ctrl, cfg, qp=cs.QP))
        for (_k, w, h, _positions, _g) in entries:
            hh, ww = H // h * h, W // w * w
            x = (f0[:hh, :ww].reshape(hh // h, h, ww // w, w).transpose(1, 2)
                 .reshape(-1, h, w).contiguous() - 128)
            B = x.shape[0]
            cls = f"{w}x{h} B={B}"
            want_c = tr.fwd_batch_plain(x, DCT2, DCT2, 8)
            want_l = qu.quant_batch_plain(want_c, cs.QP, 8)
            dq = qu.dequant_batch_plain(want_l, cs.QP, 8)
            want_r = tr.inv_batch_plain(dq, DCT2, DCT2, 8)
            s1, s2 = tr.fwd_shifts(w, h, 8)
            i1, i2 = tr.inv_shifts(8)
            kw, kh = tr.zero_out(w, DCT2, DCT2, h)
            mf = [device_matrix32(DCT2, n, "cuda", False).data_ptr()
                  for n in (w, h)]
            mi = [device_matrix32(DCT2, n, "cuda", True).data_ptr()
                  for n in (w, h)]
            o = torch.empty_like(want_c)
            for name, (fwd, inv) in fns.items():
                timed(f"fwd {name}", cls, lambda fwd=fwd, name=name: check(
                    name, fwd(x.data_ptr(), B, w, h, DCT2, DCT2, *mf, s1, s2,
                              kw, kh, o.data_ptr(), stream())),
                      o, want_c, name in FUNCTION)
                timed(f"inv {name}", cls, lambda inv=inv, name=name: check(
                    name, inv(dq.data_ptr(), B, w, h, DCT2, DCT2, *mi, i1,
                              i2, o.data_ptr(), stream())),
                      o, want_r, name in FUNCTION)
            # K14 on the round trip's data: quant on the int16
            # coefficients, dequant on the levels
            o32 = torch.empty_like(want_l)
            qc = qu.quant_batch_consts(w, h, 8, True, cs.QP)
            dc = qu.dequant_batch_consts(w, h, 8, cs.QP)
            for name, (qf, df) in qfns.items():
                timed(f"quant {name}", cls, lambda qf=qf, name=name: check(
                    name, qf(want_c.data_ptr(), want_c.numel(), 2, *qc,
                             o32.data_ptr(), stream())), o32, want_l, True)
                timed(f"dequant {name}", cls, lambda df=df, name=name: check(
                    name, df(want_l.data_ptr(), want_l.numel(), 4, *dc,
                             o32.data_ptr(), stream())), o32, dq, True)
            del x, dq, o, o32, want_c, want_l, want_r
    for key, ms in sums.items():
        print(f"{key} a frame: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
