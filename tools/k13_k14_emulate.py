#!/usr/bin/env python3
"""Run the port's K13 and K14 CUDA sources on the CPU, without a card or
nvcc, and hold them against the plain versions.

    python3 tools/k13_k14_emulate.py [--quick]

Builds uvg266_tpu_torch/csrc/transform.cu and quant.cu with g++ (C++20,
into a temporary directory) against a small header of stand-ins:
__device__, __global__ and __shared__ mean nothing, int4 and its kin are
plain structs, __ldg a load, __dp2a_lo its arithmetic, and a launch kernel<<<grid, threads, smem,
stream>>>(args) runs each thread block in turn as `threads` std::threads
that share one static shared-memory array and meet at a std::barrier for
__syncthreads() (and __syncthreads_and). The C entries are then called through ctypes on host
buffers, with the package's signatures.

Checked (every output equal to the plain version, dtypes included):
fwd_transform and inv_transform at every (w, h) in {4..64}^2 (--quick: six
of them) and at the generic shapes (a dimension of 1 or 2, 10 bits), DCT2
and, up to 32 points, four MTS pairs, 8 and 10 bits, one block more than a
thread block holds, on residuals and the int32 extremes;
quant_levels and dequant_levels on int16 and int32 inputs at an element
offset of 0 to 5, outputs at offsets 0 and 1, element counts that are and
are not multiples of 8, four qp_scaled.

This finds indexing and arithmetic faults before a call on the card. It
cannot find what only nvcc refuses (a host function called from device
code, such as integral_constant's constexpr operator int) nor races,
bank conflicts or speed. Prints one line per shape and the count of
differences; exits 1 if there is any.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from uvg266_tpu_torch import kernels  # noqa: E402
from uvg266_tpu_torch.ops import quant as pq  # noqa: E402
from uvg266_tpu_torch.ops import transforms as pt  # noqa: E402
from uvg266_tpu_torch.ops.tr_matrices import (DCT2, DCT8, DST7,  # noqa: E402
                                              get_matrix)

STAND_INS = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) int2 { int x, y; };
struct alignas(8) uint2 { unsigned x, y; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
template <class T> T __ldg(const T* p) { return *p; }
struct dim3i { unsigned x, y, z; };
inline thread_local dim3i threadIdx;
inline dim3i blockIdx, blockDim, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline std::atomic<int> g_and{1};
inline int __syncthreads_and(int p) {
  if (!p) g_and = 0;
  g_bar->arrive_and_wait();
  const int r = g_and;
  g_bar->arrive_and_wait();
  if (threadIdx.x == 0) g_and = 1;
  g_bar->arrive_and_wait();
  return r;
}
// c + a.lo16 * b.byte0 + a.hi16 * b.byte1, signed, mod 2^32
inline int __dp2a_lo(int a, int b, int c) {
  const int a0 = static_cast<int16_t>(a & 0xffff);
  const int a1 = static_cast<int16_t>(static_cast<unsigned>(a) >> 16);
  const int b0 = static_cast<int8_t>(b & 0xff);
  const int b1 = static_cast<int8_t>((b >> 8) & 0xff);
  return static_cast<int>(static_cast<unsigned>(c) + static_cast<unsigned>(a0 * b0) +
                          static_cast<unsigned>(a1 * b1));
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunch = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return 0;
}
inline int g_err = 0;
inline cudaError_t cudaGetLastError() { int e = g_err; g_err = 0; return e; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __int2float_rn(int a) { return static_cast<float>(a); }
using std::max;
using std::min;
namespace {
alignas(16) int4 smem4[16384];
int* const smem = reinterpret_cast<int*>(smem4);
}
template <class K>
auto uvg_launch(long long grid, int threads, size_t bytes, void*, K k) {
  return [=](auto... args) {
    if (bytes > sizeof(smem4) || threads > 1024) {
      g_err = cudaErrorLaunch;
      return;
    }
    gridDim = {unsigned(grid), 1, 1};
    blockDim = {unsigned(threads), 1, 1};
    for (long long b = 0; b < grid; ++b) {
      blockIdx = {unsigned(b), 0, 0};
      std::barrier<> bar(threads);
      g_bar = &bar;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([=] { threadIdx = {unsigned(t), 0, 0}; k(args...); });
      for (auto& th : ts) th.join();
    }
  };
}
"""


def build(tmp):
    """g++ builds of transform.cu and quant.cu against the stand-ins."""
    with open(os.path.join(tmp, "cuda_runtime.h"), "w") as fh:
        fh.write(STAND_INS)
    procs = {}
    for name in ("transform", "quant"):
        with open(os.path.join(kernels.CSRC, f"{name}.cu")) as fh:
            src = fh.read()
        src = re.sub(r"extern __shared__ int4? smem4?\[\];", "", src)
        src = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\(",
                     r"uvg_launch(\2, \1)(", src, flags=re.S)
        path = os.path.join(tmp, f"{name}.cpp")
        with open(path, "w") as fh:
            fh.write(src)
        out = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
             "-I", tmp, "-I", kernels.CSRC, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"g++ failed for {name}.cu:\n{log}")
        lib = ctypes.CDLL(out)
        for entry in kernels.SIGNATURES:
            if kernels.source_of(entry) == name:
                fn = getattr(lib, entry)
                fn.argtypes = kernels.SIGNATURES[entry]
                fn.restype = ctypes.c_int
                fns[entry] = fn
    return fns


def aligned(a, dtype, off=0):
    """a as dtype in a fresh buffer, starting `off` elements past a 16-byte
    boundary."""
    a = np.asarray(a).astype(dtype)
    buf = np.empty(a.nbytes + 64, dtype=np.uint8)
    start = (-buf.ctypes.data) % 16 + off * a.itemsize
    out = buf[start:start + a.nbytes].view(dtype).reshape(a.shape)
    out[...] = a
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="six lattice shapes in place of 25")
    args = ap.parse_args()
    rng = np.random.default_rng(1)
    i32 = np.iinfo(np.int32)
    bad = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(tmp)
        print(f"built in {time.time() - t0:.1f} s", flush=True)

        def entry(name, *a):
            rc = fns[name](*a, None)
            if rc:
                raise RuntimeError(f"{name}: error {rc}")

        def fwd(x, th, tv, bd):
            B, h, w = x.shape
            s1, s2, kw, kh = pt._fwd_params(w, h, th, tv, bd)
            xa, out = aligned(x, np.int32), aligned(np.zeros(x.shape), np.int16)
            mw = aligned(get_matrix(th, w), np.int32)
            mh = aligned(get_matrix(tv, h), np.int32)
            entry("fwd_transform", xa.ctypes.data, B, w, h, th, tv,
                  mw.ctypes.data, mh.ctypes.data, s1, s2, kw, kh,
                  out.ctypes.data)
            return torch.from_numpy(out.copy())

        def inv(c, th, tv, bd):
            B, h, w = c.shape
            s1, s2 = pt._inv_params(w, h, th, tv, bd)
            ca, out = aligned(c, np.int32), aligned(np.zeros(c.shape), np.int16)
            mw = aligned(get_matrix(th, w).T, np.int32)
            mh = aligned(get_matrix(tv, h).T, np.int32)
            entry("inv_transform", ca.ctypes.data, B, w, h, th, tv,
                  mw.ctypes.data, mh.ctypes.data, s1, s2, out.ctypes.data)
            return torch.from_numpy(out.copy())

        sizes = (4, 8, 16, 32, 64)
        shapes = ([(8, 8), (64, 64), (32, 32), (4, 4), (16, 64), (64, 4)]
                  if args.quick else [(w, h) for w in sizes for h in sizes])
        for (w, h) in shapes + [(1, 8), (2, 64), (64, 1), (2, 2)]:
            pairs = [(DCT2, DCT2)]
            if 4 <= min(w, h) and max(w, h) <= 32:
                pairs += [(DST7, DST7), (DCT8, DST7), (DST7, DCT2),
                          (DCT2, DCT8)]
            for th, tv in pairs:
                for bd in ((10,) if min(w, h) < 4 else (8, 10)):
                    B = max(1, 2048 // (w * h)) + 3
                    x = np.concatenate([
                        rng.integers(-1023, 1024, (B - 2, h, w)),
                        rng.integers(i32.min, i32.max, (1, h, w),
                                     dtype=np.int64, endpoint=True),
                        np.full((1, h, w), i32.min)]).astype(np.int32)
                    want = pt.fwd_batch_plain(torch.from_numpy(x), th, tv, bd)
                    if not torch.equal(fwd(x, th, tv, bd), want):
                        bad += 1
                        print(f"fwd_transform {w}x{h} {th}/{tv} {bd}-bit "
                              "differs", flush=True)
                    c = np.concatenate([want.numpy().astype(np.int32), x])
                    if not torch.equal(inv(c, th, tv, bd), pt.inv_batch_plain(
                            torch.from_numpy(c), th, tv, bd)):
                        bad += 1
                        print(f"inv_transform {w}x{h} {th}/{tv} {bd}-bit "
                              "differs", flush=True)
            print(f"{w}x{h} checked ({time.time() - t0:.1f} s)", flush=True)
        big = rng.integers(i32.min, i32.max, 5000, dtype=np.int64)
        big[:6] = [0, 1, -1, i32.max, i32.min, 200000]
        for dt in (np.int16, np.int32):
            for off in range(6):
                for n in (16 * 7, 16 * 7 + 3, 5, 1):
                    v = aligned(big[:n], dt, off)
                    x = torch.from_numpy(v.astype(np.int32)).reshape(-1, 1, 1)
                    for oo in (0, 1):
                        out = aligned(np.zeros(n), np.int32, oo)
                        for qp in (0, 22, 37, 63):
                            for name, plain, consts in (
                                    ("quant_levels", pq.quant_batch_plain,
                                     pq.quant_batch_consts(1, 1, 10, True,
                                                           qp)),
                                    ("dequant_levels", pq.dequant_batch_plain,
                                     pq.dequant_batch_consts(1, 1, 10, qp))):
                                entry(name, v.ctypes.data, n, v.itemsize,
                                      *consts, out.ctypes.data)
                                want = plain(x, qp, 10).reshape(-1).numpy()
                                if not np.array_equal(out, want):
                                    bad += 1
                                    print(f"{name} {dt.__name__} +{off} n={n}"
                                          f" out+{oo} qp{qp} differs",
                                          flush=True)
        print("K14 checked", flush=True)
    print(f"{bad} differences in {time.time() - t0:.1f} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
