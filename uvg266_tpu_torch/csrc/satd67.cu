// K3 satd67: SATD of every candidate prediction against its source block
// (the 67 intra modes, or the M = 12, 16 or 32 MIP candidates of a class).
//
// Replaces: uvg266_tpu/ops/intra_batch.py:521 make_satd67_fn (the reference
// runs it inside make_rd_cost_fn, ops/rd_cost.py:105). Per (block, mode):
// the n x n Hadamard transform t = H (src - pred) H of every sub-block
// (n = 8, or 4 when w or h is below 8), s = sum|t| - |t00| + (|t00| >> 2),
// (s + 2) >> 2 ((s + 1) >> 1 at n = 4), summed over the sub-blocks.
//
// Bound on this card: bytes, by the read of preds [B, M, h, w] int32
// (about 420 MB per 832x480 frame); about ten integer additions per sample.
// Design: the Hadamard matrix has +-1 entries, so it is done with adds.
// Each lane holds one row of one sub-block (n values in registers) and
// runs the row transform as an in-register butterfly; the column transform
// is the same butterfly across the n lanes of the sub-block with
// __shfl_xor_sync. A warp covers 32/n sub-blocks at a time: those of one
// (block, mode) pair when it has that many, else those of several pairs,
// so small blocks do not leave lanes idle. Each lane reads its row as
// contiguous 16-byte loads; the source block is re-read for each mode from
// L1/L2.

#include <algorithm>

#include "common.cuh"

namespace {

template <int N>
__global__ void satd67_kernel(const int* __restrict__ preds,
                              const int* __restrict__ src, int n_pairs, int M,
                              int w, int h, int* __restrict__ out) {
  constexpr int ADD = N == 8 ? 2 : 1;
  constexpr int SHIFT = N == 8 ? 2 : 1;
  const int nsb_x = w / N;
  const int nsb = nsb_x * (h / N);
  const int lpp = min(32, nsb * N);          // lanes per (block, mode) pair
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int pair = warp * (32 / lpp) + lane / lpp;
  const int lo = lane % lpp;
  const int row = lo % N;
  const bool active = pair < n_pairs;
  const int hw = w * h;
  const int* P = preds + static_cast<long long>(active ? pair : 0) * hw;
  const int* S = src + static_cast<long long>(active ? pair / M : 0) * hw;
  const int iters = nsb * N / lpp;
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int sub = it * (lpp / N) + lo / N;
    const int off = ((sub / nsb_x) * N + row) * w + (sub % nsb_x) * N;
    int d[N];
    if (active) {
      if constexpr (N == 8) {
        const int4 s0 = *reinterpret_cast<const int4*>(S + off);
        const int4 s1 = *reinterpret_cast<const int4*>(S + off + 4);
        const int4 p0 = *reinterpret_cast<const int4*>(P + off);
        const int4 p1 = *reinterpret_cast<const int4*>(P + off + 4);
        d[0] = s0.x - p0.x; d[1] = s0.y - p0.y; d[2] = s0.z - p0.z; d[3] = s0.w - p0.w;
        d[4] = s1.x - p1.x; d[5] = s1.y - p1.y; d[6] = s1.z - p1.z; d[7] = s1.w - p1.w;
      } else {
        const int4 s0 = *reinterpret_cast<const int4*>(S + off);
        const int4 p0 = *reinterpret_cast<const int4*>(P + off);
        d[0] = s0.x - p0.x; d[1] = s0.y - p0.y; d[2] = s0.z - p0.z; d[3] = s0.w - p0.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) d[k] = 0;
    }
    // rows: in-register butterfly (Sylvester order, so d[0] is the row sum)
#pragma unroll
    for (int len = 1; len < N; len <<= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if ((i & len) == 0) {
          const int a = d[i], b = d[i + len];
          d[i] = a + b;
          d[i + len] = a - b;
        }
      }
    }
    // columns: the same butterfly across the N lanes of the sub-block
#pragma unroll
    for (int len = 1; len < N; len <<= 1) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int o = __shfl_xor_sync(0xffffffffu, d[k], len);
        d[k] = (row & len) ? (o - d[k]) : (d[k] + o);
      }
    }
    int s = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) s += abs(d[k]);
#pragma unroll
    for (int o = 1; o < N; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (row == 0) {
      const int dc = abs(d[0]);
      acc += (s - dc + (dc >> 2) + ADD) >> SHIFT;
    }
  }
  for (int o = lpp >> 1; o >= 1; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (active && lo == 0) out[pair] = acc;
}

}  // namespace

extern "C" int satd67(const void* preds, const void* src, int B, int M, int w,
                      int h, void* out, void* stream) {
  const int n = (w >= 8 && h >= 8) ? 8 : 4;
  const int n_pairs = B * M;
  const int lpp = std::min(32, (w / n) * (h / n) * n);
  const long long warps = (static_cast<long long>(n_pairs) + 32 / lpp - 1) / (32 / lpp);
  const int threads = 256;
  if (n_pairs <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (warps * 32 + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 8)
    satd67_kernel<8><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const int*>(preds), static_cast<const int*>(src), n_pairs,
        M, w, h, static_cast<int*>(out));
  else
    satd67_kernel<4><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const int*>(preds), static_cast<const int*>(src), n_pairs,
        M, w, h, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(satd67)
