// K8 leaf_qpel: quarter-pel refinement of every decided inter leaf, shape-
// agnostic through an 8x8 tile decomposition.
//
// Replaces: uvg266_tpu/ops/me_frame.py:215 make_leaf_qpel_fn. Inputs:
// windows [nt, 18, 18] (each tile's reference at its full-pel MV, the tile
// at (5, 5), edge-extended), blocks [nt, 8, 8] (source tiles), leaf_ids
// [nt] sorted (ids >= nl are padding and dropped), pen [49]. Two kernels:
//
// 1. per tile and per offset k in 0..48, (dx, dy) = (k % 7 - 3, k / 7 - 3)
//    quarter-pel: the 8-tap luma interpolation of ops.me
//    make_frac_search_fn (common.cuh qpel_sample, shared with K9b
//    frac_search.cu), or the window itself at offset (0, 0); then the 8x8 Hadamard
//    SATD of the difference: s = sum |H d H|, s - dc + (dc >> 2), then
//    (s + 2) >> 2, into an int32 scratch [nt, 49].
// 2. per leaf: seg[l][k] = float32 sum of its tiles' SATDs, in tile order
//    (jax.ops.segment_sum over sorted ids), cost = seg + pen, best = the
//    first minimum.
// The per-tile SATDs are integers below 2^18, so the float32 segment sums
// of leaves up to 32x32 (16 tiles) are exact in any order; larger leaves
// are summed in the reference's tile order.
//
// Bound on this card: operations. The interpolation takes 8 * 15 + 8 * 8
// multiply-adds per sample for each of the 48 fractional offsets and the
// SATD 2 * 8 adds per sample (about 0.6 M operations per tile), against
// 1.6 KB read per tile. Design: one thread block of 64 threads per tile,
// one thread per sample; the window sits in shared memory; each thread
// interpolates its own sample from the window (no intermediate plane), the
// two Hadamard passes go through shared memory, and the absolute sum is a
// shuffle reduction over the two warps. The segment pass has one thread
// per (leaf, offset); it finds the leaf's first tile by binary search over
// the sorted ids.

#include "common.cuh"

namespace {

constexpr int WIN = 18, PAD = 5, TL = 8, NOFF = 49;

__global__ void tile_satd49_kernel(const int* __restrict__ windows,
                                   const int* __restrict__ blocks, int bitdepth,
                                   int* __restrict__ satd) {
  __shared__ int win[WIN * WIN];
  __shared__ int d[TL * TL];
  __shared__ int t[TL * TL];
  __shared__ int part[2];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;            // 64 threads: sample (i, j)
  const int i = tid / TL, j = tid % TL;
  for (int q = tid; q < WIN * WIN; q += TL * TL)
    win[q] = windows[static_cast<long long>(tile) * WIN * WIN + q];
  const int src = blocks[static_cast<long long>(tile) * TL * TL + tid];
  __syncthreads();
  for (int k = 0; k < NOFF; ++k) {
    const int ox = 4 * (k % 7 - 3), oy = 4 * (k / 7 - 3);
    const int ix = ox >> 4, iy = oy >> 4, fx = ox & 15, fy = oy & 15;
    const int pred = uvg::qpel_sample(win + (PAD + iy + i) * WIN + PAD + ix + j,
                                      WIN, fx, fy, bitdepth);
    d[tid] = src - pred;
    __syncthreads();
    // rows: t[i][j] = sum_c d[i][c] * H[c][j]
    int acc = 0;
#pragma unroll
    for (int c = 0; c < TL; ++c) acc += uvg::had_sign(c, j) * d[i * TL + c];
    t[tid] = acc;
    __syncthreads();
    // columns: u[i][j] = sum_c H[i][c] * t[c][j]
    acc = 0;
#pragma unroll
    for (int c = 0; c < TL; ++c) acc += uvg::had_sign(i, c) * t[c * TL + j];
    const int a = abs(acc);
    int s = a;
    for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((tid & 31) == 0) part[tid >> 5] = s;
    const int dc = __shfl_sync(0xffffffffu, a, 0);   // lane 0 of warp 0: u[0][0]
    __syncthreads();
    if (tid == 0) {
      int tot = part[0] + part[1];
      tot = tot - dc + (dc >> 2);
      satd[static_cast<long long>(tile) * NOFF + k] = (tot + 2) >> 2;
    }
  }
}

__global__ void leaf_seg_kernel(const int* __restrict__ satd,
                                const int* __restrict__ leaf_ids, int nt,
                                const float* __restrict__ pen,
                                int* __restrict__ best,
                                float* __restrict__ best_cost,
                                float* __restrict__ seg) {
  __shared__ float cost[NOFF];
  const int l = blockIdx.x;
  const int k = threadIdx.x;               // 64 threads, 49 offsets
  if (k < NOFF) {
    int lo = 0, hi = nt;                   // first tile with id >= l
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (leaf_ids[mid] < l) lo = mid + 1; else hi = mid;
    }
    float acc = 0.f;
    for (int q = lo; q < nt && leaf_ids[q] == l; ++q)
      acc = __fadd_rn(acc, __int2float_rn(satd[static_cast<long long>(q) * NOFF + k]));
    seg[static_cast<long long>(l) * NOFF + k] = acc;
    cost[k] = __fadd_rn(acc, pen[k]);
  }
  __syncthreads();
  if (k == 0) {
    int bi = 0;
    float bc = cost[0];
    for (int q = 1; q < NOFF; ++q)
      if (cost[q] < bc) { bc = cost[q]; bi = q; }
    best[l] = bi;
    best_cost[l] = bc;
  }
}

}  // namespace

// satd: scratch [nt, 49] int32
extern "C" int leaf_qpel(const void* windows, const void* blocks,
                         const void* leaf_ids, int nt, int nl, const void* pen,
                         int bitdepth, void* satd, void* best, void* best_cost,
                         void* seg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bitdepth < 8 || bitdepth > 12) return static_cast<int>(cudaErrorInvalidValue);
  if (nt > 0)
    tile_satd49_kernel<<<nt, TL * TL, 0, st>>>(
        static_cast<const int*>(windows), static_cast<const int*>(blocks),
        bitdepth, static_cast<int*>(satd));
  if (nl > 0)
    leaf_seg_kernel<<<nl, 64, 0, st>>>(
        static_cast<const int*>(satd), static_cast<const int*>(leaf_ids), nt,
        static_cast<const float*>(pen), static_cast<int*>(best),
        static_cast<float*>(best_cost), static_cast<float*>(seg));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(leaf_qpel)
