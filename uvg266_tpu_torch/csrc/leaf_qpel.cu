// K8 leaf_qpel: quarter-pel refinement of every decided inter leaf, shape-
// agnostic through an 8x8 tile decomposition.
//
// Replaces: uvg266_tpu/ops/me_frame.py:215 make_leaf_qpel_fn. Inputs:
// windows [nt, 18, 18] (each tile's reference at its full-pel MV, the tile
// at (5, 5), edge-extended, samples in [0, 2^bitdepth)), blocks [nt, 8, 8]
// (source tiles), leaf_ids [nt] sorted (ids >= nl are padding and
// dropped), pen [49]. Two kernels:
//
// 1. per tile and per offset k in 0..48, (dx, dy) = (k % 7 - 3, k / 7 - 3)
//    quarter-pel: the 8-tap luma interpolation of ops.me
//    make_frac_search_fn, or the window itself at offset (0, 0); then the
//    8x8 Hadamard SATD of the difference: s = sum |H d H|, s - dc +
//    (dc >> 2), then (s + 2) >> 2, into an int32 scratch [nt, 49].
// 2. per leaf: seg[l][k] = float32 sum of its tiles' SATDs, in tile order
//    (jax.ops.segment_sum over sorted ids), cost = seg + pen, best = the
//    first minimum.
// The per-tile SATDs are integers below 2^18; a 64-tile leaf at 10 bits can
// pass 2^24, so the float32 sums keep the reference's tile order.
//
// Bound on this card: operations (the horizontal 8-tap pass of the three
// fractional x phases over the 16 rows and 9 columns the offsets share, 8
// vertical taps a sample for the 42 offsets with a fractional y, the
// butterfly Hadamards), against 1.6 KB read per tile.
//
// Design (K9b frac_search.cu's, on windows the host has already cut): a
// warp takes four tiles, eight lanes a tile, one lane a column; a thread
// block four warps, which share no data (no __syncthreads). The warp loads
// its tiles' windows, which lie side by side in memory, as 16-byte loads;
// computes each tile's three fractional horizontal passes once into shared
// memory as int16 (qpel.cuh's bound), the window read shifted at fx = 0;
// then each lane walks the 7 x offsets, loads the 16 horizontal values of
// its column once per x offset and slides the vertical taps over them in
// registers for the 7 y offsets, keeps its 8 source samples in registers,
// and takes the SATD by qpel.cuh's register and shuffle Hadamard. The
// tiles' 49 SATDs leave through shared memory as one coalesced run. The
// segment pass has a warp per leaf, the lanes on the offsets (32 + 17),
// the float sums in tile order with eight tiles' loads in flight, and the
// first minimum as a (cost, index) shuffle reduction; it finds the leaf's
// first and last tile by binary search over the sorted ids.

#include "common.cuh"
#include "qpel.cuh"

namespace {

constexpr int WIN = 18, PAD = 5, TL = 8, NOFF = 49;
constexpr int TPW = 4, WPB = 4;     // tiles a warp, warps a thread block
constexpr int HR = 16, HC = 9;      // horizontal passes: window rows 1..16,
                                    // tile columns -1..7
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(TPW * TL * WPB)
tile_satd49_kernel(const int* __restrict__ windows,
                   const int* __restrict__ blocks, int nt, int bd, int vec,
                   int* __restrict__ satd) {
  __shared__ __align__(16) int win_s[WPB * TPW][WIN * WIN];
  __shared__ int16_t hx_s[WPB * TPW][3][HR][HC];
  __shared__ int out_s[WPB * TPW][NOFF];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = (blockIdx.x * WPB + warp) * TPW;    // the warp's first tile
  const int ntw = min(TPW, nt - t0);
  if (ntw <= 0) return;
  int* win = win_s[warp * TPW];
  const int* gw = windows + static_cast<long long>(t0) * WIN * WIN;
  if (vec) {
    const int4* g4 = reinterpret_cast<const int4*>(gw);
    int4* s4 = reinterpret_cast<int4*>(win);
    for (int q = lane; q < ntw * WIN * WIN / 4; q += 32) s4[q] = __ldg(g4 + q);
  } else {
    for (int q = lane; q < ntw * WIN * WIN; q += 32) win[q] = __ldg(gw + q);
  }
  const int tl = lane >> 3, c = lane & 7;
  int src[TL];
  const int* sb = blocks + static_cast<long long>(min(t0 + tl, nt - 1)) * TL * TL;
#pragma unroll
  for (int e = 0; e < TL; ++e) src[e] = __ldg(sb + e * TL + c);
  __syncwarp();
  // the three fractional horizontal passes of each tile: hx[p][q][j] at
  // window row q + 1 and tile column j - 1 (window columns j + 1 .. j + 8)
  for (int m = lane; m < ntw * HR * HC; m += 32) {
    const int tt = m / (HR * HC), rem = m - tt * (HR * HC);
    const int q = rem / HC, j = rem - q * HC;
    const int* wr = win + tt * WIN * WIN + (q + 1) * WIN + j + 1;
    int v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = wr[t];
#pragma unroll
    for (int p = 0; p < 3; ++p) hx_s[warp * TPW + tt][p][q][j] = uvg::hor_tap(v, p, bd);
  }
  __syncwarp();
  const int* wt = win + tl * WIN * WIN;
  const int16_t* ht = &hx_s[warp * TPW + tl][0][0][0];
  int* ot = out_s[warp * TPW + tl];
  const int lsh = 14 - bd;
#pragma unroll
  for (int xo = 0; xo < 7; ++xo) {
    const int ox = 4 * (xo - 3), ix = ox >> 4, fx = ox & 15;
    // the column's horizontal values at tile rows -4 .. 11 (window rows
    // 1 .. 16): phase fx at column c + ix, or the window << (14 - bd)
    int v[HR];
#pragma unroll
    for (int t = 0; t < HR; ++t)
      v[t] = fx == 0 ? wt[(t + 1) * WIN + PAD + c] << lsh
                     : ht[((fx >> 2) - 1) * HR * HC + t * HC + c + ix + 1];
#pragma unroll
    for (int yo = 0; yo < 7; ++yo) {
      const int oy = 4 * (yo - 3), iy = oy >> 4, fy = oy & 15;
      int pred[TL];
      if (fx == 0 && fy == 0) {
#pragma unroll
        for (int e = 0; e < TL; ++e) pred[e] = wt[(PAD + e) * WIN + PAD + c];
      } else if (fy == 0) {
        uvg::round_clip<TL>(v + 4, bd, pred);
      } else {
        // sample row e reads tile rows e + iy - 3 .. e + iy + 4
        int f[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = uvg::tap((fy >> 2) - 1, t);
        uvg::vert_taps<TL>(v + 1 + iy, f, bd, pred);
      }
      int d[TL];
#pragma unroll
      for (int e = 0; e < TL; ++e) d[e] = src[e] - pred[e];
      const int s = uvg::satd_cols<TL>(d, lane);
      if (c == 0) ot[yo * 7 + xo] = s;
    }
  }
  __syncwarp();
  // the warp's tiles' SATDs, one contiguous run
  int* dst = satd + static_cast<long long>(t0) * NOFF;
  const int* os = out_s[warp * TPW];
  for (int q = lane; q < ntw * NOFF; q += 32) dst[q] = os[q];
}

constexpr int LPB = 8;              // leaves (warps) a thread block
constexpr int TQ = 8;               // tiles loaded ahead of their sums

// the first index q of the sorted ids [nt] with ids[q] >= l (nt if none)
__device__ __forceinline__ int first_at_least(const int* __restrict__ ids,
                                              int nt, int l) {
  int lo = 0, hi = nt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < l) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(32 * LPB)
leaf_seg_kernel(const int* __restrict__ satd,
                const int* __restrict__ leaf_ids, int nt, int nl,
                const float* __restrict__ pen, int* __restrict__ best,
                float* __restrict__ best_cost, float* __restrict__ seg) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * LPB + (threadIdx.x >> 5);
  if (l >= nl) return;
  const int lo = first_at_least(leaf_ids, nt, l);
  const int hi = first_at_least(leaf_ids, nt, l + 1);
  const bool two = lane < NOFF - 32;       // lanes 0..16 also take 32 + lane
  float a0 = 0.f, a1 = 0.f;
  // the leaf's tiles in order, loaded TQ ahead of their sums
  for (int q0 = lo; q0 < hi; q0 += TQ) {
    int v0[TQ], v1[TQ];
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      const int* row = satd + static_cast<long long>(q0 + u) * NOFF;
      v0[u] = q0 + u < hi ? row[lane] : 0;
      v1[u] = (q0 + u < hi && two) ? row[32 + lane] : 0;
    }
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      if (q0 + u >= hi) break;
      a0 = __fadd_rn(a0, __int2float_rn(v0[u]));
      a1 = __fadd_rn(a1, __int2float_rn(v1[u]));
    }
  }
  float* sl = seg + static_cast<long long>(l) * NOFF;
  sl[lane] = a0;
  float bc = __fadd_rn(a0, pen[lane]);
  int bk = lane;
  if (two) {
    sl[32 + lane] = a1;
    const float c1 = __fadd_rn(a1, pen[32 + lane]);
    if (c1 < bc) {
      bc = c1;
      bk = 32 + lane;
    }
  }
  for (int o = 16; o >= 1; o >>= 1) {
    const float oc = __shfl_xor_sync(FULL, bc, o);
    const int ok = __shfl_xor_sync(FULL, bk, o);
    if (oc < bc || (oc == bc && ok < bk)) {
      bc = oc;
      bk = ok;
    }
  }
  if (lane == 0) {
    best[l] = bk;
    best_cost[l] = bc;
  }
}

}  // namespace

// satd: scratch [nt, 49] int32. nl = 0 runs the tile pass alone.
extern "C" int leaf_qpel(const void* windows, const void* blocks,
                         const void* leaf_ids, int nt, int nl, const void* pen,
                         int bitdepth, void* satd, void* best, void* best_cost,
                         void* seg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bitdepth < 8 || bitdepth > 12) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(windows) % 16 == 0;
  if (nt > 0)
    tile_satd49_kernel<<<(nt + TPW * WPB - 1) / (TPW * WPB), TPW * TL * WPB, 0,
                         st>>>(static_cast<const int*>(windows),
                               static_cast<const int*>(blocks), nt, bitdepth,
                               vec, static_cast<int*>(satd));
  if (nl > 0)
    leaf_seg_kernel<<<(nl + LPB - 1) / LPB, 32 * LPB, 0, st>>>(
        static_cast<const int*>(satd), static_cast<const int*>(leaf_ids), nt,
        nl, static_cast<const float*>(pen), static_cast<int*>(best),
        static_cast<float*>(best_cost), static_cast<float*>(seg));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(leaf_qpel)
