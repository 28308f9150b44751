// K9b frac_search: quarter-pel refinement of every block of a class around
// its full-pel motion vector.
//
// Replaces: uvg266_tpu/ops/me.py:79 make_frac_search_fn (called by
// control/encoder.py search_inter_blocks after K9a). For each block b and
// each of the 49 offsets k, (dx, dy) = (k % 7 - 3, k / 7 - 3) in quarter
// pels around the full-pel MV:
//   pred[b, k]  = interp_one: the horizontal 8-tap pass at phase fx,
//                 >> (bitdepth - 8), the vertical 8-tap pass at phase fy,
//                 >> 6, the rounding shift by 14 - bitdepth and the clip;
//                 the window itself at k = 24;
//   satd        = satd_bw of src - pred: the n x n Hadamard of every
//                 sub-block (n = 8 when w, h >= 8, else 4),
//                 s = sum|t| - |t00| + (|t00| >> 2), (s + 2) >> 2
//                 ((s + 1) >> 1 at n = 4), summed over the sub-blocks as
//                 an integer;
//   costs[b, k] = float32(satd) + fpen[k];
// then best[b] = the first minimum over k. All integer work: the outputs
// equal the reference's exactly.
//
// Two output forms: the contract form writes all 49 predictions [B, 49, h,
// w] (the reference's output); the winner form writes only the winning
// offset's prediction [B, h, w], the one search_inter_blocks reads (the
// reference gathers preds[k, best[k]] on the host).
//
// Bound on this card: bytes in the contract form, by the write of the 49
// predictions (78 MB for the 8x8 class at 832x480); operations in the
// winner form (the shared horizontal passes, 8 vertical taps a sample for
// the 42 offsets with a fractional y, the butterfly Hadamards).
//
// Design: one thread block per block (several blocks per thread block
// below 16x16), so the block's (h+8) x (w+8) window is read once, with
// four loads in flight a thread. The 49 offsets share three
// fractional x phases (4, 8, 12) over w + 1 columns (ix in {-1, 0}) and the
// h + 8 rows: those three horizontal passes are computed once into shared
// memory as int16 (their bound is checked in qpel.cuh); at fx = 0 the
// reference's filter 0 gives 64 * s exactly, so the window is read shifted
// instead. A thread owns one column of n samples of one sub-block and walks
// the offsets: it loads the n + 7 horizontal values of its column once and
// slides the vertical 8 taps over them in registers (the identity at
// fy = 0), keeps its n source samples in registers, runs the vertical
// Hadamard in registers and the horizontal one across the n lanes of the
// sub-block with warp shuffles (that arithmetic in qpel.cuh, shared with
// K8 leaf_qpel.cu), and sums per sub-block and per block as
// integers with shuffles (order-free, no atomics). The costs, the first
// minimum and both output forms come from the same launch; predictions
// leave through a per-warp staging buffer as 16-byte stores.

#include "common.cuh"
#include "qpel.cuh"

namespace {

constexpr int NOFF = 49;
constexpr int MARGIN = 4;        // 3 taps before the sample, and ix or iy -1
constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  int w, h, T, NB, G, nparts, ww, wh, hxw, nwarps;
};

__host__ __device__ inline Geo geometry(int w, int h, int n) {
  Geo g;
  g.w = w;
  g.h = h;
  g.T = (h / n) * w;                   // column segments a block and offset
  g.NB = g.T < 32 ? 32 / g.T : 1;      // blocks a thread block
  g.G = g.T <= 64 ? 7 : 1;             // offsets in flight a block
  g.nparts = g.T > 32 ? g.T / 32 : 1;  // warps an offset of one block spans
  g.ww = w + 2 * MARGIN;
  g.wh = h + 2 * MARGIN;
  g.hxw = w + 1;
  g.nwarps = g.NB * g.T * g.G / 32;
  return g;
}

inline size_t smem_bytes(const Geo& g, int n) {
  return sizeof(int) * (static_cast<size_t>(g.nwarps) * n * 32 +
                        static_cast<size_t>(g.NB) * NOFF * g.nparts + g.NB) +
         sizeof(int16_t) * static_cast<size_t>(g.NB) * g.wh *
             (g.ww + 3 * g.hxw);
}

// Fill win [NB][rows][cols] with the NB edge-extended windows: window bi
// holds rows oy[bi] .. oy[bi] + rows - 1 and columns ox[bi] .. ox[bi] +
// cols - 1 of ref [H, W], clamped to the plane. Each thread issues U loads
// before it stores any of them, so that U round trips to memory overlap.
// Run by all threads of the block; a barrier must follow.
template <int U>
__device__ __forceinline__ void load_windows(const int* __restrict__ ref,
                                             int H, int W, const int* ox,
                                             const int* oy, int NB, int rows,
                                             int cols, int16_t* win) {
  const int per = rows * cols, total = NB * per;
  for (int q0 = threadIdx.x; q0 < total; q0 += U * blockDim.x) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * blockDim.x;
      v[u] = 0;
      if (q < total) {
        const int bi = q / per, rem = q - bi * per;
        const int i = rem / cols, j = rem - i * cols;
        v[u] = __ldg(ref + static_cast<long long>(uvg::clampi(oy[bi] + i, 0, H - 1)) * W +
                     uvg::clampi(ox[bi] + j, 0, W - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < total) win[q] = static_cast<int16_t>(v[u]);
    }
  }
}

// Write the warp's n x 32 predicted samples: lane L holds rows e of its
// column, `dst` points at its row r0 (null where the block is past B).
// Staged in shared memory so that each store is 16 bytes of 4 lanes'
// neighbouring columns.
template <int N>
__device__ __forceinline__ void store_warp(const int* pred, int* stage,
                                           int lane, int* dst, int w) {
#pragma unroll
  for (int e = 0; e < N; ++e) stage[e * 32 + lane] = pred[e];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int q = lane + 32 * i, e = q >> 3, j = q & 7;
    const int4 v = *reinterpret_cast<const int4*>(stage + e * 32 + 4 * j);
    int* d = reinterpret_cast<int*>(__shfl_sync(
        FULL, reinterpret_cast<unsigned long long>(dst), 4 * j));
    if (d != nullptr) *reinterpret_cast<int4*>(d + e * w) = v;
  }
  __syncwarp();
}

template <int N, int WT, int HT>
__global__ void __launch_bounds__(512)
frac_search_kernel(const int* __restrict__ ref, int H, int W,
                   const int* __restrict__ blocks, const int* __restrict__ xs,
                   const int* __restrict__ ys, const int* __restrict__ mvx,
                   const int* __restrict__ mvy, int B, int w_, int h_,
                   int bd, const float* __restrict__ fpen,
                   int* __restrict__ best, int* __restrict__ preds,
                   float* __restrict__ costs, int winner) {
  const Geo g = geometry(WT ? WT : w_, HT ? HT : h_, N);
  const int w = g.w, h = g.h;
  extern __shared__ int4 smem4[];
  int* stage = reinterpret_cast<int*>(smem4);             // [nwarps][N][32]
  int* part = stage + g.nwarps * N * 32;                  // [NB][49][nparts]
  int* best_s = part + g.NB * NOFF * g.nparts;            // [NB]
  int16_t* win_s = reinterpret_cast<int16_t*>(best_s + g.NB);  // [NB][wh][ww]
  int16_t* hx_s = win_s + g.NB * g.wh * g.ww;             // [NB][3][wh][hxw]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * g.NB;

  // the windows (origins in shared memory first)
  __shared__ int org[2][8];
  if (tid < g.NB) {
    const int b = min(b0 + tid, B - 1);
    org[0][tid] = xs[b] + mvx[b] - MARGIN;
    org[1][tid] = ys[b] + mvy[b] - MARGIN;
  }
  __syncthreads();
  load_windows<4>(ref, H, W, org[0], org[1], g.NB, g.wh, g.ww, win_s);
  // this thread's column: block bi, offsets k = grp, grp + G, ...
  const int per_grp = g.NB * g.T;
  const int grp = tid / per_grp, rem = tid - grp * per_grp;
  const int bi = rem / g.T, task = rem - bi * g.T;
  const int c = task & (w - 1), r0 = (task / w) * N;
  const int cc = task & (N - 1);
  const bool valid = b0 + bi < B;
  const int b = min(b0 + bi, B - 1);
  int src[N];
  const int* sg = blocks + static_cast<long long>(b) * w * h;
#pragma unroll
  for (int e = 0; e < N; ++e) src[e] = sg[(r0 + e) * w + c];
  __syncthreads();
  // the three shared horizontal passes, >> (bd - 8), as int16
  for (int bj = 0; bj < g.NB; ++bj) {
    const int16_t* wb = win_s + bj * g.wh * g.ww;
    int16_t* hb = hx_s + bj * 3 * g.wh * g.hxw;
    for (int i = warp; i < g.wh; i += g.nwarps) {
      for (int j = lane; j < g.hxw; j += 32) {
        int v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = wb[i * g.ww + j + t];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          hb[(p * g.wh + i) * g.hxw + j] = uvg::hor_tap(v, p, bd);
      }
    }
  }
  __syncthreads();

  // the block's window and passes at its sample (0, 0)
  const int16_t* wb = win_s + bi * g.wh * g.ww + MARGIN * g.ww + MARGIN;
  const int16_t* hb = hx_s + bi * 3 * g.wh * g.hxw + MARGIN * g.hxw + 1;
  const int hps = g.wh * g.hxw;
  int* stage_w = stage + warp * N * 32;
  const int red_top = g.T < 32 ? g.T : 32;
  for (int k = grp; k < NOFF; k += g.G) {
    int pred[N], d[N];
    uvg::interp_col<N>(wb, g.ww, hb, g.hxw, hps, r0, c, k, bd, pred);
#pragma unroll
    for (int e = 0; e < N; ++e) d[e] = src[e] - pred[e];
    // the sub-block's SATD (lane & (N - 1) == task & (N - 1) == cc: T and
    // NB * T are multiples of N)
    const int sb = uvg::satd_cols<N>(d, lane);
    int v = cc == 0 ? sb : 0;
    for (int m = N; m < red_top; m <<= 1) v += __shfl_xor_sync(FULL, v, m);
    if ((task & 31) == 0) part[(bi * NOFF + k) * g.nparts + (task >> 5)] = v;
    if (!winner) {
      int* dst = valid ? preds + ((static_cast<long long>(b) * NOFF + k) * h + r0) * w + c
                       : nullptr;
      store_warp<N>(pred, stage_w, lane, dst, w);
    }
  }
  __syncthreads();

  // costs and the first minimum, a warp per block
  for (int bj = warp; bj < g.NB; bj += g.nwarps) {
    const int bb = b0 + bj;
    if (bb >= B) {
      if (lane == 0) best_s[bj] = 0;
      continue;
    }
    float bc = INFINITY;
    int bk = NOFF;
    for (int k = lane; k < NOFF; k += 32) {
      int satd = 0;
      for (int q = 0; q < g.nparts; ++q) satd += part[(bj * NOFF + k) * g.nparts + q];
      const float cost = __fadd_rn(__int2float_rn(satd), fpen[k]);
      costs[static_cast<long long>(bb) * NOFF + k] = cost;
      if (cost < bc) {                     // k ascends: first minimum
        bc = cost;
        bk = k;
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
      best[bb] = bk;
      best_s[bj] = bk;
    }
  }
  if (!winner) return;
  __syncthreads();
  // the winner form: the winning offset's prediction, recomputed
  if (grp == 0) {
    int pred[N];
    uvg::interp_col<N>(wb, g.ww, hb, g.hxw, hps, r0, c, best_s[bi], bd,
                       pred);
    int* dst = valid ? preds + (static_cast<long long>(b) * h + r0) * w + c : nullptr;
    store_warp<N>(pred, stage_w, lane, dst, w);
  }
}

template <int N, int WT, int HT>
cudaError_t launch(const int* ref, int H, int W, const int* blocks,
                   const int* xs, const int* ys, const int* mvx,
                   const int* mvy, int B, int w, int h, int bd,
                   const float* fpen, int* best, int* preds, float* costs,
                   int winner, cudaStream_t st) {
  const Geo g = geometry(w, h, N);
  const size_t smem = smem_bytes(g, N);
  auto kern = frac_search_kernel<N, WT, HT>;
  // opted in per card and instance, raised to the largest asked (above
  // 48 KB: uvg::SmemGrant)
  static uvg::SmemGrant grant;
  const cudaError_t e = grant.ensure(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<(B + g.NB - 1) / g.NB, g.NB * g.T * g.G, smem, st>>>(
      ref, H, W, blocks, xs, ys, mvx, mvy, B, w, h, bd, fpen, best, preds,
      costs, winner);
  return cudaGetLastError();
}

}  // namespace

// ref [H, W] int32; blocks [B, h, w] int32; xs, ys, mvx, mvy [B] int32
// (block origins and full-pel MVs); fpen [49] float32; winner 0 or 1 ->
// best [B] int32, costs [B, 49] float32, and preds [B, 49, h, w] int32
// (winner 0) or [B, h, w] int32, the winning offset's (winner 1); preds
// 16-byte aligned
extern "C" int frac_search(const void* ref, int H, int W, const void* blocks,
                           const void* xs, const void* ys, const void* mvx,
                           const void* mvy, int B, int w, int h, int bitdepth,
                           const void* fpen, void* best, void* preds,
                           void* costs, int winner, void* stream) {
  if (bitdepth < 8 || bitdepth > 12 || w < 4 || h < 4 || w > 64 || h > 64 ||
      (w & (w - 1)) || (h & (h - 1)) ||
      reinterpret_cast<uintptr_t>(preds) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const auto* r = static_cast<const int*>(ref);
  const auto* bl = static_cast<const int*>(blocks);
  const auto* x = static_cast<const int*>(xs);
  const auto* y = static_cast<const int*>(ys);
  const auto* mx = static_cast<const int*>(mvx);
  const auto* my = static_cast<const int*>(mvy);
  const auto* fp = static_cast<const float*>(fpen);
  auto* be = static_cast<int*>(best);
  auto* pr = static_cast<int*>(preds);
  auto* co = static_cast<float*>(costs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w == 16 && h == 16)
    e = launch<8, 16, 16>(r, H, W, bl, x, y, mx, my, B, w, h, bitdepth, fp, be,
                          pr, co, winner, st);
  else if (w == 8 && h == 8)
    e = launch<8, 8, 8>(r, H, W, bl, x, y, mx, my, B, w, h, bitdepth, fp, be,
                        pr, co, winner, st);
  else if (w >= 8 && h >= 8)
    e = launch<8, 0, 0>(r, H, W, bl, x, y, mx, my, B, w, h, bitdepth, fp, be,
                        pr, co, winner, st);
  else
    e = launch<4, 0, 0>(r, H, W, bl, x, y, mx, my, B, w, h, bitdepth, fp, be,
                        pr, co, winner, st);
  return static_cast<int>(e);
}

UVG_ERROR_ENTRY(frac_search)
