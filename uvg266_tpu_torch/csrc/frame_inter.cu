// K7 frame_inter: whole-frame dense full-pel motion search against one
// reference, for every size class of the partition lattice.
//
// Replaces: uvg266_tpu/ops/me_frame.py:159 make_frame_inter_fn, up to its
// RD cost (K6, rd_cost_pred.cu, which the wrapper launches next). Two
// kernels per call:
//
// 1. tile SSD maps. For every 8x8 tile t of src [H, W] and every full-pel
//    offset (dy, dx) in [-r, r]^2, k = (dy + r) * n + (dx + r), n = 2r + 1:
//      ssd[t][k] = sum_ij (src[8ty + i][8tx + j]
//                          - ref_pad[8ty + dy + r + i][8tx + dx + r + j])^2
//    ref_pad [H + 2r, W + 2r] is the edge-padded reference. The reference
//    builds this map as b^2 - 2 corr + r^2 in float32 through grouped
//    convolutions; at 8 bits every term and partial sum is an integer
//    below 2^24, so it is exactly this integer SSD (< 2^23).
// 2. per class (w, h, grid) and per block b at (x, y) of the grid:
//      acc[k] = float32 sum of the tiles' ssd[.][k] in (i, j) raster order
//               (the order of class_block_maps, me_frame.py:90-95)
//      idx    = first argmin_k float32(acc[k] + pen[k])
//      pred   = ref_pad[y + dy + r + i][x + dx + r + j]   (a plain gather;
//               the reference selects it with one-hot matmuls)
//      blk    = src[y + i][x + j],  extra = bits_tab[idx]
//    A 32x32 block sums 16 tiles and can pass 2^24, so the float32 sum in
//    the reference's order is kept: an exact integer sum rounded once
//    would move argmins.
//
// Bound on this card: operations. The SSD maps take 3 operations per
// sample and offset (64 * 1089 * 3 per tile, 1.3 G at 832x480) against
// 1.6 MB of planes read and 27 MB of maps written. Design: one thread block
// per tile with the tile and its (8 + 2r)^2 window (6.4 KB at r = 16) in
// shared memory, one thread per offset, neighbouring threads on
// neighbouring offsets (conflict-free shared reads, coalesced map writes);
// the class pass has one thread block per block, one thread per offset,
// and a (cost, index) lexicographic shuffle reduction for the first
// minimum. The map stays in device memory (L2-resident at this size)
// between the two kernels.

#include "common.cuh"

namespace {

constexpr int TILE = 8;
constexpr int NCLS = 10;   // ints per class record, see frame_inter()

__global__ void tile_ssd_kernel(const int* __restrict__ src,
                                const int* __restrict__ ref_pad, int W, int TX,
                                int r, int* __restrict__ ssd) {
  extern __shared__ int win[];                // [side, side]
  __shared__ int tile[TILE * TILE];
  const int n = 2 * r + 1, nn = n * n, side = TILE + 2 * r;
  const int Wp = W + 2 * r;
  const int t = blockIdx.x;
  const int ty = t / TX, tx = t % TX;
  for (int i = threadIdx.x; i < side * side; i += blockDim.x)
    win[i] = ref_pad[static_cast<long long>(ty * TILE + i / side) * Wp
                     + tx * TILE + i % side];
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x)
    tile[i] = src[static_cast<long long>(ty * TILE + i / TILE) * W
                  + tx * TILE + i % TILE];
  __syncthreads();
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    const int a = k / n, b = k % n;
    int acc = 0;
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        const int d = tile[i * TILE + j] - win[(a + i) * side + b + j];
        acc += d * d;
      }
    }
    ssd[static_cast<long long>(t) * nn + k] = acc;
  }
}

struct Cls {
  int w, h, x0, y0, sx, sy, gx, b_off;
  long long px_off;
};

__global__ void block_search_kernel(const int* __restrict__ src,
                                    const int* __restrict__ ref_pad,
                                    const int* __restrict__ ssd,
                                    const float* __restrict__ pen,
                                    const float* __restrict__ bits_tab, int W,
                                    int TX, int r, Cls c,
                                    int* __restrict__ idx_out,
                                    int* __restrict__ pred_out,
                                    int* __restrict__ blk_out,
                                    float* __restrict__ extra_out) {
  __shared__ float wc[32];
  __shared__ int wi[32];
  __shared__ int best_s;
  const int n = 2 * r + 1, nn = n * n;
  const int b = blockIdx.x;
  const int bx = b % c.gx, by = b / c.gx;
  const int x = c.x0 + bx * c.sx, y = c.y0 + by * c.sy;
  const int tx0 = x / TILE, ty0 = y / TILE;
  const int wT = c.w / TILE, hT = c.h / TILE;
  float bc = 0.f;
  int bi = -1;
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < hT; ++i) {
      for (int j = 0; j < wT; ++j) {
        const float v = __int2float_rn(
            ssd[static_cast<long long>((ty0 + i) * TX + tx0 + j) * nn + k]);
        acc = (i == 0 && j == 0) ? v : __fadd_rn(acc, v);
      }
    }
    const float cost = __fadd_rn(acc, pen[k]);
    if (bi < 0 || cost < bc) { bc = cost; bi = k; }
  }
  for (int o = 16; o >= 1; o >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (oi >= 0 && (bi < 0 || oc < bc || (oc == bc && oi < bi))) { bc = oc; bi = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { wc[warp] = bc; wi[warp] = bi; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < (blockDim.x + 31) / 32; ++q) {
      const float oc = wc[q];
      const int oi = wi[q];
      if (oi >= 0 && (bi < 0 || oc < bc || (oc == bc && oi < bi))) { bc = oc; bi = oi; }
    }
    best_s = bi;
    idx_out[c.b_off + b] = bi;
    extra_out[c.b_off + b] = bits_tab[bi];
  }
  __syncthreads();
  const int k = best_s;
  const int dy = k / n - r, dx = k % n - r;
  const int Wp = W + 2 * r;
  const long long o = c.px_off + static_cast<long long>(b) * c.w * c.h;
  for (int p = threadIdx.x; p < c.w * c.h; p += blockDim.x) {
    const int i = p / c.w, j = p % c.w;
    pred_out[o + p] = ref_pad[static_cast<long long>(y + dy + r + i) * Wp
                              + x + dx + r + j];
    blk_out[o + p] = src[static_cast<long long>(y + i) * W + x + j];
  }
}

}  // namespace

// classes: host array of n_classes records of NCLS ints
//   (w, h, x0, y0, sx, sy, gx, gy, b_off, px_off): the grid, and where the
//   class's blocks start in the idx/extra outputs (b_off) and in the
//   pred/blk outputs (px_off, in samples). ssd: scratch [(H/8)*(W/8), n*n].
extern "C" int frame_inter(const void* src, const void* ref_pad, int H, int W,
                           int r, const void* pen, const void* bits_tab,
                           const void* classes, int n_classes, void* ssd,
                           void* idx, void* pred, void* blk, void* extra,
                           void* stream) {
  if (H % TILE || W % TILE || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int TY = H / TILE, TX = W / TILE;
  const int side = TILE + 2 * r;
  const size_t smem = static_cast<size_t>(side) * side * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (TY * TX > 0)
    tile_ssd_kernel<<<TY * TX, 256, smem, st>>>(
        static_cast<const int*>(src), static_cast<const int*>(ref_pad), W, TX,
        r, static_cast<int*>(ssd));
  const int* cl = static_cast<const int*>(classes);
  for (int q = 0; q < n_classes; ++q) {
    const int* e = cl + q * NCLS;
    const int w = e[0], h = e[1], gx = e[6], gy = e[7];
    if (w % TILE || h % TILE || e[2] % TILE || e[3] % TILE || e[4] % TILE
        || e[5] % TILE)
      return static_cast<int>(cudaErrorInvalidValue);
    if (gx * gy <= 0) continue;
    const Cls c{w, h, e[2], e[3], e[4], e[5], gx, e[8], static_cast<long long>(e[9])};
    block_search_kernel<<<gx * gy, 256, 0, st>>>(
        static_cast<const int*>(src), static_cast<const int*>(ref_pad),
        static_cast<const int*>(ssd), static_cast<const float*>(pen),
        static_cast<const float*>(bits_tab), W, TX, r, c,
        static_cast<int*>(idx), static_cast<int*>(pred), static_cast<int*>(blk),
        static_cast<float*>(extra));
  }
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(frame_inter)
