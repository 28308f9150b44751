// K9b frac_search: quarter-pel refinement of every block of a class around
// its full-pel motion vector.
//
// Replaces: uvg266_tpu/ops/me.py:79 make_frac_search_fn (called by
// control/encoder.py search_inter_blocks after K9a). For each block b and
// each of the 49 offsets k, (dx, dy) = (k % 7 - 3, k / 7 - 3) in quarter
// pels around the full-pel MV:
//   preds[b, k] = the 8-tap luma interpolation of the reference at that
//                 phase (common.cuh qpel_sample, shared with K8
//                 leaf_qpel.cu), the window itself at k = 24;
//   satd        = satd_bw of src - pred: the n x n Hadamard of every
//                 sub-block (n = 8 when w, h >= 8, else 4),
//                 s = sum|t| - |t00| + (|t00| >> 2), (s + 2) >> 2
//                 ((s + 1) >> 1 at n = 4), summed over the sub-blocks as
//                 an integer;
//   costs[b, k] = float32(satd) + fpen[k];
// then best[b] = the first minimum over k. All integer work: the outputs
// equal the reference's exactly.
//
// Bound on this card: bytes at the small classes, by the write of preds
// [B, 49, h, w] int32 (78 MB for the 8x8 class at 832x480), and
// operations near them (64 multiply-adds a sample for the interpolation
// done directly, about 2 * 8 adds for the Hadamard). Design: one thread
// block per (block, offset); the (h+10) x (w+10) window, read from the
// plane on the card through clamped coordinates at the block's full-pel
// MV, sits in shared memory as int16; one thread per sample interpolates
// its sample from the window, stores it and its difference; the two
// Hadamard passes go through shared memory; the per-sub-block sums gather
// in shared memory by atomic adds (integers: order-free). A second kernel
// takes the first minimum of each block's 49 costs.

#include "common.cuh"

namespace {

constexpr int PAD = 5, NOFF = 49;

__global__ void frac_search_kernel(const int* __restrict__ ref, int H, int W,
                                   const int* __restrict__ blocks,
                                   const int* __restrict__ xs,
                                   const int* __restrict__ ys,
                                   const int* __restrict__ mvx,
                                   const int* __restrict__ mvy, int w, int h,
                                   int bitdepth, const float* __restrict__ fpen,
                                   int* __restrict__ preds,
                                   float* __restrict__ costs) {
  extern __shared__ int sm[];
  const int b = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int hw = w * h, ww = w + 2 * PAD, wh = h + 2 * PAD;
  const int log2_w = 31 - __clz(w);
  const int n = (w >= 8 && h >= 8) ? 8 : 4;
  const int log2_n = n == 8 ? 3 : 2;
  const int nsb_x = w >> log2_n;
  const int nsb = nsb_x * (h >> log2_n);
  int* d = sm;                                          // [h, w]
  int* t = sm + hw;                                     // [h, w]
  int* sums = sm + 2 * hw;                              // [nsb]
  int16_t* win = reinterpret_cast<int16_t*>(sm + 2 * hw + nsb);   // [wh, ww]
  const int x0 = xs[b] + mvx[b] - PAD, y0 = ys[b] + mvy[b] - PAD;
  for (int q = tid; q < ww * wh; q += blockDim.x) {
    const int i = q / ww, j = q - (q / ww) * ww;
    win[q] = static_cast<int16_t>(
        ref[static_cast<long long>(uvg::clampi(y0 + i, 0, H - 1)) * W +
            uvg::clampi(x0 + j, 0, W - 1)]);
  }
  for (int q = tid; q < nsb; q += blockDim.x) sums[q] = 0;
  __syncthreads();
  const int ox = 4 * (k % 7 - 3), oy = 4 * (k / 7 - 3);
  const int ix = ox >> 4, iy = oy >> 4, fx = ox & 15, fy = oy & 15;
  const int* bg = blocks + static_cast<long long>(b) * hw;
  int* pg = preds + (static_cast<long long>(b) * NOFF + k) * hw;
  for (int p = tid; p < hw; p += blockDim.x) {
    const int i = p >> log2_w, j = p & (w - 1);
    const int pred = uvg::qpel_sample(win + (PAD + iy + i) * ww + PAD + ix + j,
                                      ww, fx, fy, bitdepth);
    pg[p] = pred;
    d[p] = bg[p] - pred;
  }
  __syncthreads();
  // rows: t[i][j] = sum_c d[i][jb + c] * H[c][j % n]
  for (int p = tid; p < hw; p += blockDim.x) {
    const int i = p >> log2_w, j = p & (w - 1);
    const int jb = j & ~(n - 1), jn = j & (n - 1);
    int acc = 0;
    for (int c = 0; c < n; ++c) acc += uvg::had_sign(c, jn) * d[i * w + jb + c];
    t[p] = acc;
  }
  __syncthreads();
  // columns: u[i][j] = sum_c H[i % n][c] * t[ib + c][j]; |u|, the DC term
  // of each sub-block taken as |u| >> 2
  for (int p = tid; p < hw; p += blockDim.x) {
    const int i = p >> log2_w, j = p & (w - 1);
    const int ib = i & ~(n - 1), in = i & (n - 1);
    int acc = 0;
    for (int c = 0; c < n; ++c) acc += uvg::had_sign(in, c) * t[(ib + c) * w + j];
    const int a = abs(acc);
    const bool dc = in == 0 && (j & (n - 1)) == 0;
    atomicAdd(&sums[(i >> log2_n) * nsb_x + (j >> log2_n)], dc ? (a >> 2) : a);
  }
  __syncthreads();
  if (tid == 0) {
    const int add = n == 8 ? 2 : 1, shift = n == 8 ? 2 : 1;
    int tot = 0;
    for (int q = 0; q < nsb; ++q) tot += (sums[q] + add) >> shift;
    costs[static_cast<long long>(b) * NOFF + k] =
        __fadd_rn(__int2float_rn(tot), fpen[k]);
  }
}

__global__ void frac_best_kernel(const float* __restrict__ costs, int B,
                                 int* __restrict__ best) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* c = costs + static_cast<long long>(b) * NOFF;
  int bi = 0;
  float bc = c[0];
  for (int q = 1; q < NOFF; ++q)
    if (c[q] < bc) {
      bc = c[q];
      bi = q;
    }
  best[b] = bi;
}

}  // namespace

// ref [H, W] int32; blocks [B, h, w] int32; xs, ys, mvx, mvy [B] int32
// (block origins and full-pel MVs); fpen [49] float32 -> best [B] int32,
// preds [B, 49, h, w] int32, costs [B, 49] float32
extern "C" int frac_search(const void* ref, int H, int W, const void* blocks,
                           const void* xs, const void* ys, const void* mvx,
                           const void* mvy, int B, int w, int h, int bitdepth,
                           const void* fpen, void* best, void* preds,
                           void* costs, void* stream) {
  if (bitdepth < 8 || bitdepth > 12 || w < 4 || h < 4 || (w & (w - 1)) ||
      (h & (h - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = (w >= 8 && h >= 8) ? 8 : 4;
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(w) * h +
                                     static_cast<size_t>(w / n) * (h / n)) +
                      sizeof(int16_t) * static_cast<size_t>(w + 2 * PAD) * (h + 2 * PAD);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = w * h >= 256 ? 256 : (w * h < 32 ? 32 : w * h);
  frac_search_kernel<<<dim3(B, NOFF), threads, smem, st>>>(
      static_cast<const int*>(ref), H, W, static_cast<const int*>(blocks),
      static_cast<const int*>(xs), static_cast<const int*>(ys),
      static_cast<const int*>(mvx), static_cast<const int*>(mvy), w, h, bitdepth,
      static_cast<const float*>(fpen), static_cast<int*>(preds),
      static_cast<float*>(costs));
  frac_best_kernel<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(costs), B, static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(frac_search)
