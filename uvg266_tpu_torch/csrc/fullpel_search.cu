// K9a fullpel_search: dense full-pel motion search of every block of a
// class over a (2r+1)^2 window of one reference plane.
//
// Replaces: uvg266_tpu/ops/me.py:40 make_fullpel_search_fn (called by
// control/encoder.py search_inter_blocks). The reference fetches each
// block's edge-extended window (ops/inter.py fetch_extended_block, a clamp
// of coordinates) on the host and computes, for every offset (dy, dx) in
// [-r, r]^2,
//   cost = (b2 - 2 * corr + r2) + pen[dy, dx]
// with b2 = sum blk^2, corr = sum blk * win (a grouped convolution) and
// r2 = the box sum of win^2, each a float32 sum in XLA's order; then the
// first minimum in raster order (dy major). Here each term is the exact
// integer (below 2^32 for a 64x64 block at 10 bits: 4096 * 1023^2),
// rounded to float32 once, and the terms are combined in the reference's
// order: ((b2 - 2*corr) + r2) + pen. Where every term is below 2^24 (8
// bits up to 16x16) this equals the reference bit for bit; elsewhere it is
// the correctly rounded value and the reference's own summation error is
// the difference.
//
// Bound on this card: operations: (2r+1)^2 * h * w multiply-adds for corr
// and as many for r2 per block (about 0.9 G operations per class at
// 832x480, r = 16), against 2 * h * w samples read. Design: one thread
// block per block, its window ((h+2r) x (w+2r), 96 x 96 at 64x64) and the
// block in shared memory as int16; one thread per offset, strided, each
// accumulating corr and r2 in uint32 over the block; a (cost, index)
// reduction picks the first minimum. The window is read from the plane on
// the card through clamped coordinates, as K1 and K10 read theirs.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void fullpel_search_kernel(const int* __restrict__ ref, int H, int W,
                                      const int* __restrict__ blocks,
                                      const int* __restrict__ xs,
                                      const int* __restrict__ ys, int w, int h,
                                      int r, const float* __restrict__ pen,
                                      int* __restrict__ mvx,
                                      int* __restrict__ mvy,
                                      float* __restrict__ cost) {
  extern __shared__ int16_t sm[];
  __shared__ unsigned b2_s;
  __shared__ float red_c[THREADS / 32];
  __shared__ int red_i[THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ww = w + 2 * r, wh = h + 2 * r, hw = w * h;
  int16_t* win = sm;                       // [wh, ww]
  int16_t* blk = sm + ww * wh;             // [h, w]
  const int x0 = xs[b] - r, y0 = ys[b] - r;
  for (int q = tid; q < ww * wh; q += blockDim.x) {
    const int i = q / ww, j = q - (q / ww) * ww;
    win[q] = static_cast<int16_t>(
        ref[static_cast<long long>(uvg::clampi(y0 + i, 0, H - 1)) * W +
            uvg::clampi(x0 + j, 0, W - 1)]);
  }
  if (tid == 0) b2_s = 0u;
  __syncthreads();
  unsigned b2 = 0u;
  const int* bg = blocks + static_cast<long long>(b) * hw;
  for (int q = tid; q < hw; q += blockDim.x) {
    const int v = bg[q];
    blk[q] = static_cast<int16_t>(v);
    b2 += static_cast<unsigned>(v * v);
  }
  atomicAdd(&b2_s, b2);
  __syncthreads();
  const float b2f = __uint2float_rn(b2_s);
  const int n = 2 * r + 1;
  float best_c = INFINITY;
  int best_i = n * n;
  for (int k = tid; k < n * n; k += blockDim.x) {
    const int dy = k / n, dx = k - (k / n) * n;
    unsigned corr = 0u, r2 = 0u;
    for (int i = 0; i < h; ++i) {
      const int16_t* wr = win + (dy + i) * ww + dx;
      const int16_t* br = blk + i * w;
      for (int j = 0; j < w; ++j) {
        const unsigned a = static_cast<unsigned>(wr[j]);
        corr += a * static_cast<unsigned>(br[j]);
        r2 += a * a;
      }
    }
    float c = __fsub_rn(b2f, __fmul_rn(2.0f, __uint2float_rn(corr)));
    c = __fadd_rn(c, __uint2float_rn(r2));
    c = __fadd_rn(c, pen[k]);
    if (c < best_c) {                      // k ascends: first minimum
      best_c = c;
      best_i = k;
    }
  }
  // (cost, index) reduction: the smaller cost, on a tie the smaller index
  for (int o = 16; o >= 1; o >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, best_c, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (oc < best_c || (oc == best_c && oi < best_i)) {
      best_c = oc;
      best_i = oi;
    }
  }
  if ((tid & 31) == 0) {
    red_c[tid >> 5] = best_c;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int q = 1; q < static_cast<int>(blockDim.x) / 32; ++q) {
      if (red_c[q] < best_c || (red_c[q] == best_c && red_i[q] < best_i)) {
        best_c = red_c[q];
        best_i = red_i[q];
      }
    }
    mvx[b] = best_i % n - r;
    mvy[b] = best_i / n - r;
    cost[b] = best_c;
  }
}

}  // namespace

// ref [H, W] int32 plane; blocks [B, h, w] int32; xs, ys [B] int32 block
// origins; pen [(2r+1)^2] float32 -> mvx, mvy [B] int32, cost [B] float32
extern "C" int fullpel_search(const void* ref, int H, int W, const void* blocks,
                              const void* xs, const void* ys, int B, int w,
                              int h, int r, const void* pen, void* mvx,
                              void* mvy, void* cost, void* stream) {
  const size_t smem = sizeof(int16_t) *
      (static_cast<size_t>(w + 2 * r) * (h + 2 * r) + static_cast<size_t>(w) * h);
  if (r < 0 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  fullpel_search_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ref), H, W, static_cast<const int*>(blocks),
      static_cast<const int*>(xs), static_cast<const int*>(ys), w, h, r,
      static_cast<const float*>(pen), static_cast<int*>(mvx),
      static_cast<int*>(mvy), static_cast<float*>(cost));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(fullpel_search)
