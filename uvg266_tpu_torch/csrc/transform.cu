// K13 fwd_transform / inv_transform: the batched separable 2-D integer
// transforms (DCT2, DST7, DCT8) of w x h blocks, w and h up to 64.
//
// Replaces: uvg266_tpu/ops/transforms.py:86 make_fwd_fn (entry
// fwd_transform) and :112 make_inv_fn (entry inv_transform). With Mw the
// horizontal and Mh the vertical matrix (rows = frequencies):
//   forward  t = int16((x @ Mw^T + (1 << (s1-1))) >> s1)
//            c = int16((Mh @ t + (1 << (s2-1))) >> s2), zero outside the
//                kept rectangle (keep_h, keep_w)
//   inverse  u = clip16((Mh^T @ c + (1 << (s1-1))) >> s1)
//            x = clip16((u @ Mw + (1 << (s2-1))) >> s2)
// The products and the rounding add are int32 that wraps as the
// reference's does (done in uint32), the shifts arithmetic.
//
// Bound on this card: bytes, at the frame's shapes (an int32 sample in and
// an int16 sample out, against a partial butterfly's few operations a
// sample). Design: the simple form first. One thread block of 256 threads
// per transform block, or 256 / (w*h) blocks per thread block below 256
// samples; the blocks and both int8 matrices in shared memory (the forward's
// horizontal matrix transposed, so a warp reads consecutive bytes); one
// thread per sample of each pass as a plain dot product, the passes split by
// a barrier. The forward skips the columns and rows that zero_out drops.
// Butterflies or tensor cores (split-int8 IMMA, FP64 DMMA) are later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_N = 64;

// transform blocks per thread block
inline int per_cta(int hw) { return hw >= THREADS ? 1 : THREADS / hw; }

inline size_t transform_smem(int nb, int w, int h) {
  return 2 * static_cast<size_t>(nb) * w * h * sizeof(int) + w * w + h * h;
}

// the thread block's blocks (int32) into shared memory; returns their count
__device__ __forceinline__ int load_blocks(const int* __restrict__ src, int B,
                                           int nb, int hw, int* dst) {
  const int b0 = blockIdx.x * nb;
  const int n = min(nb, B - b0) * hw;
  const int* g = src + static_cast<long long>(b0) * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = g[i];
  return n;
}

__global__ void fwd_transform_kernel(const int* __restrict__ x, int B, int w,
                                     int h, int nb,
                                     const int8_t* __restrict__ mat_w,
                                     const int8_t* __restrict__ mat_h, int s1,
                                     int s2, int keep_w, int keep_h,
                                     int16_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int hw = w * h;
  int* xs = smem;                                           // [nb, h, w]
  int* ts = xs + nb * hw;                                   // [nb, h, w]
  int8_t* mwt = reinterpret_cast<int8_t*>(ts + nb * hw);    // Mw^T [w, w]
  int8_t* mh = mwt + w * w;                                 // Mh [h, h]
  const int n = load_blocks(x, B, nb, hw, xs);
  for (int i = threadIdx.x; i < w * w; i += blockDim.x)
    mwt[(i % w) * w + i / w] = mat_w[i];
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) mh[i] = mat_h[i];
  __syncthreads();
  // rows: t[y][k] = int16((sum_j x[y][j] Mw[k][j] + r1) >> s1), k < keep_w
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i % w;
    if (k >= keep_w) continue;
    const int* row = xs + (i - k);
    int acc = 1 << (s1 - 1);
    for (int j = 0; j < w; ++j)
      acc = uvg::wrap_mul_add(row[j], mwt[j * w + k], acc);
    ts[i] = uvg::wrap16(acc >> s1);
  }
  __syncthreads();
  // columns: c[k][x] = int16((sum_y Mh[k][y] t[y][x] + r2) >> s2), zero
  // outside (keep_h, keep_w)
  int16_t* o = out + static_cast<long long>(blockIdx.x) * nb * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int xx = i % w;
    const int k = (i / w) % h;
    int v = 0;
    if (xx < keep_w && k < keep_h) {
      const int* col = ts + (i - (i % hw)) + xx;
      const int8_t* m = mh + k * h;
      int acc = 1 << (s2 - 1);
      for (int y = 0; y < h; ++y)
        acc = uvg::wrap_mul_add(m[y], col[y * w], acc);
      v = uvg::wrap16(acc >> s2);
    }
    o[i] = static_cast<int16_t>(v);
  }
}

__global__ void inv_transform_kernel(const int* __restrict__ c, int B, int w,
                                     int h, int nb,
                                     const int8_t* __restrict__ mat_w,
                                     const int8_t* __restrict__ mat_h, int s1,
                                     int s2, int16_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int hw = w * h;
  int* cs = smem;                                           // [nb, h, w]
  int* us = cs + nb * hw;                                   // [nb, h, w]
  int8_t* mw = reinterpret_cast<int8_t*>(us + nb * hw);     // Mw [w, w]
  int8_t* mh = mw + w * w;                                  // Mh [h, h]
  const int n = load_blocks(c, B, nb, hw, cs);
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) mw[i] = mat_w[i];
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) mh[i] = mat_h[i];
  __syncthreads();
  // columns: u[y][x] = clip16((sum_k Mh[k][y] c[k][x] + r1) >> s1)
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int xx = i % w;
    const int y = (i / w) % h;
    const int* col = cs + (i - (i % hw)) + xx;
    int acc = 1 << (s1 - 1);
    for (int k = 0; k < h; ++k)
      acc = uvg::wrap_mul_add(mh[k * h + y], col[k * w], acc);
    us[i] = uvg::clip16(acc >> s1);
  }
  __syncthreads();
  // rows: x[y][j] = clip16((sum_k u[y][k] Mw[k][j] + r2) >> s2)
  int16_t* o = out + static_cast<long long>(blockIdx.x) * nb * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i % w;
    const int* row = us + (i - j);
    int acc = 1 << (s2 - 1);
    for (int k = 0; k < w; ++k)
      acc = uvg::wrap_mul_add(row[k], mw[k * w + j], acc);
    o[i] = static_cast<int16_t>(uvg::clip16(acc >> s2));
  }
}

bool bad_shape(int B, int w, int h) {
  return B < 0 || w < 1 || h < 1 || w > MAX_N || h > MAX_N;
}

}  // namespace

extern "C" int fwd_transform(const void* x, int B, int w, int h,
                             const void* mat_w, const void* mat_h, int s1,
                             int s2, int keep_w, int keep_h, void* out,
                             void* stream) {
  if (bad_shape(B, w, h) || s1 < 1 || s2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int nb = per_cta(w * h);
  fwd_transform_kernel<<<(B + nb - 1) / nb, THREADS,
                         transform_smem(nb, w, h),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), B, w, h, nb,
      static_cast<const int8_t*>(mat_w), static_cast<const int8_t*>(mat_h), s1,
      s2, keep_w, keep_h, static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int inv_transform(const void* c, int B, int w, int h,
                             const void* mat_w, const void* mat_h, int s1,
                             int s2, void* out, void* stream) {
  if (bad_shape(B, w, h) || s1 < 1 || s2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int nb = per_cta(w * h);
  inv_transform_kernel<<<(B + nb - 1) / nb, THREADS,
                         transform_smem(nb, w, h),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c), B, w, h, nb,
      static_cast<const int8_t*>(mat_w), static_cast<const int8_t*>(mat_h), s1,
      s2, static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(fwd_transform)
UVG_ERROR_ENTRY(inv_transform)
