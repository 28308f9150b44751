// K4 rd_cost: mode decision and rate-distortion cost of every block of a class.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:78 make_rd_cost_fn (after its SATD,
// which is K3). Per block:
//   best = argmin_m float(satd[m]) + sqrt(lam) * mode_bits[m]  (first minimum)
//   resid = src - preds[best]
//   t    = int16((resid @ Mw^T + (1 << (s1-1))) >> s1)
//   coef = int16((Mh @ t + (1 << (s2-1))) >> s2)
//   level = clip((|coef| * scale + add) >> q_bits, 0, 32767)
//   bits  = sum wts[min(level, 3)]                                  (float32)
//   dq = clip((sign(coef) * level * iscale + (1 << (dq_shift-1))) >> dq_shift)
//   u  = clip16((Mh^T @ dq + (1 << (si1-1))) >> si1)
//   r  = clip16((u @ Mw + (1 << (si2-1))) >> si2)
//   ssd = sum (src - clip(preds[best] + r, 0, max))^2                (int32)
//   rd  = float(ssd) + lam * (bits + mode_bits[best])
// Integer steps wrap like the reference's int32 (its int64 casts are int32
// with x64 off): the products that can overflow (level, dequant, SSD) are
// done in uint32. The library is built with --fmad=false and sqrtf is the
// IEEE square root, so each float operation rounds as the reference's does.
// The bits sum is taken as per-bucket counts times wts, ((c0*w0 + c1*w1) +
// c2*w2) + c3*w3, which does not depend on a summation order; the plain
// version computes the same expression.
//
// Bound on this card: operations, barely. Four w*h*max(w,h) integer
// multiply-add passes per block (1 M at 64x64) against reading one
// prediction and one source block; about 0.2 G int32 operations and 8 MB
// per 832x480 frame. Design: one thread block per block; the residual, the
// transform stages and both DCT2 matrices (int8: entries are within +-90)
// live in shared memory (40 KB at 64x64); each pass is a loop of threads
// over output samples; the argmin runs in one warp with a (cost, index)
// lexicographic shuffle reduction; bucket counts and the SSD are reduced
// with shared-memory integer atomics, which are exact in any order.

#include <algorithm>

#include "common.cuh"

namespace {

struct Params {
  int w, h, log2_w, s1, s2, si1, si2, q_bits, scale, add, iscale, dq_shift,
      max_pix;
  float lam;
};

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(v));
}

__device__ __forceinline__ int clip16(int v) { return uvg::clampi(v, -32768, 32767); }

__global__ void rd_cost_kernel(const int* __restrict__ preds,
                               const int* __restrict__ src,
                               const int* __restrict__ satds,
                               const int8_t* __restrict__ mat_w,
                               const int8_t* __restrict__ mat_h,
                               const float* __restrict__ wts,
                               const float* __restrict__ mode_bits, Params p,
                               int* __restrict__ best_out,
                               float* __restrict__ rd_out,
                               int* __restrict__ satd_out) {
  extern __shared__ int smem[];
  const int w = p.w, h = p.h, hw = w * h;
  int* A = smem;                                   // [h, w]
  int* Bf = smem + hw;                             // [h, w]
  int8_t* Mw = reinterpret_cast<int8_t*>(smem + 2 * hw);   // [w, w]
  int8_t* Mh = Mw + w * w;                         // [h, h]
  __shared__ int best_s;
  __shared__ int cnt[4];
  __shared__ unsigned ssd_s;
  const int cu = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (tid < 32) {
    // first minimum of satd + sqrt(lam) * mode_bits over the 67 modes
    const float lam_sqrt = __fsqrt_rn(p.lam);
    float bc = 0.f;
    int bi = -1;
    for (int m = tid; m < uvg::NUM_MODES; m += 32) {
      const float c = __fadd_rn(__int2float_rn(satds[cu * uvg::NUM_MODES + m]),
                                __fmul_rn(lam_sqrt, mode_bits[m]));
      if (bi < 0 || c < bc) { bc = c; bi = m; }
    }
    for (int o = 16; o >= 1; o >>= 1) {
      const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (oi >= 0 && (bi < 0 || oc < bc || (oc == bc && oi < bi))) { bc = oc; bi = oi; }
    }
    if (tid == 0) {
      best_s = bi;
      ssd_s = 0u;
      cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    }
  }
  for (int i = tid; i < w * w; i += nt) Mw[i] = mat_w[i];
  for (int i = tid; i < h * h; i += nt) Mh[i] = mat_h[i];
  __syncthreads();
  const int best = best_s;
  const int* pred = preds + (static_cast<long long>(cu) * uvg::NUM_MODES + best) * hw;
  const int* sb = src + static_cast<long long>(cu) * hw;
  for (int i = tid; i < hw; i += nt) A[i] = sb[i] - pred[i];
  __syncthreads();
  // forward, rows: Bf[y][k] = int16((sum_x A[y][x] * Mw[k][x] + rnd) >> s1)
  for (int i = tid; i < hw; i += nt) {
    const int y = i >> p.log2_w, k = i & (w - 1);
    int acc = 0;
    for (int x = 0; x < w; ++x) acc += A[y * w + x] * Mw[k * w + x];
    Bf[i] = wrap16((acc + (1 << (p.s1 - 1))) >> p.s1);
  }
  __syncthreads();
  // forward, columns: A[k2][k] = int16((sum_y Mh[k2][y] * Bf[y][k] + rnd) >> s2)
  for (int i = tid; i < hw; i += nt) {
    const int k2 = i >> p.log2_w, k = i & (w - 1);
    int acc = 0;
    for (int y = 0; y < h; ++y) acc += Mh[k2 * h + y] * Bf[y * w + k];
    A[i] = wrap16((acc + (1 << (p.s2 - 1))) >> p.s2);
  }
  __syncthreads();
  // quant, bucket counts, dequant (in place)
  int c_loc[4] = {0, 0, 0, 0};
  for (int i = tid; i < hw; i += nt) {
    const int c = A[i];
    const int a = abs(c);
    int level = uvg::wrap_mul_add(a, p.scale, p.add) >> p.q_bits;
    level = uvg::clampi(level, 0, 32767);
    c_loc[min(level, 3)] += 1;
    const int sgn = (c > 0) - (c < 0);
    const int dq = uvg::wrap_mul_add(sgn * level, p.iscale, 1 << (p.dq_shift - 1)) >> p.dq_shift;
    A[i] = clip16(dq);
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (c_loc[b]) atomicAdd(&cnt[b], c_loc[b]);
  __syncthreads();
  // inverse, columns: Bf[y][k] = clip16((sum_k2 Mh[k2][y] * A[k2][k] + rnd) >> si1)
  for (int i = tid; i < hw; i += nt) {
    const int y = i >> p.log2_w, k = i & (w - 1);
    int acc = 0;
    for (int k2 = 0; k2 < h; ++k2) acc += Mh[k2 * h + y] * A[k2 * w + k];
    Bf[i] = clip16((acc + (1 << (p.si1 - 1))) >> p.si1);
  }
  __syncthreads();
  // inverse, rows, reconstruction and SSD
  unsigned ssd = 0u;
  for (int i = tid; i < hw; i += nt) {
    const int y = i >> p.log2_w, x = i & (w - 1);
    int acc = 0;
    for (int k = 0; k < w; ++k) acc += Bf[y * w + k] * Mw[k * w + x];
    const int r = clip16((acc + (1 << (p.si2 - 1))) >> p.si2);
    const int rec = uvg::clampi(pred[i] + r, 0, p.max_pix);
    const int d = sb[i] - rec;
    ssd += static_cast<unsigned>(d) * static_cast<unsigned>(d);
  }
  atomicAdd(&ssd_s, ssd);
  __syncthreads();
  if (tid == 0) {
    const float bits = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(cnt[0]), wts[0]),
                            __fmul_rn(__int2float_rn(cnt[1]), wts[1])),
                  __fmul_rn(__int2float_rn(cnt[2]), wts[2])),
        __fmul_rn(__int2float_rn(cnt[3]), wts[3]));
    const float ssd_f = __int2float_rn(static_cast<int>(ssd_s));
    best_out[cu] = best;
    rd_out[cu] = __fadd_rn(ssd_f, __fmul_rn(p.lam, __fadd_rn(bits, mode_bits[best])));
    satd_out[cu] = satds[cu * uvg::NUM_MODES + best];
  }
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

extern "C" int rd_cost(const void* preds, const void* src, const void* satds,
                       int B, int w, int h, const void* mat_w,
                       const void* mat_h, const void* wts,
                       const void* mode_bits, int bitdepth, int q_bits,
                       int scale, int add, int iscale, int dq_shift, float lam,
                       void* best, void* rd, void* satd_best, void* stream) {
  const int lw = log2i(w), lh = log2i(h);
  // transforms.py fwd_shifts / inv_shifts
  Params p{w, h, lw, lw - 1 + bitdepth - 8, lh - 1 + 7, 7, 20 - bitdepth,
           q_bits, scale, add, iscale, dq_shift, (1 << bitdepth) - 1, lam};
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = 2 * static_cast<size_t>(w) * h * sizeof(int) + w * w + h * h;
  rd_cost_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(preds), static_cast<const int*>(src),
      static_cast<const int*>(satds), static_cast<const int8_t*>(mat_w),
      static_cast<const int8_t*>(mat_h), static_cast<const float*>(wts),
      static_cast<const float*>(mode_bits), p, static_cast<int*>(best),
      static_cast<float*>(rd), static_cast<int*>(satd_best));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(rd_cost)
