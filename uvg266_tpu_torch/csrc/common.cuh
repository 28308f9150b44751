// Shared helpers of the port's kernels. Each kernel source is built into a
// shared library of its own with a plain C interface (see kernels/__init__.py);
// every entry enqueues on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace uvg {

constexpr int REF_LEN = 195;          // 3 * 64 + 3, ops/intra_batch.py REF_LEN
constexpr int NREF = 4 * REF_LEN;     // [top | left | ftop | fleft]
constexpr int NUM_MODES = 67;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// int32 arithmetic that wraps like the reference's (x64 off: its int64
// casts are int32): done in uint32, whose overflow is defined
__device__ __forceinline__ int wrap_mul_add(int a, int b, int c) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b) +
                          static_cast<uint32_t>(c));
}

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(v));
}

__device__ __forceinline__ int clip16(int v) { return clampi(v, -32768, 32767); }

inline int grid_for(long long n, int threads, int cap = 132 * 32) {
  long long g = (n + threads - 1) / threads;
  return static_cast<int>(g < 1 ? 1 : (g > cap ? cap : g));
}

inline int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// --- the RD tail of K4 (rd_cost.cu), K6 (rd_cost_pred.cu) and K11
// (mts_search.cu) -----------------------------------------------------------
// One block's transform -> int16 -> transform -> int16 -> quant -> dequant
// -> inverse -> reconstruction -> SSD, in the reference's int32 arithmetic
// (ops/rd_cost.py make_rd_cost_fn / make_rd_cost_pred_fn /
// make_mts_search_fn). Mw is the horizontal and Mh the vertical matrix
// (rows = frequencies): DCT2 for K4 and K6, any MTS pair for K11, which
// also keeps only the coefficients below (keep_h, keep_w):
//   t     = int16((resid @ Mw^T + (1 << (s1-1))) >> s1)
//   coef  = int16((Mh @ t + (1 << (s2-1))) >> s2) * mask
//   level = clip((|coef| * scale + add) >> q_bits, 0, 32767)
//   dq    = clip16((sign(coef) * level * iscale + (1 << (dq_shift-1))) >> dq_shift)
//   u     = clip16((Mh^T @ dq + (1 << (si1-1))) >> si1)
//   r     = clip16((u @ Mw + (1 << (si2-1))) >> si2)
//   ssd   = sum (src - clip(pred + r, 0, max))^2         (int32, wrapping)
// and the per-bucket counts of min(level, 3), from which the caller takes
// the bits estimate ((c0*w0 + c1*w1) + c2*w2) + c3*w3 (order-free) and the
// count of nonzero levels (w*h - c0); the DC level on request.

struct RdTail {
  int w, h, log2_w, s1, s2, si1, si2, q_bits, scale, add, iscale, dq_shift,
      max_pix, keep_w, keep_h;
};

inline RdTail rd_tail_params(int w, int h, int bitdepth, int q_bits, int scale,
                             int add, int iscale, int dq_shift) {
  const int lw = log2i(w), lh = log2i(h);
  // transforms.py fwd_shifts / inv_shifts
  return RdTail{w, h, lw, lw - 1 + bitdepth - 8, lh - 1 + 7, 7, 20 - bitdepth,
                q_bits, scale, add, iscale, dq_shift, (1 << bitdepth) - 1, w, h};
}

// shared memory of rd_tail_block beyond its static part: two int planes
// and the two int8 DCT2 matrices
inline size_t rd_tail_smem(int w, int h) {
  return 2 * static_cast<size_t>(w) * h * sizeof(int) + w * w + h * h;
}

// Run by all threads of the block. smem: the dynamic shared memory sized
// by rd_tail_smem; cnt[4] and *ssd_s are shared and must be zero on entry
// (written by one thread before the call is enough: a barrier precedes
// their first use). On return (after a __syncthreads()) they hold the
// block's bucket counts and SSD, and *dc_level (shared; may be null) the
// level of the DC coefficient.
__device__ __forceinline__ void rd_tail_block(
    const int* __restrict__ pred, const int* __restrict__ sb,
    const int8_t* __restrict__ mat_w, const int8_t* __restrict__ mat_h,
    const RdTail& p, int* smem, int* cnt, unsigned* ssd_s,
    int* dc_level = nullptr) {
  const int w = p.w, h = p.h, hw = w * h;
  int* A = smem;                                             // [h, w]
  int* Bf = smem + hw;                                       // [h, w]
  int8_t* Mw = reinterpret_cast<int8_t*>(smem + 2 * hw);     // [w, w]
  int8_t* Mh = Mw + w * w;                                   // [h, h]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < w * w; i += nt) Mw[i] = mat_w[i];
  for (int i = tid; i < h * h; i += nt) Mh[i] = mat_h[i];
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
    const int coef = wrap16((acc + (1 << (p.s2 - 1))) >> p.s2);
    A[i] = (k2 < p.keep_h && k < p.keep_w) ? coef : 0;
  }
  __syncthreads();
  // quant, bucket counts, dequant (in place)
  int c_loc[4] = {0, 0, 0, 0};
  for (int i = tid; i < hw; i += nt) {
    const int c = A[i];
    const int a = abs(c);
    int level = wrap_mul_add(a, p.scale, p.add) >> p.q_bits;
    level = clampi(level, 0, 32767);
    c_loc[min(level, 3)] += 1;
    if (i == 0 && dc_level != nullptr) *dc_level = level;
    const int sgn = (c > 0) - (c < 0);
    const int dq = wrap_mul_add(sgn * level, p.iscale, 1 << (p.dq_shift - 1)) >> p.dq_shift;
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
    const int rec = clampi(pred[i] + r, 0, p.max_pix);
    const int d = sb[i] - rec;
    ssd += static_cast<unsigned>(d) * static_cast<unsigned>(d);
  }
  atomicAdd(ssd_s, ssd);
  __syncthreads();
}

// the bits estimate of rd_tail_block's bucket counts, order-free float32
__device__ __forceinline__ float bucket_bits(const int* cnt, const float* wts) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(cnt[0]), wts[0]),
                          __fmul_rn(__int2float_rn(cnt[1]), wts[1])),
                __fmul_rn(__int2float_rn(cnt[2]), wts[2])),
      __fmul_rn(__int2float_rn(cnt[3]), wts[3]));
}

// --- the angular intra prediction of K2 (predict67.cu) and K12b
// (predict_modes.cu) ------------------------------------------------------
// The per-(mode, sample) tables of ops/intra_batch.py build_mode_tables,
// stored narrow (K int16 x 4 taps, W int8 x 4 weights), and the per-mode
// flags. For mode m >= 2 and sample p of a w x h block, e = m * w*h + p:
//   ang = (sum_t r[K[e,t]] * W[e,t] + 32) >> 6, clipped where needs_clip;
//   gradient PDPC ang += (wl*(side - ang) + 32) >> 6 where pdpc_on;
//   hor/ver PDPC clip(ang + (wl*(side - topleft) + 32) >> 6) where hv_on
// (make_predict_fn / make_predict_modes_fn). Products are < 2^20: int32 is
// exact.
struct AngTables {
  const short4* K;            // [67, h*w] x 4 taps
  const char4* W;             // [67, h*w] x 4 weights
  const int8_t* pdpc_wl;      // [67, h*w]
  const int16_t* pdpc_sidx;   // [67, h*w]
  const int8_t* hv_wl;        // [67, h*w]
  const int16_t* hv_sidx;     // [67, h*w]
  const uint8_t* needs_clip;  // [67]
  const uint8_t* pdpc_on;     // [67]
  const uint8_t* hv_on;       // [67]
  const int16_t* hv_topleft;  // [67]
};

// r: the block's 4*REF_LEN packed references (shared memory)
__device__ __forceinline__ int angular_sample(const int* r, const AngTables& t,
                                              int mode, long long e,
                                              int max_pix) {
  const short4 k = t.K[e];
  const char4 wt = t.W[e];
  int v = (r[k.x] * wt.x + r[k.y] * wt.y + r[k.z] * wt.z + r[k.w] * wt.w + 32) >> 6;
  if (t.needs_clip[mode]) v = clampi(v, 0, max_pix);
  if (t.pdpc_on[mode]) {
    const int side = r[t.pdpc_sidx[e]];
    v = v + ((t.pdpc_wl[e] * (side - v) + 32) >> 6);
  }
  if (t.hv_on[mode]) {
    const int side = r[t.hv_sidx[e]];
    const int tl = r[t.hv_topleft[mode]];
    v = clampi(v + ((t.hv_wl[e] * (side - tl) + 32) >> 6), 0, max_pix);
  }
  return v;
}

}  // namespace uvg

#define UVG_ERROR_ENTRY(name)                                     \
  extern "C" const char* name##_error(int e) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(e));       \
  }
