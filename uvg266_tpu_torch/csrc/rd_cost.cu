// K4 rd_cost: mode decision and rate-distortion cost of every block of a class.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:78 make_rd_cost_fn (after its SATD,
// which is K3). Per block, over its M candidate predictions (the 67 intra
// modes, or the MIP candidates of a class):
//   best = argmin_m float(satd[m]) + sqrt(lam) * mode_bits[m]  (first minimum)
//   bits, ssd = the RD tail of preds[best] (rd_tail.cuh, DCT2 both ways)
//   rd   = float(ssd) + lam * (bits + mode_bits[best])
// Integer steps wrap like the reference's int32 (its int64 casts are int32
// with x64 off): the products that can overflow (level, dequant, SSD) are
// done in uint32. The library is built with --fmad=false and sqrtf is the
// IEEE square root, so each float operation rounds as the reference's does.
// The bits sum is taken as per-bucket counts times wts, ((c0*w0 + c1*w1) +
// c2*w2) + c3*w3, which does not depend on a summation order; the plain
// version computes the same expression.
//
// Bound on this card: bytes (the satds, the winning prediction and the
// source block read once), with the operations of the four transform passes
// as partial butterflies close behind. Design: the RD tail of rd_tail.cuh,
// which K6 (rd_cost_pred.cu) shares: templates over (w, h), so every index
// is a constant expression; w*h/4 threads per block (1024 at 64x64, so the
// 91-block class runs 91 full thread blocks instead of 91 quarter-filled
// ones) and 256 / (w*h/4) blocks per thread block below 32x32 (16 at 8x8),
// all in lockstep between the barriers; each 1-D pass an even/odd partial
// butterfly (butterfly.cuh), half the multiply-adds of the matrix product.
// Before the tail, the argmin runs in each block's first warp (or its own
// lanes below 32 threads) with a (cost, index) lexicographic shuffle
// reduction.

#include "rd_tail.cuh"

namespace {

template <int W, int H>
__global__ void __launch_bounds__(uvg::RdGeo<W, H>::NT)
    rd_cost_kernel(const int* __restrict__ preds, const int* __restrict__ src,
                   const int* __restrict__ satds, const int8_t* __restrict__ mat_w,
                   const int8_t* __restrict__ mat_h, const float* __restrict__ wts,
                   const float* __restrict__ mode_bits, uvg::RdTail p, int B, int M,
                   float lam, int* __restrict__ best_out, float* __restrict__ rd_out,
                   int* __restrict__ satd_out) {
  using G = uvg::RdGeo<W, H>;
  extern __shared__ int4 smem4[];
  const uvg::RdShared<W, H> sh(smem4);
  __shared__ int best_s[G::U];
  __shared__ int cnt[G::U][4];
  __shared__ unsigned ssd_s[G::U];

  const int tid = threadIdx.x;
  const int u = tid / G::T, lt = tid % G::T;
  const int cu = blockIdx.x * G::U + u;
  const bool valid = cu < B;

  sh.load(mat_w, mat_h, tid);

  // first minimum of satd + sqrt(lam) * mode_bits over the M candidates
  {
    constexpr int R = G::T < 32 ? G::T : 32;
    if (lt < R) {
      const float lam_sqrt = __fsqrt_rn(lam);
      float bc = 0.f;
      int bi = -1;
      if (valid) {
        for (int m = lt; m < M; m += R) {
          const float c = __fadd_rn(__int2float_rn(satds[cu * M + m]),
                                    __fmul_rn(lam_sqrt, mode_bits[m]));
          if (bi < 0 || c < bc) { bc = c; bi = m; }
        }
      }
#pragma unroll
      for (int o = R / 2; o >= 1; o >>= 1) {
        const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (oi >= 0 && (bi < 0 || oc < bc || (oc == bc && oi < bi))) { bc = oc; bi = oi; }
      }
      if (lt == 0) {
        best_s[u] = bi < 0 ? 0 : bi;
        ssd_s[u] = 0u;
        cnt[u][0] = cnt[u][1] = cnt[u][2] = cnt[u][3] = 0;
      }
    }
  }
  __syncthreads();
  const int best = best_s[u];
  const int* pred = preds + (static_cast<long long>(valid ? cu : 0) * M + best) * G::HW;
  const int* sb = src + static_cast<long long>(valid ? cu : 0) * G::HW;
  uvg::rd_tail<W, H>(sh, pred, sb, valid, p, u, lt, cnt[u], &ssd_s[u]);
  if (lt == 0 && valid) {
    const float bits = uvg::bucket_bits(cnt[u], wts);
    const float ssd_f = __int2float_rn(static_cast<int>(ssd_s[u]));
    best_out[cu] = best;
    rd_out[cu] = __fadd_rn(ssd_f, __fmul_rn(lam, __fadd_rn(bits, mode_bits[best])));
    satd_out[cu] = satds[cu * M + best];
  }
}

template <int W, int H>
int launch(const void* preds, const void* src, const void* satds, int B, int M,
           const void* mat_w, const void* mat_h, const void* wts,
           const void* mode_bits, const uvg::RdTail& p, float lam, void* best,
           void* rd, void* satd_best, cudaStream_t stream) {
  using G = uvg::RdGeo<W, H>;
  static uvg::SmemGrant grant;     // per card (uvg::SmemGrant)
  const cudaError_t attr = grant.ensure(rd_cost_kernel<W, H>, G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (B + G::U - 1) / G::U;
  rd_cost_kernel<W, H><<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const int*>(preds), static_cast<const int*>(src),
      static_cast<const int*>(satds), static_cast<const int8_t*>(mat_w),
      static_cast<const int8_t*>(mat_h), static_cast<const float*>(wts),
      static_cast<const float*>(mode_bits), p, B, M, lam, static_cast<int*>(best),
      static_cast<float*>(rd), static_cast<int*>(satd_best));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rd_cost(const void* preds, const void* src, const void* satds,
                       int B, int M, int w, int h, const void* mat_w,
                       const void* mat_h, const void* wts,
                       const void* mode_bits, int bitdepth, int q_bits,
                       int scale, int add, int iscale, int dq_shift, float lam,
                       void* best, void* rd, void* satd_best, void* stream) {
  const uvg::RdTail p = uvg::rd_tail_params(w, h, bitdepth, q_bits, scale, add,
                                            iscale, dq_shift);
  if (B <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UVG_RD(WW, HH)                                                              \
  if (w == WW && h == HH)                                                          \
    return launch<WW, HH>(preds, src, satds, B, M, mat_w, mat_h, wts, mode_bits, p, \
                          lam, best, rd, satd_best, st);
#define UVG_RD_ROW(WW) UVG_RD(WW, 4) UVG_RD(WW, 8) UVG_RD(WW, 16) UVG_RD(WW, 32) UVG_RD(WW, 64)
  UVG_RD_ROW(4) UVG_RD_ROW(8) UVG_RD_ROW(16) UVG_RD_ROW(32) UVG_RD_ROW(64)
#undef UVG_RD_ROW
#undef UVG_RD
  return static_cast<int>(cudaErrorInvalidValue);
}

UVG_ERROR_ENTRY(rd_cost)
