// K4 rd_cost: mode decision and rate-distortion cost of every block of a class.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:78 make_rd_cost_fn (after its SATD,
// which is K3). Per block, over its M candidate predictions (the 67 intra
// modes, or the MIP candidates of a class):
//   best = argmin_m float(satd[m]) + sqrt(lam) * mode_bits[m]  (first minimum)
//   bits, ssd = the RD tail (common.cuh rd_tail_block) of preds[best]
//   rd   = float(ssd) + lam * (bits + mode_bits[best])
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

#include "common.cuh"

namespace {

__global__ void rd_cost_kernel(const int* __restrict__ preds,
                               const int* __restrict__ src,
                               const int* __restrict__ satds,
                               const int8_t* __restrict__ mat_w,
                               const int8_t* __restrict__ mat_h,
                               const float* __restrict__ wts,
                               const float* __restrict__ mode_bits,
                               uvg::RdTail p, int M, float lam,
                               int* __restrict__ best_out,
                               float* __restrict__ rd_out,
                               int* __restrict__ satd_out) {
  extern __shared__ int smem[];
  __shared__ int best_s;
  __shared__ int cnt[4];
  __shared__ unsigned ssd_s;
  const int cu = blockIdx.x;
  const int tid = threadIdx.x;
  const int hw = p.w * p.h;

  if (tid < 32) {
    // first minimum of satd + sqrt(lam) * mode_bits over the M candidates
    const float lam_sqrt = __fsqrt_rn(lam);
    float bc = 0.f;
    int bi = -1;
    for (int m = tid; m < M; m += 32) {
      const float c = __fadd_rn(__int2float_rn(satds[cu * M + m]),
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
  __syncthreads();
  const int best = best_s;
  const int* pred = preds + (static_cast<long long>(cu) * M + best) * hw;
  const int* sb = src + static_cast<long long>(cu) * hw;
  uvg::rd_tail_block(pred, sb, mat_w, mat_h, p, smem, cnt, &ssd_s);
  if (tid == 0) {
    const float bits = uvg::bucket_bits(cnt, wts);
    const float ssd_f = __int2float_rn(static_cast<int>(ssd_s));
    best_out[cu] = best;
    rd_out[cu] = __fadd_rn(ssd_f, __fmul_rn(lam, __fadd_rn(bits, mode_bits[best])));
    satd_out[cu] = satds[cu * M + best];
  }
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
  rd_cost_kernel<<<B, 256, uvg::rd_tail_smem(w, h), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(preds), static_cast<const int*>(src),
      static_cast<const int*>(satds), static_cast<const int8_t*>(mat_w),
      static_cast<const int8_t*>(mat_h), static_cast<const float*>(wts),
      static_cast<const float*>(mode_bits), p, M, lam, static_cast<int*>(best),
      static_cast<float*>(rd), static_cast<int*>(satd_best));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(rd_cost)
