// K11 mts_search: rate-distortion choice among the five MTS transform pairs
// for one given prediction per block.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:230 make_mts_search_fn. Per block and
// candidate ci (tr_idx 0, 2, 3, 4, 5 = DCT2/DCT2, DST7/DST7, DCT8/DST7,
// DST7/DCT8, DCT8/DCT8; horizontal/vertical):
//   bits, ssd = the RD tail (common.cuh rd_tail_block) with the pair's
//               matrices and its zero-out mask (a 32-point DST7 or DCT8
//               keeps 16 coefficients)
//   cost[ci]  = float(ssd) + lam * (bits + sig)   sig = 1 (ci = 0), 1 + ci
//   dc[ci]    = no nonzero level beyond the DC position
//   cost[ci] += 1e30 where dc[ci] and ci > 0     (cannot signal mts_idx)
// and out: tr_idx of the first minimum of cost, that cost, dc[0].
// Integer wrapping, float rounding (--fmad=false, each operation in the
// reference's order) and the order-free bits estimate are K4's
// (rd_cost.cu), whose device code it shares.
//
// Bound on this card: operations (five times K6's four w*h*max(w,h)
// integer multiply-add passes against two int32 blocks read). Design:
// K6's, one thread block per block with everything in shared memory; the
// five candidates run one after the other through the same buffers, and
// thread 0 keeps the running first minimum (a strict < over ci ascending).

#include "common.cuh"

namespace {

constexpr int N_CAND = 5;

struct MtsKeep {
  int w[N_CAND], h[N_CAND], tr_idx[N_CAND];
};

__global__ void mts_search_kernel(const int* __restrict__ preds,
                                  const int* __restrict__ src,
                                  const int8_t* __restrict__ mts_w,
                                  const int8_t* __restrict__ mts_h,
                                  const float* __restrict__ wts,
                                  const uvg::RdTail p0, const MtsKeep keep,
                                  float lam,
                                  int* __restrict__ tr_out,
                                  float* __restrict__ cost_out,
                                  uint8_t* __restrict__ dc_out) {
  extern __shared__ int smem[];
  __shared__ int cnt[4];
  __shared__ unsigned ssd_s;
  __shared__ int dc_level;
  const int cu = blockIdx.x;
  uvg::RdTail p = p0;
  const int hw = p.w * p.h;
  const int* pred = preds + static_cast<long long>(cu) * hw;
  const int* sb = src + static_cast<long long>(cu) * hw;
  float best_cost = 0.f;
  int best_ci = -1;
  bool dc0 = false;
  for (int ci = 0; ci < N_CAND; ++ci) {
    if (threadIdx.x == 0) {
      ssd_s = 0u;
      dc_level = 0;
      cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    }
    p.keep_w = keep.w[ci];
    p.keep_h = keep.h[ci];
    uvg::rd_tail_block(pred, sb, mts_w + ci * p.w * p.w, mts_h + ci * p.h * p.h,
                       p, smem, cnt, &ssd_s, &dc_level);
    if (threadIdx.x == 0) {
      const float sig = ci == 0 ? 1.0f : 1.0f + static_cast<float>(ci);
      const float bits = __fadd_rn(uvg::bucket_bits(cnt, wts), sig);
      const float ssd_f = __int2float_rn(static_cast<int>(ssd_s));
      float cost = __fadd_rn(ssd_f, __fmul_rn(lam, bits));
      const int n_nz = hw - cnt[0];
      const bool dc_only = n_nz - (dc_level != 0 ? 1 : 0) == 0;
      if (ci == 0) dc0 = dc_only;
      else if (dc_only) cost = __fadd_rn(cost, 1e30f);
      if (best_ci < 0 || cost < best_cost) {
        best_cost = cost;
        best_ci = ci;
      }
    }
  }
  if (threadIdx.x == 0) {
    tr_out[cu] = keep.tr_idx[best_ci];
    cost_out[cu] = best_cost;
    dc_out[cu] = dc0 ? 1 : 0;
  }
}

}  // namespace

// keep: N_CAND (keep_w, keep_h) pairs on the host; tr_idx: N_CAND ints on
// the host; mts_w [5, w, w] and mts_h [5, h, h] int8 on the device
extern "C" int mts_search(const void* preds, const void* src, int B, int w,
                          int h, const void* mts_w, const void* mts_h,
                          const void* keep, const void* tr_idx,
                          const void* wts, int bitdepth, int q_bits, int scale,
                          int add, int iscale, int dq_shift, float lam,
                          void* tr_out, void* cost_out, void* dc_out,
                          void* stream) {
  const uvg::RdTail p = uvg::rd_tail_params(w, h, bitdepth, q_bits, scale, add,
                                            iscale, dq_shift);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (w > 32 || h > 32) return static_cast<int>(cudaErrorInvalidValue);
  MtsKeep k;
  for (int ci = 0; ci < N_CAND; ++ci) {
    k.w[ci] = static_cast<const int*>(keep)[2 * ci];
    k.h[ci] = static_cast<const int*>(keep)[2 * ci + 1];
    k.tr_idx[ci] = static_cast<const int*>(tr_idx)[ci];
  }
  mts_search_kernel<<<B, 256, uvg::rd_tail_smem(w, h),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(preds), static_cast<const int*>(src),
      static_cast<const int8_t*>(mts_w), static_cast<const int8_t*>(mts_h),
      static_cast<const float*>(wts), p, k, lam, static_cast<int*>(tr_out),
      static_cast<float*>(cost_out), static_cast<uint8_t*>(dc_out));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(mts_search)
