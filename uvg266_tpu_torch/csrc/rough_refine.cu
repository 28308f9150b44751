// K12c rough_refine: the two selection stages of the rough intra search.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:154 make_rough_refine_fn, which the
// port runs as a chain (ops/rd_cost.py rough_refine): K2 over the 35
// stage-1 modes m1 = [0, 1, 2, 4, ..., 66], K3, stage 1 below, K12b over
// the 4 refine modes, K3, stage 2 below, K6 on the winner. The products
// stay in K2, K3, K12b and K6; this source holds the argmin scans and
// gathers between them, one C entry with a stage argument.
//
// Stage 1, per block: c1[j] = float32(s1[j]) + sqrt(lam) * mode_bits[m1[j]]
// (multiply and add rounded separately, as --fmad=false builds them); the
// first minimum i1 over the 33 angular costs c1[2:], then the first
// minimum i2 with c1[2 + i1] raised by 1e30 (the reference's one-hot
// mask); a = 2 + 2*i; refine = clip([a1-1, a1+1, a2-1, a2+1], 2, 66),
// duplicates kept.
// Stage 2, per block: c2[j] = float32(s2[j]) + sqrt(lam) *
// mode_bits[refine[j]]; the first minimum k over the 39 costs [c1 | c2]
// (stage-1 slots win ties); best_mode = m1[k] or refine[k - 35],
// satd_best = [s1 | s2][k], extra = mode_bits[best_mode] (K6's extra bits)
// and the winning prediction gathered from p1 or p2 into pred [B, h, w].
//
// Bound on this card: bytes, by the gather of the winning prediction (and
// the reads of the SATDs); a few hundred operations per block. Design:
// stage 1 one thread per block; stage 2 one thread block per block whose
// first thread scans the costs and whose threads then copy the winner.

#include "common.cuh"

namespace {

constexpr int NREF4 = 4;

__global__ void rough_stage1_kernel(const int* __restrict__ s1, int B, int n1,
                                    const float* __restrict__ mode_bits,
                                    const int* __restrict__ m1, float lam,
                                    int* __restrict__ refine) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float ls = __fsqrt_rn(lam);
  const int* s = s1 + static_cast<long long>(b) * n1;
  int i1 = 0;
  float c_i1 = 0.f;
  for (int j = 2; j < n1; ++j) {
    const float c = __fadd_rn(__int2float_rn(s[j]), __fmul_rn(ls, mode_bits[m1[j]]));
    if (j == 2 || c < c_i1) {
      c_i1 = c;
      i1 = j - 2;
    }
  }
  int i2 = 0;
  float c_i2 = 0.f;
  for (int j = 2; j < n1; ++j) {
    float c = __fadd_rn(__int2float_rn(s[j]), __fmul_rn(ls, mode_bits[m1[j]]));
    if (j - 2 == i1) c = __fadd_rn(c, 1e30f);
    if (j == 2 || c < c_i2) {
      c_i2 = c;
      i2 = j - 2;
    }
  }
  const int a1 = 2 + 2 * i1, a2 = 2 + 2 * i2;
  int* out = refine + static_cast<long long>(b) * NREF4;
  out[0] = uvg::clampi(a1 - 1, 2, 66);
  out[1] = uvg::clampi(a1 + 1, 2, 66);
  out[2] = uvg::clampi(a2 - 1, 2, 66);
  out[3] = uvg::clampi(a2 + 1, 2, 66);
}

__global__ void rough_stage2_kernel(const int* __restrict__ s1,
                                    const int* __restrict__ s2,
                                    const int* __restrict__ refine, int n1,
                                    const float* __restrict__ mode_bits,
                                    const int* __restrict__ m1, float lam,
                                    const int* __restrict__ p1,
                                    const int* __restrict__ p2, int hw,
                                    int* __restrict__ best_mode,
                                    int* __restrict__ satd_best,
                                    float* __restrict__ extra,
                                    int* __restrict__ pred) {
  __shared__ int k_s;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    const float ls = __fsqrt_rn(lam);
    const int* a = s1 + static_cast<long long>(b) * n1;
    const int* c = s2 + static_cast<long long>(b) * NREF4;
    const int* rf = refine + static_cast<long long>(b) * NREF4;
    int k = 0;
    float bc = 0.f;
    for (int j = 0; j < n1 + NREF4; ++j) {
      const int s = j < n1 ? a[j] : c[j - n1];
      const int m = j < n1 ? m1[j] : uvg::clampi(rf[j - n1], 0, 66);
      const float cj = __fadd_rn(__int2float_rn(s), __fmul_rn(ls, mode_bits[m]));
      if (j == 0 || cj < bc) {
        bc = cj;
        k = j;
      }
    }
    const int m = k < n1 ? m1[k] : uvg::clampi(rf[k - n1], 0, 66);
    best_mode[b] = m;
    satd_best[b] = k < n1 ? a[k] : c[k - n1];
    extra[b] = mode_bits[m];
    k_s = k;
  }
  __syncthreads();
  const int k = k_s;
  const int* src = k < n1 ? p1 + (static_cast<long long>(b) * n1 + k) * hw
                          : p2 + (static_cast<long long>(b) * NREF4 + k - n1) * hw;
  int* dst = pred + static_cast<long long>(b) * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) dst[p] = src[p];
}

}  // namespace

// stage 1: s1 [B, n1] int32, mode_bits [67] float32, m1 [n1] int32 ->
//          refine [B, 4] int32 (s2, p1, p2 and the stage-2 outputs unused)
// stage 2: s1 [B, n1], s2 [B, 4], refine [B, 4] int32, p1 [B, n1, h, w],
//          p2 [B, 4, h, w] int32 -> best_mode, satd_best [B] int32,
//          extra [B] float32, pred [B, h, w] int32
extern "C" int rough_refine(int stage, int B, int n1, int hw, float lam,
                            const void* s1, const void* s2, void* refine,
                            const void* mode_bits, const void* m1,
                            const void* p1, const void* p2, void* best_mode,
                            void* satd_best, void* extra, void* pred,
                            void* stream) {
  if (n1 < 3 || (stage != 1 && stage != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == 1) {
    rough_stage1_kernel<<<(B + 127) / 128, 128, 0, st>>>(
        static_cast<const int*>(s1), B, n1, static_cast<const float*>(mode_bits),
        static_cast<const int*>(m1), lam, static_cast<int*>(refine));
  } else {
    rough_stage2_kernel<<<B, 128, 0, st>>>(
        static_cast<const int*>(s1), static_cast<const int*>(s2),
        static_cast<const int*>(refine), n1, static_cast<const float*>(mode_bits),
        static_cast<const int*>(m1), lam, static_cast<const int*>(p1),
        static_cast<const int*>(p2), hw, static_cast<int*>(best_mode),
        static_cast<int*>(satd_best), static_cast<float*>(extra),
        static_cast<int*>(pred));
  }
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(rough_refine)
