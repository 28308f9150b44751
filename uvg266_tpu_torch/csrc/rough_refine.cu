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
// the reads of the SATDs); a few hundred operations per block, so each
// stage is a chain of dependent loads and shuffles, near the launch floor.
// Design: a warp per block in both stages, eight warps a thread block.
// Lane l holds the costs of slots l and l + 32 (stage 1: angular costs j =
// 2 + l and 34 + l, one coalesced row of SATDs), keeps the first of its
// two, and five __shfl_xor_sync steps leave every lane with the first
// minimum of the key (cost, index): a smaller cost, or an equal cost at a
// smaller index, as argmin's first minimum. Stage 1 then raises c[i1] by
// 1e30 in its lane and reduces again; lane 0 writes the refine list with
// one 16-byte store. Stage 2's lane that holds slot k writes the three
// values, then the warp copies the winner as int4 loads, all issued before
// the stores; templates over h*w size the copy: a warp per block up to 512
// samples (8 blocks, up to 4096 ints, a thread block), HW / 512 warps
// sharing one block's copy above (4096 ints a thread block). Measured
// (tools/k12c_phases.py): at 8x8 a warp a block costs 0.0020 ms with no
// reduction at all, against a 0.0012 launch floor; several blocks a warp
// run their trees one after another and were slower; a ballot or
// __reduce_min_sync in place of the tree saved at most 0.0005 a class.

#include "common.cuh"

namespace {

constexpr int NREF4 = 4;
constexpr int WARPS = 8;             // warps a thread block, both stages
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = 0x7fffffff;     // the index of a lane with no slot

__device__ __forceinline__ float cost(int s, float pen) {
  return __fadd_rn(__int2float_rn(s), pen);
}

// the first minimum of the key (c, i) over the warp, in every lane
__device__ __forceinline__ void warp_argmin(float& c, int& i) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float oc = __shfl_xor_sync(FULL, c, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (oc < c || (oc == c && oi < i)) {
      c = oc;
      i = oi;
    }
  }
}

// a lane's first minimum of its two slots (i0 < i1; a missing slot holds
// +inf)
__device__ __forceinline__ void lane_min(float c0, int i0, float c1, int i1,
                                         float& c, int& i) {
  const bool hi = c1 < c0;
  c = hi ? c1 : c0;
  i = hi ? i1 : i0;
}

__global__ void __launch_bounds__(WARPS * 32)
rough_stage1_kernel(const int* __restrict__ s1, int B, int n1,
                    const float* __restrict__ mode_bits,
                    const int* __restrict__ m1, float lam,
                    int* __restrict__ refine) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const float inf = __int_as_float(0x7f800000);
  const float ls = __fsqrt_rn(lam);
  const int j0 = 2 + lane, j1 = 34 + lane;   // angular index i = j - 2
  const bool v0 = j0 < n1, v1 = j1 < n1;
  const int* s = s1 + b * n1;
  const int sa = v0 ? s[j0] : 0;
  const int sb = v1 ? s[j1] : 0;
  const float pa = v0 ? __fmul_rn(ls, mode_bits[m1[j0]]) : 0.f;
  const float pb = v1 ? __fmul_rn(ls, mode_bits[m1[j1]]) : 0.f;
  float ca = v0 ? cost(sa, pa) : inf;
  float cb = v1 ? cost(sb, pb) : inf;
  const int ia = v0 ? lane : NONE, ib = v1 ? lane + 32 : NONE;
  float c;
  int i1, i2;
  lane_min(ca, ia, cb, ib, c, i1);
  warp_argmin(c, i1);
  if (ia == i1) ca = __fadd_rn(ca, 1e30f);
  if (ib == i1) cb = __fadd_rn(cb, 1e30f);
  lane_min(ca, ia, cb, ib, c, i2);
  warp_argmin(c, i2);
  if (lane == 0) {
    const int a1 = 2 + 2 * i1, a2 = 2 + 2 * i2;
    reinterpret_cast<int4*>(refine)[b] =
        make_int4(uvg::clampi(a1 - 1, 2, 66), uvg::clampi(a1 + 1, 2, 66),
                  uvg::clampi(a2 - 1, 2, 66), uvg::clampi(a2 + 1, 2, 66));
  }
}

// warps sharing one block's copy, and blocks a thread block, at h*w = HW
template <int HW>
struct Stage2Geo {
  static constexpr int WPB =
      HW <= 512 ? 1 : (HW / 512 < WARPS ? HW / 512 : WARPS);
  static constexpr int BPT = WARPS / WPB;
  static constexpr int Q = HW / 4;                       // int4 a block
  static constexpr int STEP = 32 * WPB;
  static constexpr int IT = (Q + STEP - 1) / STEP;       // int4 a lane
  static_assert(HW % 4 == 0 && WARPS % WPB == 0, "lattice shapes only");
};

template <int HW>
__global__ void __launch_bounds__(WARPS * 32)
rough_stage2_kernel(const int* __restrict__ s1, const int* __restrict__ s2,
                    const int* __restrict__ refine, int B, int n1,
                    const float* __restrict__ mode_bits,
                    const int* __restrict__ m1, float lam,
                    const int* __restrict__ p1, const int* __restrict__ p2,
                    int* __restrict__ best_mode, int* __restrict__ satd_best,
                    float* __restrict__ extra, int* __restrict__ pred) {
  using G = Stage2Geo<HW>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * G::BPT + warp / G::WPB;
  const int part = warp % G::WPB;
  if (b >= B) return;
  const float inf = __int_as_float(0x7f800000);
  const float ls = __fsqrt_rn(lam);
  // slot j < n1: stage-1 mode m1[j]; n1 <= j < n1 + 4: refine mode (the
  // index clamped to the table, as the plain version's lookup implies)
  const int* a = s1 + b * n1;
  const int* r = s2 + b * NREF4;
  const int* rf = refine + b * NREF4;
  int s[2], m[2];
  float mb[2], c[2];
  bool v[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    v[t] = j < n1 + NREF4;
    s[t] = !v[t] ? 0 : (j < n1 ? a[j] : r[j - n1]);
    m[t] = !v[t] ? 0 : (j < n1 ? m1[j] : uvg::clampi(rf[j - n1], 0, 66));
    mb[t] = mode_bits[m[t]];
    c[t] = v[t] ? cost(s[t], __fmul_rn(ls, mb[t])) : inf;
  }
  float ck;
  int k;
  lane_min(c[0], v[0] ? lane : NONE, c[1], v[1] ? lane + 32 : NONE, ck, k);
  warp_argmin(ck, k);
  if (part == 0 && (k & 31) == lane) {
    const bool hi = k >= 32;
    best_mode[b] = hi ? m[1] : m[0];
    satd_best[b] = hi ? s[1] : s[0];
    extra[b] = hi ? mb[1] : mb[0];
  }
  const int4* src = reinterpret_cast<const int4*>(
      k < n1 ? p1 + (static_cast<long long>(b) * n1 + k) * HW
             : p2 + (static_cast<long long>(b) * NREF4 + k - n1) * HW);
  int4* dst = reinterpret_cast<int4*>(pred + static_cast<long long>(b) * HW);
  const int q0 = part * 32 + lane;
  int4 w[G::IT];
#pragma unroll
  for (int t = 0; t < G::IT; ++t)
    if (q0 + t * G::STEP < G::Q) w[t] = src[q0 + t * G::STEP];
#pragma unroll
  for (int t = 0; t < G::IT; ++t)
    if (q0 + t * G::STEP < G::Q) dst[q0 + t * G::STEP] = w[t];
}

template <int HW>
void launch_stage2(int B, int n1, float lam, const void* s1, const void* s2,
                   const void* refine, const void* mode_bits, const void* m1,
                   const void* p1, const void* p2, void* best_mode,
                   void* satd_best, void* extra, void* pred, cudaStream_t st) {
  using G = Stage2Geo<HW>;
  rough_stage2_kernel<HW><<<(B + G::BPT - 1) / G::BPT, WARPS * 32, 0, st>>>(
      static_cast<const int*>(s1), static_cast<const int*>(s2),
      static_cast<const int*>(refine), B, n1,
      static_cast<const float*>(mode_bits), static_cast<const int*>(m1), lam,
      static_cast<const int*>(p1), static_cast<const int*>(p2),
      static_cast<int*>(best_mode), static_cast<int*>(satd_best),
      static_cast<float*>(extra), static_cast<int*>(pred));
}

}  // namespace

// stage 1: s1 [B, n1] int32, mode_bits [67] float32, m1 [n1] int32 ->
//          refine [B, 4] int32, 16-byte aligned (s2, p1, p2 and the
//          stage-2 outputs unused)
// stage 2: s1 [B, n1], s2 [B, 4], refine [B, 4] int32, p1 [B, n1, h, w],
//          p2 [B, 4, h, w] int32 -> best_mode, satd_best [B] int32,
//          extra [B] float32, pred [B, h, w] int32; hw = h * w a power of
//          two in [16, 4096]; p1, p2 and pred 16-byte aligned
// 3 <= n1 <= 60: a lane holds two slots of each stage's costs
extern "C" int rough_refine(int stage, int B, int n1, int hw, float lam,
                            const void* s1, const void* s2, void* refine,
                            const void* mode_bits, const void* m1,
                            const void* p1, const void* p2, void* best_mode,
                            void* satd_best, void* extra, void* pred,
                            void* stream) {
  if (n1 < 3 || n1 > 60 || (stage != 1 && stage != 2)
      || static_cast<long long>(B) * n1 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* aligned = stage == 1 ? refine : pred;
  if (reinterpret_cast<uintptr_t>(aligned) % 16
      || (stage == 2 && (reinterpret_cast<uintptr_t>(p1) % 16
                         || reinterpret_cast<uintptr_t>(p2) % 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == 1) {
    rough_stage1_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
        static_cast<const int*>(s1), B, n1, static_cast<const float*>(mode_bits),
        static_cast<const int*>(m1), lam, static_cast<int*>(refine));
    return static_cast<int>(cudaGetLastError());
  }
#define UVG_STAGE2(N)                                                      \
  case N:                                                                  \
    launch_stage2<N>(B, n1, lam, s1, s2, refine, mode_bits, m1, p1, p2,    \
                     best_mode, satd_best, extra, pred, st);               \
    break;
  switch (hw) {
    UVG_STAGE2(16)
    UVG_STAGE2(32)
    UVG_STAGE2(64)
    UVG_STAGE2(128)
    UVG_STAGE2(256)
    UVG_STAGE2(512)
    UVG_STAGE2(1024)
    UVG_STAGE2(2048)
    UVG_STAGE2(4096)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UVG_STAGE2
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(rough_refine)
