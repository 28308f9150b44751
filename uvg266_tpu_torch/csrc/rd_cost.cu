// K4 rd_cost: mode decision and rate-distortion cost of every block of a class.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:78 make_rd_cost_fn (after its SATD,
// which is K3). Per block, over its M candidate predictions (the 67 intra
// modes, or the MIP candidates of a class):
//   best = argmin_m float(satd[m]) + sqrt(lam) * mode_bits[m]  (first minimum)
//   bits, ssd = the RD tail of preds[best] (the steps of common.cuh
//               rd_tail_block, DCT2 both ways)
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
// as partial butterflies close behind. Design: templates over (w, h), so
// every index is a constant expression; w*h/4 threads per block (1024 at
// 64x64, so the 91-block class runs 91 full thread blocks instead of 91
// quarter-filled ones) and 256 / (w*h/4) blocks per thread block below
// 32x32 (16 at 8x8), all in lockstep between the five barriers. Each 1-D
// pass is an even/odd partial butterfly (butterfly.cuh; VVC's DCT2
// matrices satisfy M[k][n-1-x] = (-1)^k M[k][x]): a forward pass sums
// (v[x] +- v[n-1-x]) * M[k][x] over half the points, an inverse pass forms
// the even and the odd half sums once and writes outputs x and n-1-x from
// them, so each pass does half the multiply-adds of the matrix product.
// The sums never leave int32 (|residual| < 2^10, coefficients within +-91,
// at most 64 terms, int16 inputs to the second and later passes), so
// reassociating them is exact.
// Each thread computes two outputs on each of two lines per pass; the
// matrix pairs (M[2j][x], M[2j+1][x]) sit in shared memory in both the
// forward (x-major) and the inverse (j-major) order, so a warp reads them
// at consecutive addresses, and the planes have a padded row stride. The
// argmin runs in each block's first warp (or its own lanes below 32
// threads) with a (cost, index) lexicographic shuffle reduction; bucket
// counts and the SSD are reduced with shared-memory integer atomics, which
// are exact in any order.

#include "butterfly.cuh"
#include "common.cuh"

namespace {

template <int W, int H>
struct Geo {
  static constexpr int HW = W * H;
  static constexpr int T = HW / 4;                   // threads per block
  static constexpr int U = T >= 256 ? 1 : 256 / T;   // blocks per thread block
  static constexpr int NT = T * U;
  static constexpr int SW = W + 1;                   // padded row stride
  static constexpr int PLANE = H * SW;
  static constexpr int CW = (W / 2) * (W / 2);       // int2 pairs per order
  static constexpr int CH = (H / 2) * (H / 2);
  static constexpr bool SQ = W == H;
  // shared memory: forward and inverse pairs of Mw (and of Mh unless
  // square), then two planes per block
  static constexpr size_t SMEM = (2 * CW + (SQ ? 0 : 2 * CH)) * sizeof(int2) +
                                 static_cast<size_t>(U) * 2 * PLANE * sizeof(int);
};

template <int W, int H>
__global__ void __launch_bounds__(Geo<W, H>::NT)
    rd_cost_kernel(const int* __restrict__ preds, const int* __restrict__ src,
                   const int* __restrict__ satds, const int8_t* __restrict__ mat_w,
                   const int8_t* __restrict__ mat_h, const float* __restrict__ wts,
                   const float* __restrict__ mode_bits, uvg::RdTail p, int B, int M,
                   float lam, int* __restrict__ best_out, float* __restrict__ rd_out,
                   int* __restrict__ satd_out) {
  using G = Geo<W, H>;
  extern __shared__ int4 smem4[];
  int2* fw = reinterpret_cast<int2*>(smem4);
  int2* iw = fw + G::CW;
  int2* fh = G::SQ ? fw : iw + G::CW;
  int2* ih = G::SQ ? iw : fh + G::CH;
  int* planes = reinterpret_cast<int*>(G::SQ ? iw + G::CW : ih + G::CH);
  __shared__ int best_s[G::U];
  __shared__ int cnt[G::U][4];
  __shared__ unsigned ssd_s[G::U];

  const int tid = threadIdx.x;
  const int u = tid / G::T, lt = tid % G::T;
  const int cu = blockIdx.x * G::U + u;
  const bool valid = cu < B;
  int* A = planes + u * 2 * G::PLANE;       // [H][SW]
  int* Bf = A + G::PLANE;                   // [H][SW]

  uvg::load_pairs<W>(mat_w, fw, iw, tid, G::NT);
  if (!G::SQ) uvg::load_pairs<H>(mat_h, fh, ih, tid, G::NT);

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

  // residual: four adjacent samples per thread
  {
    const int y = (lt * 4) / W, x = (lt * 4) % W;
    int4 s4 = make_int4(0, 0, 0, 0), p4 = s4;
    if (valid) {
      s4 = *reinterpret_cast<const int4*>(sb + lt * 4);
      p4 = *reinterpret_cast<const int4*>(pred + lt * 4);
    }
    int* a = A + y * G::SW + x;
    a[0] = s4.x - p4.x;
    a[1] = s4.y - p4.y;
    a[2] = s4.z - p4.z;
    a[3] = s4.w - p4.w;
  }
  __syncthreads();
  // forward, rows: Bf[y][k] = int16((sum_x A[y][x] * Mw[k][x] + rnd) >> s1)
  uvg::fwd_pass<W, H, 1, G::SW>(A, fw, lt, [&](int y, int k, int acc) {
    Bf[y * G::SW + k] = uvg::wrap16((acc + (1 << (p.s1 - 1))) >> p.s1);
  });
  __syncthreads();
  // forward, columns, then quant, bucket counts and dequant in place:
  // A[k2][x] = dequant(quant(int16((sum_y Mh[k2][y] * Bf[y][x] + rnd) >> s2)))
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;       // bucket counts, in registers
  uvg::fwd_pass<H, W, G::SW, 1>(Bf, fh, lt, [&](int x, int k2, int acc) {
    const int c = uvg::wrap16((acc + (1 << (p.s2 - 1))) >> p.s2);
    int level = uvg::wrap_mul_add(abs(c), p.scale, p.add) >> p.q_bits;
    level = uvg::clampi(level, 0, 32767);
    c0 += level == 0;
    c1 += level == 1;
    c2 += level == 2;
    c3 += level >= 3;
    const int sgn = (c > 0) - (c < 0);
    A[k2 * G::SW + x] = uvg::clip16(
        uvg::wrap_mul_add(sgn * level, p.iscale, 1 << (p.dq_shift - 1)) >> p.dq_shift);
  });
  if (c0) atomicAdd(&cnt[u][0], c0);
  if (c1) atomicAdd(&cnt[u][1], c1);
  if (c2) atomicAdd(&cnt[u][2], c2);
  if (c3) atomicAdd(&cnt[u][3], c3);
  __syncthreads();
  // inverse, columns: Bf[y][x] = clip16((sum_k2 Mh[k2][y] * A[k2][x] + rnd) >> si1)
  uvg::inv_pass<H, W, G::SW, 1>(A, ih, lt, [&](int x, int y, int acc) {
    Bf[y * G::SW + x] = uvg::clip16((acc + (1 << (p.si1 - 1))) >> p.si1);
  });
  __syncthreads();
  // inverse, rows, reconstruction and SSD
  unsigned ssd = 0u;
  uvg::inv_pass<W, H, 1, G::SW>(Bf, iw, lt, [&](int y, int x, int acc) {
    const int r = uvg::clip16((acc + (1 << (p.si2 - 1))) >> p.si2);
    const int i = y * W + x;
    const int pv = valid ? pred[i] : 0;
    const int d = (valid ? sb[i] : 0) - uvg::clampi(pv + r, 0, p.max_pix);
    ssd += static_cast<unsigned>(d) * static_cast<unsigned>(d);
  });
  atomicAdd(&ssd_s[u], ssd);
  __syncthreads();
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
  using G = Geo<W, H>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      rd_cost_kernel<W, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
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
