// The RD tail of K4 (rd_cost.cu) and K6 (rd_cost_pred.cu) on even/odd
// partial butterflies (butterfly.cuh): one block's DCT2 -> int16 -> DCT2 ->
// int16 -> quant -> dequant -> inverse DCT2 both ways -> reconstruction ->
// SSD, in the reference's int32 arithmetic (ops/rd_cost.py
// make_rd_cost_fn / make_rd_cost_pred_fn; plain version
// ops/rd_cost.py _rd_tail_plain, emulation rd_tail_sep):
//   t     = int16((resid @ Mw^T + (1 << (s1-1))) >> s1)
//   coef  = int16((Mh @ t + (1 << (s2-1))) >> s2)
//   level = clip((|coef| * scale + add) >> q_bits, 0, 32767)
//   dq    = clip16((sign(coef) * level * iscale + (1 << (dq_shift-1))) >> dq_shift)
//   u     = clip16((Mh^T @ dq + (1 << (si1-1))) >> si1)
//   r     = clip16((u @ Mw + (1 << (si2-1))) >> si2)
//   ssd   = sum (src - clip(pred + r, 0, max))^2         (uint32, wrapping)
// and the per-bucket counts of min(level, 3), from which the caller takes
// the bits estimate ((c0*w0 + c1*w1) + c2*w2) + c3*w3 (common.cuh
// bucket_bits, order-free).
//
// Geometry (RdGeo): templates over (w, h), so every index is a constant
// expression; w*h/4 threads a block (1024 at 64x64), and 256 / (w*h/4)
// blocks a thread block below 32x32 (16 at 8x8), all in lockstep between
// the tail's five barriers. Each thread loads four adjacent residual
// samples with one int4 load of each input (pred and src 16-byte aligned)
// and computes two outputs on each of two lines per pass; the matrix pairs
// (M[2j][x], M[2j+1][x]) sit in shared memory in both the forward (x-major)
// and the inverse (j-major) order, and the planes have a padded row
// stride. The sums never leave int32 (|residual| < 2^10, coefficients
// within +-91, at most 64 terms, int16 inputs to the second and later
// passes), so reassociating them into butterflies is exact. Bucket counts
// are kept in registers through the forward column pass; counts and SSD
// are reduced with shared-memory integer atomics, exact in any order.
#pragma once

#include "butterfly.cuh"
#include "common.cuh"

namespace uvg {

template <int W, int H>
struct RdGeo {
  static constexpr int HW = W * H;
  static constexpr int T = HW / 4;                   // threads per block
  static constexpr int U = T >= 256 ? 1 : 256 / T;   // blocks per thread block
  static constexpr int NT = T * U;
  static constexpr int SW = W + 1;                   // padded row stride
  static constexpr int PLANE = H * SW;
  static constexpr int CW = (W / 2) * (W / 2);       // int2 pairs per order
  static constexpr int CH = (H / 2) * (H / 2);
  static constexpr bool SQ = W == H;
  // dynamic shared memory: forward and inverse pairs of Mw (and of Mh
  // unless square), then two planes per block
  static constexpr size_t SMEM = (2 * CW + (SQ ? 0 : 2 * CH)) * sizeof(int2) +
                                 static_cast<size_t>(U) * 2 * PLANE * sizeof(int);
};

// The dynamic shared memory of a thread block, carved as RdGeo lays it out.
template <int W, int H>
struct RdShared {
  using G = RdGeo<W, H>;
  int2 *fw, *iw, *fh, *ih;
  int* planes;
  __device__ explicit RdShared(int4* smem4) {
    fw = reinterpret_cast<int2*>(smem4);
    iw = fw + G::CW;
    fh = G::SQ ? fw : iw + G::CW;
    ih = G::SQ ? iw : fh + G::CH;
    planes = reinterpret_cast<int*>(G::SQ ? iw + G::CW : ih + G::CH);
  }
  // every thread of the block: the matrix pairs of mat_w (and mat_h); read
  // by the tail only after its first barrier
  __device__ void load(const int8_t* __restrict__ mat_w,
                       const int8_t* __restrict__ mat_h, int tid) const {
    load_pairs<W>(mat_w, fw, iw, tid, G::NT);
    if (!G::SQ) load_pairs<H>(mat_h, fh, ih, tid, G::NT);
  }
};

// Run by every thread of the thread block (lt: the thread's index inside
// block u). pred, sb: the block's prediction and source (16-byte aligned;
// not read where !valid, which computes on zeros). cnt[4] and *ssd_s are
// block u's shared counters and must be zero on entry (written before the
// call by one thread is enough: the tail's first barrier precedes their
// first use). On return, after a barrier, they hold the block's bucket
// counts and SSD.
template <int W, int H>
__device__ __forceinline__ void rd_tail(const RdShared<W, H>& sh,
                                        const int* __restrict__ pred,
                                        const int* __restrict__ sb, bool valid,
                                        const RdTail& p, int u, int lt,
                                        int* cnt, unsigned* ssd_s) {
  using G = RdGeo<W, H>;
  int* A = sh.planes + u * 2 * G::PLANE;    // [H][SW]
  int* Bf = A + G::PLANE;                   // [H][SW]

  // 1. residual: four adjacent samples per thread
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
  // 2. forward, rows: Bf[y][k] = int16((sum_x A[y][x] * Mw[k][x] + rnd) >> s1)
  fwd_pass<W, H, 1, G::SW>(A, sh.fw, lt, [&](int y, int k, int acc) {
    Bf[y * G::SW + k] = wrap16((acc + (1 << (p.s1 - 1))) >> p.s1);
  });
  __syncthreads();
  // 3. forward, columns, then quant, bucket counts and dequant in place:
  // A[k2][x] = dequant(quant(int16((sum_y Mh[k2][y] * Bf[y][x] + rnd) >> s2)))
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;       // bucket counts, in registers
  fwd_pass<H, W, G::SW, 1>(Bf, sh.fh, lt, [&](int x, int k2, int acc) {
    const int c = wrap16((acc + (1 << (p.s2 - 1))) >> p.s2);
    int level = wrap_mul_add(abs(c), p.scale, p.add) >> p.q_bits;
    level = clampi(level, 0, 32767);
    c0 += level == 0;
    c1 += level == 1;
    c2 += level == 2;
    c3 += level >= 3;
    const int sgn = (c > 0) - (c < 0);
    A[k2 * G::SW + x] = clip16(
        wrap_mul_add(sgn * level, p.iscale, 1 << (p.dq_shift - 1)) >> p.dq_shift);
  });
  if (c0) atomicAdd(&cnt[0], c0);
  if (c1) atomicAdd(&cnt[1], c1);
  if (c2) atomicAdd(&cnt[2], c2);
  if (c3) atomicAdd(&cnt[3], c3);
  __syncthreads();
  // 4. inverse, columns: Bf[y][x] = clip16((sum_k2 Mh[k2][y] * A[k2][x] + rnd) >> si1)
  inv_pass<H, W, G::SW, 1>(A, sh.ih, lt, [&](int x, int y, int acc) {
    Bf[y * G::SW + x] = clip16((acc + (1 << (p.si1 - 1))) >> p.si1);
  });
  __syncthreads();
  // 5. inverse, rows, reconstruction and SSD
  unsigned ssd = 0u;
  inv_pass<W, H, 1, G::SW>(Bf, sh.iw, lt, [&](int y, int x, int acc) {
    const int r = clip16((acc + (1 << (p.si2 - 1))) >> p.si2);
    const int i = y * W + x;
    const int pv = valid ? pred[i] : 0;
    const int d = (valid ? sb[i] : 0) - clampi(pv + r, 0, p.max_pix);
    ssd += static_cast<unsigned>(d) * static_cast<unsigned>(d);
  });
  // 6. the block's SSD
  atomicAdd(ssd_s, ssd);
  __syncthreads();
}

}  // namespace uvg

