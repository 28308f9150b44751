// K11 mts_search: rate-distortion choice among the five MTS transform pairs
// for one given prediction per block.
//
// Replaces: uvg266_tpu/ops/rd_cost.py:230 make_mts_search_fn. Per block and
// candidate ci (tr_idx 0, 2, 3, 4, 5 = DCT2/DCT2, DST7/DST7, DCT8/DST7,
// DST7/DCT8, DCT8/DCT8; horizontal/vertical):
//   bits, ssd = the RD tail (the steps of rd_tail.cuh) with the pair's
//               matrices and its zero-out (a 32-point DST7 or DCT8 keeps 16
//               coefficients)
//   cost[ci]  = float(ssd) + lam * (bits + sig)   sig = 1 (ci = 0), 1 + ci
//   dc[ci]    = no nonzero level beyond the DC position
//   cost[ci] += 1e30 where dc[ci] and ci > 0     (cannot signal mts_idx)
// and out: tr_idx of the first minimum of cost, that cost, dc[0].
// Integer wrapping, float rounding (--fmad=false, each operation in the
// reference's order) and the order-free bits estimate are K4's (rd_cost.cu).
//
// Bound on this card: operations (the transform passes against two int32
// blocks read). Design: templates over (w, h) as K4's, w*h/4 threads per
// block and 256 / (w*h/4) blocks per thread block below 32x32, the five
// candidates side by side in shared memory between five barriers:
// - DCT2/DCT2 on K4's even/odd partial butterflies (butterfly.cuh);
// - the four DST7/DCT8 pairs share their forward passes. In VVC's tables
//   DCT8[k][x] = (-1)^k DST7[k][n-1-x], so with a = v[x] + v[n-1-x],
//   d = v[x] - v[n-1-x] (x < n/2), s1 = sum a (S[k][x] + S[k][n-1-x]) and
//   s2 = sum d (S[k][x] - S[k][n-1-x]), the DST7 output is (s1 + s2) / 2
//   and the DCT8 output (-1)^k (s1 - s2) / 2: both for the price of one
//   product. One row pass gives both horizontal types, and one column pass
//   per horizontal type gives both vertical ones (3 passes instead of 8).
//   The sums stay inside int32 (int16 inputs, |S[k][x] +- S[k][n-1-x]| <=
//   180, at most 16 terms) and s1, s2 have the same parity, so both halves
//   are exact;
// - at 32 points only the 16 coefficients kept are computed, and the
//   inverse passes sum over them alone (the others are 0);
// - per candidate the quantiser, bucket counts and dequantiser run in the
//   forward column pass's epilogue, then the two inverse passes, the
//   reconstruction and the SSD; each thread reconstructs the same four
//   samples for every candidate, read once into registers.
// The bucket counts and SSDs are reduced by warp reductions and shared
// integer atomics (exact in any order); one thread per block then forms the
// five costs in ascending ci and keeps the first minimum (strict <).

#include "butterfly.cuh"
#include "common.cuh"

namespace {

constexpr int N_CAND = 5;
constexpr unsigned FULL = 0xffffffffu;

struct TrIdx {
  int v[N_CAND];
};

template <int W, int H>
struct Geo {
  static constexpr int HW = W * H;
  static constexpr int T = HW / 4;                   // threads per block
  static constexpr int U = T >= 256 ? 1 : 256 / T;   // blocks per thread block
  static constexpr int NT = T * U;
  static constexpr int KW = W == 32 ? 16 : W;        // DST7/DCT8 coefficients
  static constexpr int KH = H == 32 ? 16 : H;        //   kept
  static constexpr int SW = W + 1, SK = KW + 1;      // padded row strides
  static constexpr bool SQ = W == H;
  static constexpr int JT = KW * H / 4;              // tasks of a DST7/DCT8
                                                     //   column pass
  // int2 table entries of one n-point dimension keeping k: DCT2 pairs in
  // both orders, the joint forward pairs, DST7 and DCT8 inverse pairs
  static constexpr int tabs(int n, int k) {
    return 2 * (n / 2) * (n / 2) + (n / 2) * k + 2 * k * (n / 2);
  }
  static constexpr int TABW = tabs(W, KW);
  static constexpr int TABS = TABW + (SQ ? 0 : tabs(H, KH));
  static constexpr int PW = H * SW;                  // a w-wide plane
  static constexpr int PK = H * SK;                  // a keep-wide plane
  static constexpr int PC = KH * SK;                 // kept coefficients
  static constexpr int PLANES = 3 * PW + 3 * PK + 4 * PC;
  static constexpr size_t SMEM = TABS * sizeof(int2) +
                                 static_cast<size_t>(U) * PLANES * sizeof(int);
};

// the tables of one n-point dimension in shared memory
struct Tabs {
  const int2 *dfw, *div;       // DCT2 pairs, forward and inverse order
  const int2* joint;           // [x * K + k]: (S[k][x] + S[k][N-1-x], S[k][x] - S[k][N-1-x])
  const int2 *ist, *ict;       // [k * N/2 + i]: (M[k][i], M[k][N-1-i]), M = DST7, DCT8
};

template <int N, int K>
__device__ __forceinline__ Tabs load_tabs(const int8_t* __restrict__ dct2,
                                          const int8_t* __restrict__ dst7, int2* t,
                                          int tid, int nt) {
  constexpr int HN = N / 2;
  int2* dfw = t;
  int2* div = dfw + HN * HN;
  int2* joint = div + HN * HN;
  int2* ist = joint + HN * K;
  int2* ict = ist + K * HN;
  uvg::load_pairs<N>(dct2, dfw, div, tid, nt);
  for (int e = tid; e < HN * K; e += nt) {
    const int x = e / K, k = e % K;
    const int a = dst7[k * N + x], b = dst7[k * N + N - 1 - x];
    joint[e] = make_int2(a + b, a - b);
    // the same e as (k', i) of the inverse pairs: k' = e / HN, i = e % HN
    const int k2 = e / HN, i = e % HN;
    const int s = dst7[k2 * N + i], r = dst7[k2 * N + N - 1 - i];
    const int sg = (k2 & 1) ? -1 : 1;
    ist[e] = make_int2(s, r);
    ict[e] = make_int2(sg * r, sg * s);    // DCT8[k][x] = (-1)^k DST7[k][N-1-x]
  }
  return Tabs{dfw, div, joint, ist, ict};
}

// forward DST7 and DCT8 of NL lines of N points (element stride ES, line
// stride LS) from one product, the first K outputs of each: the task's
// outputs k (and k + 1 when K == N) on lines g and g + NL/2, handed to
// emit(line, k, dst7, dct8)
template <int N, int K, int NL, int ES, int LS, typename Emit>
__device__ __forceinline__ void fwd_joint(const int* in, const int2* tab, int task,
                                          Emit emit) {
  constexpr int HN = N / 2, KT = K == N ? 2 : 1, NK = K / KT;
  const int j = task % NK, g = task / NK;
  const int* l0 = in + g * LS;
  const int* l1 = in + (g + NL / 2) * LS;
  int s1[2][KT], s2[2][KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) s1[0][t] = s2[0][t] = s1[1][t] = s2[1][t] = 0;
#pragma unroll 4
  for (int x = 0; x < HN; ++x) {
    const int u0 = l0[x * ES], v0 = l0[(N - 1 - x) * ES];
    const int u1 = l1[x * ES], v1 = l1[(N - 1 - x) * ES];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int2 c = tab[x * K + j * KT + t];
      s1[0][t] += (u0 + v0) * c.x;
      s2[0][t] += (u0 - v0) * c.y;
      s1[1][t] += (u1 + v1) * c.x;
      s2[1][t] += (u1 - v1) * c.y;
    }
  }
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int k = j * KT + t;
    const int sg = (k & 1) ? -1 : 1;
    emit(g, k, (s1[0][t] + s2[0][t]) >> 1, sg * ((s1[0][t] - s2[0][t]) >> 1));
    emit(g + NL / 2, k, (s1[1][t] + s2[1][t]) >> 1,
         sg * ((s1[1][t] - s2[1][t]) >> 1));
  }
}

// inverse 1-D pass over the first K coefficients of NL lines (the rest are
// 0) with the pairs tab[k * N/2 + i] = (M[k][i], M[k][N-1-i]): the task's
// outputs i and N-1-i on lines g and g + NL/2
template <int N, int K, int NL, int ES, int LS, typename Emit>
__device__ __forceinline__ void inv_gen(const int* in, const int2* tab, int task,
                                        Emit emit) {
  constexpr int HN = N / 2;
  const int i = task % HN, g = task / HN;
  const int* l0 = in + g * LS;
  const int* l1 = in + (g + NL / 2) * LS;
  int a0 = 0, b0 = 0, a1 = 0, b1 = 0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const int2 c = tab[k * HN + i];
    const int v0 = l0[k * ES], v1 = l1[k * ES];
    a0 += v0 * c.x;
    b0 += v0 * c.y;
    a1 += v1 * c.x;
    b1 += v1 * c.y;
  }
  emit(g, i, a0);
  emit(g, N - 1 - i, b0);
  emit(g + NL / 2, i, a1);
  emit(g + NL / 2, N - 1 - i, b1);
}

template <int W, int H>
__global__ void __launch_bounds__(Geo<W, H>::NT)
    mts_search_kernel(const int* __restrict__ preds, const int* __restrict__ src,
                      int B, const int8_t* __restrict__ mts_w,
                      const int8_t* __restrict__ mts_h, const float* __restrict__ wts,
                      uvg::RdTail p, TrIdx tr_idx, float lam, int* __restrict__ tr_out,
                      float* __restrict__ cost_out, uint8_t* __restrict__ dc_out) {
  using G = Geo<W, H>;
  extern __shared__ int4 smem4[];
  __shared__ int red_s[G::U][N_CAND][3];   // [c1 | c2 << 16, c3, ssd]
  __shared__ int dcnz_s[G::U][N_CAND];     // the DC level is nonzero
  int2* tb = reinterpret_cast<int2*>(smem4);
  const int tid = threadIdx.x;
  const int u = tid / G::T, lt = tid % G::T;
  const int cu = blockIdx.x * G::U + u;
  const bool valid = cu < B;

  // the matrices: [0] is DCT2/DCT2 and [1] DST7/DST7 in both tables
  const Tabs tw = load_tabs<W, G::KW>(mts_w, mts_w + W * W, tb, tid, G::NT);
  Tabs th = tw;
  if constexpr (!G::SQ) th = load_tabs<H, G::KH>(mts_h, mts_h + H * H, tb + G::TABW, tid, G::NT);
  int* A = reinterpret_cast<int*>(tb + G::TABS) + u * G::PLANES;
  int* B2 = A + G::PW;      // [H][SW] DCT2 rows; then candidate 1's inverse columns
  int* C0 = B2 + G::PW;     // [H][SW] candidate 0's coefficients
  int* RS = C0 + G::PW;     // [H][SK] DST7 rows; then candidate 2's inverse columns
  int* RC = RS + G::PK;     // [H][SK] DCT8 rows; then candidate 3's
  int* U4 = RC + G::PK;     // [H][SK] candidate 4's inverse columns
  int* C1 = U4 + G::PK;     // [KH][SK] each: candidates 1-4's coefficients
  int* C2 = C1 + G::PC;
  int* C3 = C2 + G::PC;
  int* C4 = C3 + G::PC;
  for (int i = lt; i < N_CAND * 3; i += G::T) (&red_s[u][0][0])[i] = 0;

  // residual into A (A holds it until the inverse columns of candidate 0):
  // four adjacent samples per thread
  const int* pb = preds + static_cast<long long>(valid ? cu : 0) * G::HW;
  const int* sb = src + static_cast<long long>(valid ? cu : 0) * G::HW;
  {
    const int y = (lt * 4) / W, x = (lt * 4) % W;
    int4 s4 = make_int4(0, 0, 0, 0), p4 = s4;
    if (valid) {
      s4 = *reinterpret_cast<const int4*>(sb + lt * 4);
      p4 = *reinterpret_cast<const int4*>(pb + lt * 4);
    }
    int* a = A + y * G::SW + x;
    a[0] = s4.x - p4.x;
    a[1] = s4.y - p4.y;
    a[2] = s4.z - p4.z;
    a[3] = s4.w - p4.w;
  }
  // the four samples this thread reconstructs for every candidate: rows g0
  // and g0 + H/2, columns i0 and W-1-i0 (the inverse row passes' mapping)
  const int i0 = lt % (W / 2), g0 = lt / (W / 2);
  int pv[4] = {0, 0, 0, 0}, sv[4] = {0, 0, 0, 0};
  if (valid) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = (g0 + (q >> 1) * (H / 2)) * W + ((q & 1) ? W - 1 - i0 : i0);
      pv[q] = pb[e];
      sv[q] = sb[e];
    }
  }
  __syncthreads();

  // forward rows: DCT2 into B2, DST7 and DCT8 (the first KW of each) into
  // RS and RC, each int16((sum + rnd) >> s1)
  const int r1 = 1 << (p.s1 - 1);
  uvg::fwd_pass<W, H, 1, G::SW>(A, tw.dfw, lt, [&](int y, int k, int acc) {
    B2[y * G::SW + k] = uvg::wrap16((acc + r1) >> p.s1);
  });
  fwd_joint<W, G::KW, H, 1, G::SW>(A, tw.joint, lt, [&](int y, int k, int s, int c) {
    RS[y * G::SK + k] = uvg::wrap16((s + r1) >> p.s1);
    RC[y * G::SK + k] = uvg::wrap16((c + r1) >> p.s1);
  });
  __syncthreads();

  // forward columns, then per coefficient quant, bucket counts and dequant:
  // c = int16((sum + rnd) >> s2), level, dq written in place of c
  int c12[N_CAND] = {0, 0, 0, 0, 0}, c3[N_CAND] = {0, 0, 0, 0, 0};
  const int r2 = 1 << (p.s2 - 1);
  auto quant = [&](int acc, int& c12_, int& c3_, int* dcnz, bool dc) -> int {
    const int c = uvg::wrap16((acc + r2) >> p.s2);
    int level = uvg::wrap_mul_add(abs(c), p.scale, p.add) >> p.q_bits;
    level = uvg::clampi(level, 0, 32767);
    c12_ += (level == 1) + ((level == 2) << 16);
    c3_ += level >= 3;
    if (dc) *dcnz = level != 0;
    const int sgn = (c > 0) - (c < 0);
    return uvg::clip16(
        uvg::wrap_mul_add(sgn * level, p.iscale, 1 << (p.dq_shift - 1)) >> p.dq_shift);
  };
  uvg::fwd_pass<H, W, G::SW, 1>(B2, th.dfw, lt, [&](int x, int k2, int acc) {
    C0[k2 * G::SW + x] = quant(acc, c12[0], c3[0], &dcnz_s[u][0], x == 0 && k2 == 0);
  });
  if (lt < G::JT) {
    // horizontal DST7: vertical DST7 is candidate 1, vertical DCT8 candidate 3
    fwd_joint<H, G::KH, G::KW, G::SK, 1>(RS, th.joint, lt, [&](int x, int k2, int s, int c) {
      const bool dc = x == 0 && k2 == 0;
      C1[k2 * G::SK + x] = quant(s, c12[1], c3[1], &dcnz_s[u][1], dc);
      C3[k2 * G::SK + x] = quant(c, c12[3], c3[3], &dcnz_s[u][3], dc);
    });
    // horizontal DCT8: candidates 2 and 4
    fwd_joint<H, G::KH, G::KW, G::SK, 1>(RC, th.joint, lt, [&](int x, int k2, int s, int c) {
      const bool dc = x == 0 && k2 == 0;
      C2[k2 * G::SK + x] = quant(s, c12[2], c3[2], &dcnz_s[u][2], dc);
      C4[k2 * G::SK + x] = quant(c, c12[4], c3[4], &dcnz_s[u][4], dc);
    });
  }
  __syncthreads();

  // inverse columns: clip16((sum + rnd) >> si1), candidate 0 into A,
  // candidates 1-4 (KW columns) into B2, RS, RC, U4
  const int q1 = 1 << (p.si1 - 1);
  uvg::inv_pass<H, W, G::SW, 1>(C0, th.div, lt, [&](int x, int y, int acc) {
    A[y * G::SW + x] = uvg::clip16((acc + q1) >> p.si1);
  });
  if (lt < G::JT) {
    inv_gen<H, G::KH, G::KW, G::SK, 1>(C1, th.ist, lt, [&](int x, int y, int acc) {
      B2[y * G::SK + x] = uvg::clip16((acc + q1) >> p.si1);
    });
    inv_gen<H, G::KH, G::KW, G::SK, 1>(C2, th.ist, lt, [&](int x, int y, int acc) {
      RS[y * G::SK + x] = uvg::clip16((acc + q1) >> p.si1);
    });
    inv_gen<H, G::KH, G::KW, G::SK, 1>(C3, th.ict, lt, [&](int x, int y, int acc) {
      RC[y * G::SK + x] = uvg::clip16((acc + q1) >> p.si1);
    });
    inv_gen<H, G::KH, G::KW, G::SK, 1>(C4, th.ict, lt, [&](int x, int y, int acc) {
      U4[y * G::SK + x] = uvg::clip16((acc + q1) >> p.si1);
    });
  }
  __syncthreads();

  // inverse rows, reconstruction and SSD (uint32, wrapping) per candidate
  unsigned ssd[N_CAND] = {0u, 0u, 0u, 0u, 0u};
  const int q2 = 1 << (p.si2 - 1);
  auto sq = [&](int y, int x, int acc) -> unsigned {
    const int r = uvg::clip16((acc + q2) >> p.si2);
    const int q = (y == g0 ? 0 : 2) + (x == i0 ? 0 : 1);
    const int pq = q == 0 ? pv[0] : q == 1 ? pv[1] : q == 2 ? pv[2] : pv[3];
    const int sq_ = q == 0 ? sv[0] : q == 1 ? sv[1] : q == 2 ? sv[2] : sv[3];
    const int d = sq_ - uvg::clampi(pq + r, 0, p.max_pix);
    return static_cast<unsigned>(d) * static_cast<unsigned>(d);
  };
  uvg::inv_pass<W, H, 1, G::SW>(A, tw.div, lt,
                                [&](int y, int x, int acc) { ssd[0] += sq(y, x, acc); });
  inv_gen<W, G::KW, H, 1, G::SK>(B2, tw.ist, lt,
                                 [&](int y, int x, int acc) { ssd[1] += sq(y, x, acc); });
  inv_gen<W, G::KW, H, 1, G::SK>(RS, tw.ict, lt,
                                 [&](int y, int x, int acc) { ssd[2] += sq(y, x, acc); });
  inv_gen<W, G::KW, H, 1, G::SK>(RC, tw.ist, lt,
                                 [&](int y, int x, int acc) { ssd[3] += sq(y, x, acc); });
  inv_gen<W, G::KW, H, 1, G::SK>(U4, tw.ict, lt,
                                 [&](int y, int x, int acc) { ssd[4] += sq(y, x, acc); });

  // per block and candidate: the counts and the SSD
#pragma unroll
  for (int ci = 0; ci < N_CAND; ++ci) {
    int a = c12[ci], b = c3[ci];
    unsigned s = ssd[ci];
    if constexpr (G::T >= 32) {
      a = __reduce_add_sync(FULL, a);
      b = __reduce_add_sync(FULL, b);
      s = __reduce_add_sync(FULL, s);
      if ((lt & 31) == 0) {
        atomicAdd(&red_s[u][ci][0], a);
        atomicAdd(&red_s[u][ci][1], b);
        atomicAdd(reinterpret_cast<unsigned*>(&red_s[u][ci][2]), s);
      }
    } else {
      // the block is a segment of T lanes of the warp
#pragma unroll
      for (int o = G::T / 2; o >= 1; o >>= 1) {
        a += __shfl_xor_sync(FULL, a, o);
        b += __shfl_xor_sync(FULL, b, o);
        s += __shfl_xor_sync(FULL, s, o);
      }
      if (lt == 0) {
        red_s[u][ci][0] = a;
        red_s[u][ci][1] = b;
        red_s[u][ci][2] = static_cast<int>(s);
      }
    }
  }
  __syncthreads();
  if (lt == 0 && valid) {
    float best_cost = 0.f;
    int best_ci = -1;
    bool dc0 = false;
    for (int ci = 0; ci < N_CAND; ++ci) {
      const int c1 = red_s[u][ci][0] & 0xffff, c2 = red_s[u][ci][0] >> 16;
      const int n_nz = c1 + c2 + red_s[u][ci][1];
      const int cnt[4] = {G::HW - n_nz, c1, c2, red_s[u][ci][1]};
      const float sig = ci == 0 ? 1.0f : 1.0f + static_cast<float>(ci);
      const float bits = __fadd_rn(uvg::bucket_bits(cnt, wts), sig);
      const float ssd_f = __int2float_rn(red_s[u][ci][2]);
      float cost = __fadd_rn(ssd_f, __fmul_rn(lam, bits));
      const bool dc_only = n_nz - dcnz_s[u][ci] == 0;
      if (ci == 0) dc0 = dc_only;
      else if (dc_only) cost = __fadd_rn(cost, 1e30f);
      if (best_ci < 0 || cost < best_cost) {
        best_cost = cost;
        best_ci = ci;
      }
    }
    tr_out[cu] = tr_idx.v[best_ci];
    cost_out[cu] = best_cost;
    dc_out[cu] = dc0 ? 1 : 0;
  }
}

template <int W, int H>
int launch(const void* preds, const void* src, int B, const void* mts_w,
           const void* mts_h, const void* wts, const uvg::RdTail& p,
           const TrIdx& idx, float lam, void* tr_out, void* cost_out, void* dc_out,
           cudaStream_t stream) {
  using G = Geo<W, H>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mts_search_kernel<W, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (B + G::U - 1) / G::U;
  mts_search_kernel<W, H><<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const int*>(preds), static_cast<const int*>(src), B,
      static_cast<const int8_t*>(mts_w), static_cast<const int8_t*>(mts_h),
      static_cast<const float*>(wts), p, idx, lam, static_cast<int*>(tr_out),
      static_cast<float*>(cost_out), static_cast<uint8_t*>(dc_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keep: N_CAND (keep_w, keep_h) pairs on the host; tr_idx: N_CAND ints on
// the host; mts_w [5, w, w] and mts_h [5, h, h] int8 on the device. The
// kernel computes candidates 1-4 from the DST7 tables ([1]) as the pairs
// of tr_idx 2-5 with the 32-point zero-out: other keeps or tr_idx raise.
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
  constexpr int kIdx[N_CAND] = {0, 2, 3, 4, 5};
  const int* kp = static_cast<const int*>(keep);
  TrIdx idx;
  for (int ci = 0; ci < N_CAND; ++ci) {
    idx.v[ci] = static_cast<const int*>(tr_idx)[ci];
    const int kw = ci > 0 && w == 32 ? 16 : w, kh = ci > 0 && h == 32 ? 16 : h;
    if (idx.v[ci] != kIdx[ci] || kp[2 * ci] != kw || kp[2 * ci + 1] != kh)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UVG_MTS(WW, HH)                                                            \
  if (w == WW && h == HH)                                                          \
    return launch<WW, HH>(preds, src, B, mts_w, mts_h, wts, p, idx, lam, tr_out,   \
                          cost_out, dc_out, st);
#define UVG_MTS_ROW(WW) UVG_MTS(WW, 4) UVG_MTS(WW, 8) UVG_MTS(WW, 16) UVG_MTS(WW, 32)
  UVG_MTS_ROW(4) UVG_MTS_ROW(8) UVG_MTS_ROW(16) UVG_MTS_ROW(32)
#undef UVG_MTS_ROW
#undef UVG_MTS
  return static_cast<int>(cudaErrorInvalidValue);
}

UVG_ERROR_ENTRY(mts_search)
