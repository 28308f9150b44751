// K13 fwd_transform / inv_transform: the batched separable 2-D integer
// transforms (DCT2, DST7, DCT8) of w x h blocks, w and h up to 64.
//
// Replaces: uvg266_tpu/ops/transforms.py:86 make_fwd_fn (entry
// fwd_transform) and :112 make_inv_fn (entry inv_transform). With Mw the
// horizontal and Mh the vertical matrix (rows = frequencies):
//   forward  t = int16((x @ Mw^T + (1 << (s1-1))) >> s1)
//            c = int16((Mh @ t + (1 << (s2-1))) >> s2), zero outside the
//                kept rectangle (keep_h, keep_w)
//   inverse  u = clip16((Mh^T @ c + (1 << (s1-1))) >> s1)
//            x = clip16((u @ Mw + (1 << (s2-1))) >> s2)
// The products and the rounding add are int32 that wraps as the
// reference's does (done in uint32), the shifts arithmetic.
//
// Bound on this card: bytes (an int32 sample in and an int16 sample out,
// against a partial butterfly's few operations a sample). Design:
// - templates over (w, h) for the 25 lattice shapes {4..64}^2 and over the
//   kind of each dimension (DCT2, or a DST7 / DCT8 matrix); a generic
//   instance (a thread per sample, plain products) for a dimension of 1 or
//   2, which the reference allows at 10 bits;
// - a thread block holds U blocks, 1024 samples (at 64x64 one block): every
//   thread issues all its int4 loads of the int32 blocks before its first
//   shared-memory store, and the int16 results leave as int4 stores;
// - each pass runs a thread per line (row or column) with the whole line in
//   registers. A DCT2 dimension is an even/odd partial butterfly to its full
//   depth (VVC's DCT2 rows satisfy M[k][n-1-x] = (-1)^k M[k][x] and
//   M[2j][x] = M'[j][x], M' the n/2-point matrix), its coefficients
//   compile-time constants (dct2_coef, the standard's tables); a DST7 / DCT8
//   dimension (up to 32 points) is a register-blocked matrix pass, the
//   matrix rows read as int4 broadcasts from the int32 matrix the caller
//   passes (M for the forward, M^T for the inverse). In uint32 the products
//   and sums are ring operations mod 2^32, so a butterfly gives the matrix
//   product's bits for any int32 input. A line's outputs accumulate side by
//   side, input outer, so that consecutive multiply-adds are independent;
// - the forward computes only the kept frequencies: its row pass the first
//   keep_w outputs, its column pass the keep_w kept columns' first keep_h,
//   and the store writes zeros elsewhere. The inverse computes every output;
//   where every coefficient of a thread block outside a 64-point
//   dimension's first 32 is zero, as the forward leaves them, it reads and
//   sums those 32 alone (the full form for any other input), and its row
//   pass pairs two products in each __dp2a_lo (u is int16);
// - the intermediates t and u are int16 in shared memory (the function makes
//   them int16), the strides padded so a warp's accesses do not conflict;
// - lines of 32 and 64 points are split over G threads (a warp each, G a
//   template parameter): each computes a contiguous range of the kept
//   outputs (the inverse: of the output pairs x, n-1-x) from the whole
//   line; a 64x64 block is a thread block of 128 threads (two a line:
//   more threads a line repeat more of the line's loads and lower
//   butterfly levels than they gain, tools/k13_k14_phases.py).
// Input and output pointers must be 16-byte aligned.

#include <cstdint>
#include <utility>

#include "common.cuh"
#include "dct2_coef.cuh"

namespace {

constexpr int T_DCT2 = 0;          // ops/tr_matrices.py: DCT2, DCT8, DST7 = 0, 1, 2
constexpr int MAX_N = 64;
constexpr int NT_64X64 = 128;      // threads a thread block at 64x64
constexpr int NT_OTHER = 128;      // threads a thread block at the other shapes
constexpr int SAMPLES = 1024;      // samples a thread block below 64x64
constexpr bool PACK_ROWS = true;   // the inverse's row pass as __dp2a_lo pairs
constexpr int GEN_THREADS = 256;   // the generic instance

// --- compile-time helpers ---------------------------------------------------

template <typename F, int... I>
__device__ __forceinline__ void unroll_seq(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// f(integral_constant<int, i>) for i = 0 .. N-1, each i a constant
template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_seq(f, std::make_integer_sequence<int, N>{});
}

__host__ __device__ constexpr uint64_t range_mask(int a, int len) {
  return (len >= 64 ? ~0ull : ((1ull << len) - 1)) << a;
}

// bit j set where bit 2j of m is (j < hn)
__host__ __device__ constexpr uint64_t even_bits(uint64_t m, int hn) {
  uint64_t r = 0;
  for (int j = 0; j < hn; ++j)
    if ((m >> (2 * j)) & 1) r |= 1ull << j;
  return r;
}

// bit x set where bit x or bit n-1-x of m is (x < n/2)
__host__ __device__ constexpr uint64_t fold_bits(uint64_t m, int n) {
  uint64_t r = 0;
  for (int x = 0; x < n / 2; ++x)
    if (((m >> x) & 1) || ((m >> (n - 1 - x)) & 1)) r |= 1ull << x;
  return r;
}

// the smallest block stride >= base (a multiple of align elements of eb
// bytes) at which a warp whose lane l reads element (l / lpb) * stride +
// l % lpb hits no bank twice with different words
constexpr int col_stride(int base, int lpb, int eb, int align) {
  if (lpb >= 32) return base;
  for (int s = base; s <= base + 64 * align; s += align) {
    bool ok = true;
    for (int l1 = 0; l1 < 32 && ok; ++l1)
      for (int l2 = 0; l2 < l1 && ok; ++l2) {
        const int w1 = ((l1 / lpb) * s + l1 % lpb) * eb / 4;
        const int w2 = ((l2 / lpb) * s + l2 % lpb) * eb / 4;
        if (w1 != w2 && w1 % 32 == w2 % 32) ok = false;
      }
    if (ok) return s;
  }
  return base;
}

constexpr int keep_of(int n, bool bf) { return n == 64 ? 32 : (!bf && n == 32 ? 16 : n); }

constexpr int max_of(int a, int b) { return a > b ? a : b; }

// threads a line: a power of two with lines * G <= nt, each range of
// outputs at least gmin long (gmax ranges at most), and whole warps a part
constexpr int gparts(int lines, int nt, int gmax) {
  int g = 1;
  if (lines % 32) return 1;
  while (g * 2 <= gmax && lines * g * 2 <= nt) g *= 2;
  return g;
}

template <int W, int H, bool BW, bool BH>
struct Geo {
  static constexpr int HW = W * H;
  static constexpr int NT = HW == 4096 ? NT_64X64 : NT_OTHER;
  static constexpr int U = HW >= SAMPLES ? 1 : SAMPLES / HW;   // blocks
  static constexpr int KW = keep_of(W, BW), KH = keep_of(H, BH);
  static constexpr int Q4 = U * HW / 4;                       // int4 in
  static constexpr int Q8 = U * HW / 8;                       // int4 out
  static constexpr int L = (Q4 + NT - 1) / NT;                // a thread
  static constexpr int S = (Q8 + NT - 1) / NT;
  // int16 row stride of t / u: 16-byte rows, lanes on other rows in other
  // banks (stride / 16 bytes odd)
  static constexpr int ST = W == 4 || W == 8 ? W : W + 8;
  // forward: x int32 [U][H][SXF] (rows read by a thread each), t int16
  // [U][PBT: H x ST], c int16 [U][PBO: H x W] over x's bytes
  static constexpr int SXF = W >= 8 ? W + 4 : W;
  static constexpr int PBT = col_stride(H * ST, KW, 2, 8);
  static constexpr int PBO = col_stride(HW, KW, 2, 8);
  static constexpr int FX = max_of(U * H * SXF * 4, U * PBO * 2);
  static constexpr int FWD_SMEM = FX + U * PBT * 2;
  static constexpr int G1F = gparts(U * H, NT, KW / 4);       // rows
  static constexpr int G2F = gparts(U * KW, NT, KH / 4);      // columns
  // inverse: c int32 [U][PBX: H x W] (columns read by a thread each), u
  // int16 [U][PBU: H x ST], x int16 [U][H][ST] over c's bytes
  static constexpr int PBX = col_stride(HW, W, 4, 4);
  static constexpr int PBU = col_stride(H * ST, W, 2, 8);
  static constexpr int IX = max_of(U * PBX * 4, U * H * ST * 2);
  static constexpr int INV_SMEM = IX + U * PBU * 2;
  static constexpr int G1I = gparts(U * W, NT, BH ? H / 8 : H / 4);   // columns
  static constexpr int G2I = gparts(U * H, NT, BW ? W / 8 : W / 4);   // rows
  // the inverse where the coefficients are zero outside the top-left
  // ZH x ZW, as a 64-point forward leaves them: ZW columns of ZH inputs,
  // rows of ZW inputs
  static constexpr int ZW = W == 64 ? 32 : W, ZH = H == 64 ? 32 : H;
  static constexpr bool ZERO_OUT = ZW < W || ZH < H;
  static constexpr int G1Z = gparts(U * ZW, NT, BH ? H / 8 : H / 4);
};

// --- one line -----------------------------------------------------------

// forward DCT-II of an N-point line, the outputs in MASK:
// o[k] = sum_x v[x] M[k][x] (mod 2^32)
template <int N, uint64_t MASK>
__device__ __forceinline__ void fwd_bf(const unsigned (&v)[N], unsigned (&o)[N]) {
  if constexpr (N == 1) {
    if constexpr ((MASK & 1) != 0) o[0] = v[0] * 64u;
  } else {
    constexpr int HN = N / 2;
    unsigned e[HN], d[HN];
    unroll<HN>([&](auto xx) {
      constexpr int X = decltype(xx)::value;
      e[X] = v[X] + v[N - 1 - X];
      d[X] = v[X] - v[N - 1 - X];
    });
    // the odd outputs side by side, x outer: independent multiply-adds
    // follow one another (a 32-long chain an output would stall each step)
    unsigned acc[HN];
    unroll<HN>([&](auto xx) {
      constexpr int X = decltype(xx)::value;
      unroll<HN>([&](auto jj) {
        constexpr int J = decltype(jj)::value;
        if constexpr (((MASK >> (2 * J + 1)) & 1) != 0) {
          constexpr unsigned c = static_cast<unsigned>(uvg::dct2_coef(N, 2 * J + 1, X));
          acc[J] = X == 0 ? d[X] * c : acc[J] + d[X] * c;
        }
      });
    });
    unroll<HN>([&](auto jj) {
      constexpr int J = decltype(jj)::value;
      if constexpr (((MASK >> (2 * J + 1)) & 1) != 0) o[2 * J + 1] = acc[J];
    });
    constexpr uint64_t EM = even_bits(MASK, HN);
    if constexpr (EM != 0) {
      unsigned oe[HN];
      fwd_bf<HN, EM>(e, oe);
      unroll<HN>([&](auto jj) {
        constexpr int J = decltype(jj)::value;
        if constexpr (((EM >> J) & 1) != 0) o[2 * J] = oe[J];
      });
    }
  }
}

// inverse DCT-II of an N-point line, the outputs in MASK:
// o[x] = sum_k c[k] M[k][x] (mod 2^32), over k < KIN (the rest of c is 0,
// and not read). PACK: every c[k] lies in int16 (u, the row pass's input),
// so two coefficients share a register and each __dp2a_lo adds two
// products, the pair of matrix entries an immediate
template <int N, uint64_t MASK, bool PACK, int KIN = N>
__device__ __forceinline__ void inv_bf(const unsigned (&c)[N], unsigned (&o)[N]) {
  if constexpr (N == 1) {
    o[0] = c[0] * 64u;
  } else {
    constexpr int HN = N / 2;
    constexpr int KO = KIN / 2;            // odd coefficients that may be nonzero
    constexpr uint64_t FM = fold_bits(MASK, N);
    unsigned ce[HN], e[HN], od[HN];
    unroll<(KIN + 1) / 2>([&](auto jj) {
      constexpr int J = decltype(jj)::value;
      ce[J] = c[2 * J];
    });
    inv_bf<HN, FM, PACK, (KIN + 1) / 2>(ce, e);
    // the odd sums of the x in FM side by side, j outer
    if constexpr (PACK && KO >= 2) {
      unroll<KO / 2>([&](auto qq) {
        constexpr int Q = decltype(qq)::value;     // c[4q+1] and c[4q+3]
        const int pk = static_cast<int>((c[4 * Q + 1] & 0xffffu) | (c[4 * Q + 3] << 16));
        unroll<HN>([&](auto xx) {
          constexpr int X = decltype(xx)::value;
          if constexpr (((FM >> X) & 1) != 0) {
            constexpr int m = (uvg::dct2_coef(N, 4 * Q + 1, X) & 0xff) |
                              ((uvg::dct2_coef(N, 4 * Q + 3, X) & 0xff) << 8);
            od[X] = static_cast<unsigned>(
                __dp2a_lo(pk, m, Q == 0 ? 0 : static_cast<int>(od[X])));
          }
        });
      });
    } else if constexpr (KO >= 1) {
      unroll<KO>([&](auto jj) {
        constexpr int J = decltype(jj)::value;
        unroll<HN>([&](auto xx) {
          constexpr int X = decltype(xx)::value;
          if constexpr (((FM >> X) & 1) != 0) {
            constexpr unsigned m = static_cast<unsigned>(uvg::dct2_coef(N, 2 * J + 1, X));
            od[X] = J == 0 ? c[1] * m : od[X] + c[2 * J + 1] * m;
          }
        });
      });
    }
    unroll<HN>([&](auto xx) {
      constexpr int X = decltype(xx)::value;
      if constexpr (((FM >> X) & 1) != 0) {
        const unsigned odx = KO >= 1 ? od[X] : 0u;
        if constexpr (((MASK >> X) & 1) != 0) o[X] = e[X] + odx;
        if constexpr (((MASK >> (N - 1 - X)) & 1) != 0) o[N - 1 - X] = e[X] - odx;
      }
    });
  }
}

// matrix pass: o[r] = sum_i v[i] m[r][i] (mod 2^32) for the rows r in MASK,
// the rows of the int32 matrix m read as int4 broadcasts
template <int N, uint64_t MASK>
__device__ __forceinline__ void mat_line(const unsigned (&v)[N],
                                         const int* __restrict__ m,
                                         unsigned (&o)[N]) {
  unroll<N / 4>([&](auto qq) {              // four inputs at a time, the rows
    constexpr int Q = decltype(qq)::value;  // side by side
    unroll<N>([&](auto rr) {
      constexpr int R = decltype(rr)::value;
      if constexpr (((MASK >> R) & 1) != 0) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(m) + R * (N / 4) + Q);
        const unsigned s4 = v[4 * Q] * static_cast<unsigned>(c.x) +
                            v[4 * Q + 1] * static_cast<unsigned>(c.y) +
                            v[4 * Q + 2] * static_cast<unsigned>(c.z) +
                            v[4 * Q + 3] * static_cast<unsigned>(c.w);
        o[R] = Q == 0 ? s4 : o[R] + s4;
      }
    });
  });
}

// The outputs part g of G threads a line computes: the forward, K kept
// outputs in G ranges; the inverse DCT2, the pairs (x, N-1-x) for G ranges
// of x < N/2; the inverse matrix pass, G ranges of N
template <int N, int K, bool BF, bool FWD, int G, int g>
struct Part {
  static constexpr bool PAIRS = BF && !FWD && G > 1;
  static constexpr int LEN = PAIRS ? N / 2 / G : (FWD ? K : N) / G;
  static constexpr int A0 = g * LEN;
  static constexpr int A1 = N - (g + 1) * LEN;   // the mirrored range
  static constexpr uint64_t MASK =
      range_mask(A0, LEN) | (PAIRS ? range_mask(A1, LEN) : 0ull);
};

template <int N, bool BF, bool FWD, uint64_t MASK, bool PACK = false,
          int KIN = N>
__device__ __forceinline__ void line(const unsigned (&v)[N],
                                     const int* __restrict__ m,
                                     unsigned (&o)[N]) {
  if constexpr (!BF)
    mat_line<N, MASK>(v, m, o);
  else if constexpr (FWD)
    fwd_bf<N, MASK>(v, o);
  else
    inv_bf<N, MASK, PACK, KIN>(v, o);
}

__device__ __forceinline__ unsigned pack16(int a, int b) {
  return (static_cast<unsigned>(a) & 0xffffu) | (static_cast<unsigned>(b) << 16);
}

// row[k] = cvt(o[k]) for k in [A, A + LEN) as int4 (or int2) stores
template <int A, int LEN, int N, typename Cvt>
__device__ __forceinline__ void put_range(int16_t* row, const unsigned (&o)[N],
                                          Cvt cvt) {
  static_assert(A % 4 == 0 && LEN % 4 == 0, "ranges of 4");
  if constexpr (A % 8 == 0 && LEN % 8 == 0) {
    unroll<LEN / 8>([&](auto qq) {
      constexpr int K = A + 8 * decltype(qq)::value;
      *reinterpret_cast<uint4*>(row + K) = make_uint4(
          pack16(cvt(o[K]), cvt(o[K + 1])), pack16(cvt(o[K + 2]), cvt(o[K + 3])),
          pack16(cvt(o[K + 4]), cvt(o[K + 5])), pack16(cvt(o[K + 6]), cvt(o[K + 7])));
    });
  } else {
    unroll<LEN / 4>([&](auto qq) {
      constexpr int K = A + 4 * decltype(qq)::value;
      *reinterpret_cast<uint2*>(row + K) = make_uint2(
          pack16(cvt(o[K]), cvt(o[K + 1])), pack16(cvt(o[K + 2]), cvt(o[K + 3])));
    });
  }
}

// col[k * stride] = cvt(o[k]) for k in MASK
template <int N, uint64_t MASK, int STRIDE, typename Cvt>
__device__ __forceinline__ void put_column(int16_t* col, const unsigned (&o)[N],
                                           Cvt cvt) {
  unroll<N>([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    if constexpr (((MASK >> K) & 1) != 0)
      col[K * STRIDE] = static_cast<int16_t>(cvt(o[K]));
  });
}

// every task (line, part) of a pass: G threads a line, the parts a warp each
template <int NT, int LINES, int G, typename F>
__device__ __forceinline__ void tasks(int tid, F&& f) {
  static_assert(G == 1 || LINES % 32 == 0, "whole warps a part");
  constexpr int T = LINES * G;
  unroll<(T + NT - 1) / NT>([&](auto ii) {
    const int t = tid + decltype(ii)::value * NT;
    if (T % NT == 0 || t < T) {
      if constexpr (G == 1) {
        f(t, std::integral_constant<int, 0>{});
      } else {
        const int warp = t >> 5;
        const int part = warp % G;
        const int ln = (warp / G) * 32 + (t & 31);
        unroll<G>([&](auto gg) {
          if (part == decltype(gg)::value) f(ln, gg);
        });
      }
    }
  });
}

// the thread block's U blocks of int32 into shared memory: every int4 load
// issued before the first store; dst(e) is the int32 slot of sample e.
// Returns whether every int4 this thread loaded at a sample e with
// outside(e) is zero
template <int NT, int L, int Q4, int HW, typename Dst, typename Out>
__device__ __forceinline__ bool load_blocks(const int* __restrict__ src,
                                            long long b0, int B, int tid,
                                            Dst dst, Out outside) {
  const int4* g = reinterpret_cast<const int4*>(src + b0 * HW);
  int4 r[L];
  bool zero = true;
  unroll<L>([&](auto ii) {
    const int f = tid + decltype(ii)::value * NT;
    if ((Q4 % NT == 0 || f < Q4) && b0 + 4 * f / HW < B) r[decltype(ii)::value] = __ldg(g + f);
  });
  unroll<L>([&](auto ii) {
    const int f = tid + decltype(ii)::value * NT;
    if (Q4 % NT == 0 || f < Q4) {
      const int4 a = r[decltype(ii)::value];
      *reinterpret_cast<int4*>(dst(4 * f)) = a;
      if (b0 + 4 * f / HW < B && outside(4 * f)) zero = zero && !(a.x | a.y | a.z | a.w);
    }
  });
  return zero;
}

__device__ __forceinline__ int round_shift(unsigned acc, unsigned rnd, int s) {
  return static_cast<int>(acc + rnd) >> s;
}

// --- the forward ----------------------------------------------------------

template <int W, int H, bool BW, bool BH>
__global__ void __launch_bounds__((Geo<W, H, BW, BH>::NT))
    fwd_kernel(const int* __restrict__ x, int B, const int* __restrict__ mat_w,
               const int* __restrict__ mat_h, int s1, int s2,
               int16_t* __restrict__ out) {
  using G = Geo<W, H, BW, BH>;
  extern __shared__ int4 smem4[];
  int* xs = reinterpret_cast<int*>(smem4);
  int16_t* os = reinterpret_cast<int16_t*>(smem4);
  int16_t* ts = reinterpret_cast<int16_t*>(reinterpret_cast<char*>(smem4) + G::FX);
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * G::U;
  load_blocks<G::NT, G::L, G::Q4, G::HW>(
      x, b0, B, tid,
      [&](int e) {
        const int b = e / G::HW, rem = e % G::HW;
        return xs + (b * H + rem / W) * G::SXF + rem % W;
      },
      [](int) { return false; });
  __syncthreads();
  const unsigned r1 = 1u << (s1 - 1), r2 = 1u << (s2 - 1);
  const auto cvt1 = [&](unsigned a) { return uvg::wrap16(round_shift(a, r1, s1)); };
  const auto cvt2 = [&](unsigned a) { return uvg::wrap16(round_shift(a, r2, s2)); };
  // rows: t[y][k] = int16((sum_x x[y][x] Mw[k][x] + r1) >> s1), k < KW
  tasks<G::NT, G::U * H, G::G1F>(tid, [&](int ln, auto gg) {
    using P = Part<W, G::KW, BW, true, G::G1F, decltype(gg)::value>;
    unsigned v[W];
    const int4* row = reinterpret_cast<const int4*>(xs + ln * G::SXF);
    unroll<W / 4>([&](auto qq) {
      constexpr int Q = decltype(qq)::value;
      const int4 a = row[Q];
      v[4 * Q] = a.x, v[4 * Q + 1] = a.y, v[4 * Q + 2] = a.z, v[4 * Q + 3] = a.w;
    });
    unsigned o[W];
    line<W, BW, true, P::MASK>(v, mat_w, o);
    put_range<P::A0, P::LEN>(ts + (ln / H) * G::PBT + (ln % H) * G::ST, o, cvt1);
  });
  __syncthreads();
  // columns x < KW: c[k][x] = int16((sum_y Mh[k][y] t[y][x] + r2) >> s2),
  // k < KH
  tasks<G::NT, G::U * G::KW, G::G2F>(tid, [&](int ln, auto gg) {
    using P = Part<H, G::KH, BH, true, G::G2F, decltype(gg)::value>;
    const int b = ln / G::KW, xx = ln % G::KW;
    const int16_t* col = ts + b * G::PBT + xx;
    unsigned v[H];
    unroll<H>([&](auto yy) {
      constexpr int Y = decltype(yy)::value;
      v[Y] = static_cast<unsigned>(static_cast<int>(col[Y * G::ST]));
    });
    unsigned o[H];
    line<H, BH, true, P::MASK>(v, mat_h, o);
    put_column<H, P::MASK, W>(os + b * G::PBO + xx, o, cvt2);
  });
  __syncthreads();
  // int4 stores, zeros outside the kept rectangle
  int16_t* dst = out + b0 * G::HW;
  unroll<G::S>([&](auto ii) {
    const int f = tid + decltype(ii)::value * G::NT;
    const int e = 8 * f, b = e / G::HW, rem = e % G::HW;
    if ((G::Q8 % G::NT == 0 || f < G::Q8) && b0 + b < B) {
      const int k = rem / W, xx = rem % W;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k < G::KH && xx < G::KW)
        val = *reinterpret_cast<const uint4*>(os + b * G::PBO + rem);
      *reinterpret_cast<uint4*>(dst + e) = val;
    }
  });
}

// --- the inverse ----------------------------------------------------------

template <int W, int H, bool BW, bool BH>
__global__ void __launch_bounds__((Geo<W, H, BW, BH>::NT))
    inv_kernel(const int* __restrict__ c, int B, const int* __restrict__ mat_w,
               const int* __restrict__ mat_h, int s1, int s2,
               int16_t* __restrict__ out) {
  using G = Geo<W, H, BW, BH>;
  extern __shared__ int4 smem4[];
  int* cs = reinterpret_cast<int*>(smem4);
  int16_t* os = reinterpret_cast<int16_t*>(smem4);
  int16_t* us = reinterpret_cast<int16_t*>(reinterpret_cast<char*>(smem4) + G::IX);
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * G::U;
  const bool zero_out = __syncthreads_and(load_blocks<G::NT, G::L, G::Q4, G::HW>(
      c, b0, B, tid, [&](int e) { return cs + (e / G::HW) * G::PBX + e % G::HW; },
      [](int e) {
        const int rem = e % G::HW;
        return rem / W >= G::ZH || rem % W >= G::ZW;
      }));
  const bool zero = G::ZERO_OUT && zero_out;
  const unsigned r1 = 1u << (s1 - 1), r2 = 1u << (s2 - 1);
  const auto cvt1 = [&](unsigned a) { return uvg::clip16(round_shift(a, r1, s1)); };
  const auto cvt2 = [&](unsigned a) { return uvg::clip16(round_shift(a, r2, s2)); };
  // columns: u[y][x] = clip16((sum_k Mh[k][y] c[k][x] + r1) >> s1); where
  // the thread block's coefficients are zero outside the top-left ZH x ZW,
  // the ZW columns of ZH inputs alone (the rows read no other u)
  const auto columns = [&](auto zz) {
    constexpr bool Z = decltype(zz)::value;
    constexpr int CW = Z ? G::ZW : W, KIN = Z ? G::ZH : H;
    constexpr int G1 = Z ? G::G1Z : G::G1I;
    tasks<G::NT, G::U * CW, G1>(tid, [&](int ln, auto gg) {
      using P = Part<H, H, BH, false, G1, decltype(gg)::value>;
      const int b = ln / CW, xx = ln % CW;
      const int* col = cs + b * G::PBX + xx;
      unsigned v[H], o[H];
      unroll<KIN>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        v[K] = static_cast<unsigned>(col[K * W]);
      });
      line<H, BH, false, P::MASK, false, KIN>(v, mat_h, o);
      put_column<H, P::MASK, G::ST>(us + b * G::PBU + xx, o, cvt1);
    });
  };
  // rows: x[y][j] = clip16((sum_k u[y][k] Mw[k][j] + r2) >> s2)
  const auto rows = [&](auto zz) {
    constexpr int KIN = decltype(zz)::value ? G::ZW : W;
    tasks<G::NT, G::U * H, G::G2I>(tid, [&](int ln, auto gg) {
      using P = Part<W, W, BW, false, G::G2I, decltype(gg)::value>;
      const int16_t* row = us + (ln / H) * G::PBU + (ln % H) * G::ST;
      unsigned v[W], w[W / 2];                // w: two int16 a word
      if constexpr (W == 4) {
        const uint2 a = *reinterpret_cast<const uint2*>(row);
        w[0] = a.x, w[1] = a.y;
      } else {
        unroll<KIN / 8>([&](auto qq) {
          constexpr int Q = decltype(qq)::value;
          const uint4 a = *reinterpret_cast<const uint4*>(row + 8 * Q);
          w[4 * Q] = a.x, w[4 * Q + 1] = a.y, w[4 * Q + 2] = a.z, w[4 * Q + 3] = a.w;
        });
      }
      unroll<KIN / 2>([&](auto ii) {
        constexpr int I = decltype(ii)::value;
        v[2 * I] = static_cast<int>(static_cast<int16_t>(w[I] & 0xffffu));
        v[2 * I + 1] = static_cast<int>(w[I]) >> 16;
      });
      unsigned o[W];
      line<W, BW, false, P::MASK, PACK_ROWS, KIN>(v, mat_w, o);   // u is int16
      int16_t* orow = os + ln * G::ST;
      put_range<P::A0, P::LEN>(orow, o, cvt2);
      if constexpr (P::PAIRS) put_range<P::A1, P::LEN>(orow, o, cvt2);
    });
  };
  if constexpr (G::ZERO_OUT) {
    if (zero) {
      columns(std::true_type{});
      __syncthreads();
      rows(std::true_type{});
    } else {
      columns(std::false_type{});
      __syncthreads();
      rows(std::false_type{});
    }
  } else {
    columns(std::false_type{});
    __syncthreads();
    rows(std::false_type{});
  }
  __syncthreads();
  int16_t* dst = out + b0 * G::HW;
  unroll<G::S>([&](auto ii) {
    const int f = tid + decltype(ii)::value * G::NT;
    const int e = 8 * f, b = e / G::HW, rem = e % G::HW;
    if ((G::Q8 % G::NT == 0 || f < G::Q8) && b0 + b < B) {
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(
          os + (b * H + rem / W) * G::ST + rem % W);
    }
  });
}

// --- the generic instance (a dimension of 1 or 2) ---------------------------

inline int gen_per_cta(int hw) { return hw >= GEN_THREADS ? 1 : GEN_THREADS / hw; }

// mat_w, mat_h: M (rows = frequencies), int32
__global__ void fwd_generic(const int* __restrict__ x, int B, int w, int h,
                            int nb, const int* __restrict__ mat_w,
                            const int* __restrict__ mat_h, int s1, int s2,
                            int keep_w, int keep_h, int16_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int hw = w * h;
  int* xs = smem;
  int* ts = xs + nb * hw;
  const long long b0 = static_cast<long long>(blockIdx.x) * nb;
  const int n = static_cast<int>(min(static_cast<long long>(nb), B - b0)) * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = x[b0 * hw + i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i % w;
    if (k >= keep_w) continue;
    const int* row = xs + (i - k);
    int acc = 1 << (s1 - 1);
    for (int j = 0; j < w; ++j) acc = uvg::wrap_mul_add(row[j], mat_w[k * w + j], acc);
    ts[i] = uvg::wrap16(acc >> s1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int xx = i % w;
    const int k = (i / w) % h;
    int v = 0;
    if (xx < keep_w && k < keep_h) {
      const int* col = ts + (i - (i % hw)) + xx;
      int acc = 1 << (s2 - 1);
      for (int y = 0; y < h; ++y)
        acc = uvg::wrap_mul_add(mat_h[k * h + y], col[y * w], acc);
      v = uvg::wrap16(acc >> s2);
    }
    out[b0 * hw + i] = static_cast<int16_t>(v);
  }
}

// mat_w, mat_h: M^T (row x holds M[k][x] over k), int32
__global__ void inv_generic(const int* __restrict__ c, int B, int w, int h,
                            int nb, const int* __restrict__ mat_w,
                            const int* __restrict__ mat_h, int s1, int s2,
                            int16_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int hw = w * h;
  int* cs = smem;
  int* us = cs + nb * hw;
  const long long b0 = static_cast<long long>(blockIdx.x) * nb;
  const int n = static_cast<int>(min(static_cast<long long>(nb), B - b0)) * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cs[i] = c[b0 * hw + i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int xx = i % w;
    const int y = (i / w) % h;
    const int* col = cs + (i - (i % hw)) + xx;
    int acc = 1 << (s1 - 1);
    for (int k = 0; k < h; ++k) acc = uvg::wrap_mul_add(mat_h[y * h + k], col[k * w], acc);
    us[i] = uvg::clip16(acc >> s1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i % w;
    const int* row = us + (i - j);
    int acc = 1 << (s2 - 1);
    for (int k = 0; k < w; ++k) acc = uvg::wrap_mul_add(row[k], mat_w[j * w + k], acc);
    out[b0 * hw + i] = static_cast<int16_t>(uvg::clip16(acc >> s2));
  }
}

// --- launches ---------------------------------------------------------------

template <typename K>
int launch(K kernel, int grid, int threads, int smem, cudaStream_t st,
           const int* x, int B, const int* mw, const int* mh, int s1, int s2,
           int16_t* out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, st>>>(x, B, mw, mh, s1, s2, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool FWD, int W, int H, bool BW, bool BH>
int launch_shape(const int* x, int B, const int* mw, const int* mh, int s1,
                 int s2, int16_t* out, cudaStream_t st) {
  using G = Geo<W, H, BW, BH>;
  const int grid = (B + G::U - 1) / G::U;
  if constexpr (FWD)
    return launch(fwd_kernel<W, H, BW, BH>, grid, G::NT, G::FWD_SMEM, st, x, B,
                  mw, mh, s1, s2, out);
  else
    return launch(inv_kernel<W, H, BW, BH>, grid, G::NT, G::INV_SMEM, st, x, B,
                  mw, mh, s1, s2, out);
}

// the instance of (w, h) and the dimensions' kinds (a 64-point dimension is
// DCT2 only)
template <bool FWD, int W, int H>
int launch_kinds(bool bw, bool bh, const int* x, int B, const int* mw,
                 const int* mh, int s1, int s2, int16_t* out, cudaStream_t st) {
  if (bw && bh) return launch_shape<FWD, W, H, true, true>(x, B, mw, mh, s1, s2, out, st);
  if constexpr (H <= 32)
    if (bw) return launch_shape<FWD, W, H, true, false>(x, B, mw, mh, s1, s2, out, st);
  if constexpr (W <= 32) {
    if (bh) return launch_shape<FWD, W, H, false, true>(x, B, mw, mh, s1, s2, out, st);
    if constexpr (H <= 32)
      return launch_shape<FWD, W, H, false, false>(x, B, mw, mh, s1, s2, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool FWD>
int launch_lattice(int w, int h, bool bw, bool bh, const int* x, int B,
                   const int* mw, const int* mh, int s1, int s2, int16_t* out,
                   cudaStream_t st) {
#define UVG_TR(WW, HH)                                                        \
  if (w == WW && h == HH)                                                     \
    return launch_kinds<FWD, WW, HH>(bw, bh, x, B, mw, mh, s1, s2, out, st);
#define UVG_TR_ROW(WW) UVG_TR(WW, 4) UVG_TR(WW, 8) UVG_TR(WW, 16) UVG_TR(WW, 32) UVG_TR(WW, 64)
  UVG_TR_ROW(4) UVG_TR_ROW(8) UVG_TR_ROW(16) UVG_TR_ROW(32) UVG_TR_ROW(64)
#undef UVG_TR_ROW
#undef UVG_TR
  return static_cast<int>(cudaErrorInvalidValue);
}

bool pow2_dim(int n) { return n >= 1 && n <= MAX_N && (n & (n - 1)) == 0; }

int keep_dim(int n, int tr) { return n == 64 ? 32 : (tr != T_DCT2 && n == 32 ? 16 : n); }

// the checks both entries share: shape, types (no DST7 / DCT8 at 1, 2 or
// 64 points), shifts, 16-byte aligned pointers
bool refused(const void* in, int B, int w, int h, int tr_w, int tr_h,
             const void* mat_w, const void* mat_h, int s1, int s2,
             const void* out) {
  const auto mis = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const auto bad_tr = [](int tr, int n) {
    return tr < 0 || tr > 2 || (tr != T_DCT2 && (n < 4 || n > 32));
  };
  return B < 0 || !pow2_dim(w) || !pow2_dim(h) || bad_tr(tr_w, w) ||
         bad_tr(tr_h, h) || s1 < 1 || s1 > 31 || s2 < 1 || s2 > 31 ||
         mis(in) || mis(out) || mis(mat_w) || mis(mat_h);
}

}  // namespace

// mat_w, mat_h: the int32 matrices M (rows = frequencies); x and out
// 16-byte aligned
extern "C" int fwd_transform(const void* x, int B, int w, int h, int tr_w,
                             int tr_h, const void* mat_w, const void* mat_h,
                             int s1, int s2, int keep_w, int keep_h, void* out,
                             void* stream) {
  if (refused(x, B, w, h, tr_w, tr_h, mat_w, mat_h, s1, s2, out) ||
      keep_w != keep_dim(w, tr_w) || keep_h != keep_dim(h, tr_h))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* xi = static_cast<const int*>(x);
  const int* mw = static_cast<const int*>(mat_w);
  const int* mh = static_cast<const int*>(mat_h);
  int16_t* o = static_cast<int16_t*>(out);
  if (w >= 4 && h >= 4)
    return launch_lattice<true>(w, h, tr_w == T_DCT2, tr_h == T_DCT2, xi, B, mw,
                                mh, s1, s2, o, st);
  const int nb = gen_per_cta(w * h);
  fwd_generic<<<(B + nb - 1) / nb, GEN_THREADS,
                2 * static_cast<size_t>(nb) * w * h * sizeof(int), st>>>(
      xi, B, w, h, nb, mw, mh, s1, s2, keep_w, keep_h, o);
  return static_cast<int>(cudaGetLastError());
}

// mat_w, mat_h: the int32 transposed matrices M^T; c and out 16-byte
// aligned
extern "C" int inv_transform(const void* c, int B, int w, int h, int tr_w,
                             int tr_h, const void* mat_w, const void* mat_h,
                             int s1, int s2, void* out, void* stream) {
  if (refused(c, B, w, h, tr_w, tr_h, mat_w, mat_h, s1, s2, out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(c);
  const int* mw = static_cast<const int*>(mat_w);
  const int* mh = static_cast<const int*>(mat_h);
  int16_t* o = static_cast<int16_t*>(out);
  if (w >= 4 && h >= 4)
    return launch_lattice<false>(w, h, tr_w == T_DCT2, tr_h == T_DCT2, ci, B,
                                 mw, mh, s1, s2, o, st);
  const int nb = gen_per_cta(w * h);
  inv_generic<<<(B + nb - 1) / nb, GEN_THREADS,
                2 * static_cast<size_t>(nb) * w * h * sizeof(int), st>>>(
      ci, B, w, h, nb, mw, mh, s1, s2, o);
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(fwd_transform)
UVG_ERROR_ENTRY(inv_transform)
