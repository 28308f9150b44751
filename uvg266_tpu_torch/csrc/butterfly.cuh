// The even/odd partial butterflies of K4 and K6 (rd_tail.cuh) and K11
// (mts_search.cu): 1-D DCT2 passes over lines in shared memory. VVC's DCT2
// matrices satisfy M[k][n-1-x] = (-1)^k M[k][x]: a forward pass sums
// (v[x] +- v[n-1-x]) * M[k][x] over half the points, an inverse pass forms
// the even and the odd half sums once and writes outputs x and n-1-x from
// them. Each thread computes two outputs on each of two lines per pass
// (n * lines / 4 threads); the matrix pairs (M[2j][x], M[2j+1][x]) sit in
// shared memory in the forward (x-major) and the inverse (j-major) order,
// so a warp reads them at consecutive addresses.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace uvg {

// (M[2j][i], M[2j+1][i]) of an n-point matrix (rows = frequencies), in the
// forward order fwd[i * n/2 + j] and the inverse order inv[j * n/2 + i]
template <int N>
__device__ __forceinline__ void load_pairs(const int8_t* __restrict__ m,
                                           int2* fwd, int2* inv, int tid, int nt) {
  constexpr int HN = N / 2;
  for (int e = tid; e < HN * HN; e += nt) {
    const int i = e / HN, j = e % HN;
    const int2 c = make_int2(m[(2 * j) * N + i], m[(2 * j + 1) * N + i]);
    fwd[i * HN + j] = c;
    inv[j * HN + i] = c;
  }
}

// forward 1-D pass over NL lines of N points (element stride ES, line
// stride LS): the thread's outputs 2j and 2j+1 on lines g and g + NL/2,
// handed to emit(line, k, sum)
template <int N, int NL, int ES, int LS, typename Emit>
__device__ __forceinline__ void fwd_pass(const int* in, const int2* fwd, int lt,
                                         Emit emit) {
  constexpr int HN = N / 2;
  const int j = lt % HN, g = lt / HN;
  const int* l0 = in + g * LS;
  const int* l1 = in + (g + NL / 2) * LS;
  int e0 = 0, o0 = 0, e1 = 0, o1 = 0;
#pragma unroll 4
  for (int i = 0; i < HN; ++i) {
    const int2 c = fwd[i * HN + j];
    const int a0 = l0[i * ES], b0 = l0[(N - 1 - i) * ES];
    const int a1 = l1[i * ES], b1 = l1[(N - 1 - i) * ES];
    e0 += (a0 + b0) * c.x;
    o0 += (a0 - b0) * c.y;
    e1 += (a1 + b1) * c.x;
    o1 += (a1 - b1) * c.y;
  }
  emit(g, 2 * j, e0);
  emit(g, 2 * j + 1, o0);
  emit(g + NL / 2, 2 * j, e1);
  emit(g + NL / 2, 2 * j + 1, o1);
}

// inverse 1-D pass: the thread's outputs i and N-1-i on lines g and g + NL/2
template <int N, int NL, int ES, int LS, typename Emit>
__device__ __forceinline__ void inv_pass(const int* in, const int2* inv, int lt,
                                         Emit emit) {
  constexpr int HN = N / 2;
  const int i = lt % HN, g = lt / HN;
  const int* l0 = in + g * LS;
  const int* l1 = in + (g + NL / 2) * LS;
  int e0 = 0, o0 = 0, e1 = 0, o1 = 0;
#pragma unroll 4
  for (int j = 0; j < HN; ++j) {
    const int2 c = inv[j * HN + i];
    e0 += l0[(2 * j) * ES] * c.x;
    o0 += l0[(2 * j + 1) * ES] * c.y;
    e1 += l1[(2 * j) * ES] * c.x;
    o1 += l1[(2 * j + 1) * ES] * c.y;
  }
  emit(g, i, e0 + o0);
  emit(g, N - 1 - i, e0 - o0);
  emit(g + NL / 2, i, e1 + o1);
  emit(g + NL / 2, N - 1 - i, e1 - o1);
}

// The 16-point line forms (K5, pseudo_recon.cu): one whole line a thread
// holds in registers, every output of it, the partial butterfly to its full
// depth. VVC's 16-point DCT2 also satisfies M[2j][7-x] = (-1)^j M[2j][x]
// and M[4m][3-x] = (-1)^m M[4m][x] (its even rows are the 8-point and
// 4-point matrices), so the even half splits again twice: 88 multiply-adds a
// line, not 128. The coefficients (line16_coefs) are read four at a time,
// by all threads at one address:
//   [0, 64)   the odd rows 2j+1, x < 8 (row j at 8j);
//   [64, 80)  rows 4m+2, x < 4;
//   [80, 84)  rows 4 and 12, x < 2;  [84, 88)  rows 0 and 8, x < 2.
constexpr int LINE16_N = 88;

__device__ __forceinline__ void load_line16(const int8_t* __restrict__ m,
                                            int* cf, int tid, int nt) {
  for (int e = tid; e < LINE16_N; e += nt) {
    int k, x;
    if (e < 64) {
      k = 2 * (e >> 3) + 1, x = e & 7;
    } else if (e < 80) {
      k = 4 * ((e - 64) >> 2) + 2, x = (e - 64) & 3;
    } else if (e < 84) {
      k = 8 * ((e - 80) >> 1) + 4, x = (e - 80) & 1;
    } else {
      k = 8 * ((e - 84) >> 1), x = (e - 84) & 1;
    }
    cf[e] = m[k * 16 + x];
  }
}

// forward: o[k] = rnd + sum_x v[x] * M[k][x] (cf: 16-byte aligned; rnd,
// a rounding offset, rides on the first multiply-add)
__device__ __forceinline__ void fwd_line16(const int (&v)[16], const int* cf,
                                           int rnd, int (&o)[16]) {
  const int4* c4 = reinterpret_cast<const int4*>(cf);
  int E[8], O[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    E[x] = v[x] + v[15 - x];
    O[x] = v[x] - v[15 - x];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 a = c4[2 * j], b = c4[2 * j + 1];
    o[2 * j + 1] = rnd + O[0] * a.x + O[1] * a.y + O[2] * a.z + O[3] * a.w +
                   O[4] * b.x + O[5] * b.y + O[6] * b.z + O[7] * b.w;
  }
  int EE[4], EO[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    EE[x] = E[x] + E[7 - x];
    EO[x] = E[x] - E[7 - x];
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int4 a = c4[16 + m];
    o[4 * m + 2] = rnd + EO[0] * a.x + EO[1] * a.y + EO[2] * a.z + EO[3] * a.w;
  }
  const int EEE0 = EE[0] + EE[3], EEE1 = EE[1] + EE[2];
  const int EEO0 = EE[0] - EE[3], EEO1 = EE[1] - EE[2];
  const int4 a = c4[20], b = c4[21];
  o[4] = rnd + EEO0 * a.x + EEO1 * a.y;
  o[12] = rnd + EEO0 * a.z + EEO1 * a.w;
  o[0] = rnd + EEE0 * b.x + EEE1 * b.y;
  o[8] = rnd + EEE0 * b.z + EEE1 * b.w;
}

// inverse: o[x] = rnd + sum_k c[k] * M[k][x] (cf: 16-byte aligned; rnd
// enters every output through the two sums of rows 0 and 8)
__device__ __forceinline__ void inv_line16(const int (&c)[16], const int* cf,
                                           int rnd, int (&o)[16]) {
  const int4* c4 = reinterpret_cast<const int4*>(cf);
  int O[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 a = c4[2 * j], b = c4[2 * j + 1];
    const int k = c[2 * j + 1];
    O[0] += k * a.x;
    O[1] += k * a.y;
    O[2] += k * a.z;
    O[3] += k * a.w;
    O[4] += k * b.x;
    O[5] += k * b.y;
    O[6] += k * b.z;
    O[7] += k * b.w;
  }
  int EO[4] = {0, 0, 0, 0};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int4 a = c4[16 + m];
    const int k = c[4 * m + 2];
    EO[0] += k * a.x;
    EO[1] += k * a.y;
    EO[2] += k * a.z;
    EO[3] += k * a.w;
  }
  const int4 a = c4[20], b = c4[21];
  const int EEO0 = c[4] * a.x + c[12] * a.z, EEO1 = c[4] * a.y + c[12] * a.w;
  const int EEE0 = rnd + c[0] * b.x + c[8] * b.z, EEE1 = rnd + c[0] * b.y + c[8] * b.w;
  const int EE[4] = {EEE0 + EEO0, EEE1 + EEO1, EEE1 - EEO1, EEE0 - EEO0};
  int E[8];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    E[x] = EE[x] + EO[x];
    E[7 - x] = EE[x] - EO[x];
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    o[x] = E[x] + O[x];
    o[15 - x] = E[x] - O[x];
  }
}

}  // namespace uvg
