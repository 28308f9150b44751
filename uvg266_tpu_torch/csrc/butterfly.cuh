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

}  // namespace uvg
