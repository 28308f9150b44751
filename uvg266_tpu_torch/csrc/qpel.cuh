// The quarter-pel search arithmetic of K8 (leaf_qpel.cu) and K9b
// (frac_search.cu): the 8-tap luma interpolation of ops/me.py
// make_frac_search_fn's interp_one (the horizontal pass >> (bitdepth - 8),
// the vertical pass >> 6, the weighted-prediction rounding by
// 14 - bitdepth, the clip) and the 8x8 or 4x4 Hadamard SATD, in the form
// that K9b's redesign found fast: the three fractional horizontal phases
// (4, 8, 12) shared by all offsets and stored as int16, the vertical taps
// slid over a column of them in registers, the Hadamard down the column in
// registers and across the lanes of a sub-block with warp shuffles.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace uvg {

// uvg_g_luma_filter (ops/inter.py LUMA_FILTER), 1/16-pel phases
static __constant__ int kLumaFilter[16][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},        {0, 1, -3, 63, 4, -2, 1, 0},
    {-1, 2, -5, 62, 8, -3, 1, 0},     {-1, 3, -8, 60, 13, -4, 1, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},   {-1, 4, -11, 52, 26, -8, 3, -1},
    {-1, 3, -9, 47, 31, -10, 4, -1},  {-1, 4, -11, 45, 34, -10, 4, -1},
    {-1, 4, -11, 40, 40, -11, 4, -1}, {-1, 4, -10, 34, 45, -11, 4, -1},
    {-1, 4, -10, 31, 47, -9, 3, -1},  {-1, 3, -8, 26, 52, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1},   {0, 1, -4, 13, 60, -8, 3, -1},
    {0, 1, -3, 8, 62, -5, 2, -1},     {0, 1, -2, 4, 63, -3, 1, 0}};

// the taps of the three fractional phases 4, 8, 12 (kLumaFilter rows 4, 8,
// 12), for the shared horizontal passes, indexed by constants
__host__ __device__ constexpr int tap(int p, int t) {
  constexpr int f[3][8] = {{-1, 4, -10, 58, 17, -5, 1, 0},
                           {-1, 4, -11, 40, 40, -11, 4, -1},
                           {0, 1, -5, 17, 58, -10, 4, -1}};
  return f[p][t];
}

// the horizontal passes stored as int16: for every phase and bit depth the
// extreme sums (all positive taps at the maximum sample, or all negative
// ones), shifted by bitdepth - 8, stay inside int16
constexpr bool hor_fits_int16() {
  for (int bd = 8; bd <= 12; ++bd) {
    const int mx = (1 << bd) - 1;
    for (int p = 0; p < 3; ++p) {
      int pos = 0, neg = 0;
      for (int t = 0; t < 8; ++t) (tap(p, t) > 0 ? pos : neg) += tap(p, t);
      if ((pos * mx) >> (bd - 8) > 32767 || (neg * mx) >> (bd - 8) < -32768)
        return false;
    }
    if (mx << (14 - bd) > 32767) return false;    // fx = 0: 64 * s >> (bd-8)
  }
  return true;
}
static_assert(hor_fits_int16(), "the horizontal passes must fit int16");

// The horizontal pass of phase p at one position: the 8 taps over v[0..7]
// (the window row from 3 samples before the position), >> (bd - 8)
__device__ __forceinline__ int16_t hor_tap(const int* v, int p, int bd) {
  int acc = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) acc += tap(p, t) * v[t];
  return static_cast<int16_t>(acc >> (bd - 8));
}

// The vertical pass of N samples: sample e from v[e .. e + 7] (the column's
// horizontal values from 3 rows before it) with taps f, >> 6, then the
// rounding by 14 - bd and the clip
template <int N>
__device__ __forceinline__ void vert_taps(const int* v, const int* f, int bd,
                                          int* pred) {
  const int wp = 14 - bd, rnd = 1 << (wp - 1), mx = (1 << bd) - 1;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    int acc = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) acc += f[t] * v[e + t];
    acc >>= 6;
    pred[e] = clampi((acc + rnd) >> wp, 0, mx);
  }
}

// The identity vertical pass (fy = 0: 64 x >> 6): the rounding and the clip
template <int N>
__device__ __forceinline__ void round_clip(const int* v, int bd, int* pred) {
  const int wp = 14 - bd, rnd = 1 << (wp - 1), mx = (1 << bd) - 1;
#pragma unroll
  for (int e = 0; e < N; ++e) pred[e] = clampi((v[e] + rnd) >> wp, 0, mx);
}

// The N predicted samples of column c, rows r0 .. r0 + N - 1, at offset k,
// (dx, dy) = (k % 7 - 3, k / 7 - 3) quarter pels. win: the window at the
// block's sample (0, 0), row stride ws; hx: the horizontal pass of phase 4
// at the block's sample (0, 0) (its column j holding the pass at column j),
// row stride hs, the phases 8 and 12 following at steps of hps.
template <int N>
__device__ __forceinline__ void interp_col(const int16_t* win, int ws,
                                           const int16_t* hx, int hs, int hps,
                                           int r0, int c, int k, int bd,
                                           int* pred) {
  const int ox = 4 * (k % 7 - 3), oy = 4 * (k / 7 - 3);
  const int ix = ox >> 4, iy = oy >> 4, fx = ox & 15, fy = oy & 15;
  if (fx == 0 && fy == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) pred[e] = win[(r0 + e) * ws + c];
    return;
  }
  // the column of horizontal values: phase fx at column c + ix, or the
  // window << (14 - bd) at fx = 0 (64 * s >> (bd - 8), exact)
  const int16_t* col;
  int stride, lsh;
  if (fx == 0) {
    col = win + c;
    stride = ws;
    lsh = 14 - bd;
  } else {
    col = hx + ((fx >> 2) - 1) * hps + c + ix;
    stride = hs;
    lsh = 0;
  }
  int v[N + 7];
  if (fy == 0) {            // the vertical pass is the identity (64x >> 6)
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = col[(r0 + e) * stride];
    round_clip<N>(v, bd, pred);
    return;
  }
  // sample row r reads rows r + iy - 3 .. r + iy + 4
  const int16_t* p0 = col + (r0 + iy - 3) * stride;
#pragma unroll
  for (int t = 0; t < N + 7; ++t) v[t] = static_cast<int>(p0[t * stride]) << lsh;
  int f[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) f[t] = kLumaFilter[fy][t];
  vert_taps<N>(v, f, bd, pred);
}

// The Hadamard SATD of an N x N sub-block held a column a lane by N
// neighbouring lanes (lane & (N - 1) is the column), differences d[N] down
// the column: the Hadamard down the columns in registers, then along the
// rows across the lanes with shuffles (Sylvester order, both; d is
// overwritten), s = sum |t| - |t00| + (|t00| >> 2), the sub-block's
// rounding ((s + 2) >> 2 at N = 8, (s + 1) >> 1 at N = 4). Returns it in
// every lane of the sub-block. Called by all 32 lanes of the warp.
template <int N>
__device__ __forceinline__ int satd_cols(int* d, int lane) {
  constexpr unsigned FULL = 0xffffffffu;
#pragma unroll
  for (int m = 1; m < N; m <<= 1)
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (!(e & m)) {
        const int a = d[e], q = d[e + m];
        d[e] = a + q;
        d[e + m] = a - q;
      }
#pragma unroll
  for (int m = 1; m < N; m <<= 1)
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int o = __shfl_xor_sync(FULL, d[e], m);
      d[e] = (lane & m) ? o - d[e] : d[e] + o;
    }
  int s = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) s += abs(d[e]);
  if ((lane & (N - 1)) == 0) s = s - abs(d[0]) + (abs(d[0]) >> 2);
#pragma unroll
  for (int m = 1; m < N; m <<= 1) s += __shfl_xor_sync(FULL, s, m);
  return N == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
}

}  // namespace uvg
