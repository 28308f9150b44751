// The angular intra prediction of K2 (predict67.cu) and K12b
// (predict_modes.cu), from one descriptor per mode (ops/tables.py
// mode_descriptors): the descriptor fields, the cubic filter rows, the
// templated block geometry, the build of a mode's extended main reference
// and the four adjacent samples of one output row.
//
// A mode reads its references r through the section offsets of its
// descriptor (D_MAIN, D_SIDE: k * REF_LEN in K2's 4*REF_LEN references; K12b
// turns them into the offsets of its compact copy of the samples it
// loaded, where the top section still starts at 0).
// For mode m >= 2 in the work orientation (the block for vertical modes,
// its transpose for horizontal ones; ww columns, hh rows), main = D_MAIN,
// side = D_SIDE:
//   ext[p], p < D_EXTN: sample_disp < 0: base = hh, ext[base + j] =
//     r[main + j] for j < ww + 2 (r[0] beyond, where no tap reads),
//     ext[base - i] = r[side + min((i*inv + 256) >> 9, hh)]; else ext[p] =
//     r[main + min(p, REF_LEN-1)];
//   row yy: dpos = (yy + 1) * sample_disp; an integer slope copies
//     ext[base + (dpos >> 5) + xx + 1], a fractional one filters
//     ext[base + (dpos >> 5) + xx + t], t < 4, with the cubic row or the
//     gauss row of dpos & 31, then clips;
//   gradient PDPC (xx < D_PLIM): v += (wl*(r[side + min(yy + ((256 +
//     (xx+1)*inv) >> 9) + 1, REF_LEN-1)] - v) + 32) >> 6; hor/ver PDPC: v =
//     clip(v + (wl*(r[side + 1 + yy] - r[main]) + 32) >> 6), the
//     correction for xx < D_PLIM; wl = 32 >> ((2*xx) >> D_PSCALE).
// Products are < 2^20: int32 is exact.
#pragma once

#include "common.cuh"

namespace uvg {
namespace ang {

// the descriptor fields (ops/tables.py D_*)
enum {
  D_VERT, D_MAIN, D_SIDE, D_SD, D_INV, D_FILT, D_CLIP, D_PDPC, D_PSCALE,
  D_PLIM, D_BASE, D_EXTN, D_MAINN, D_MODE, DESC_N = 16
};
constexpr int FILT_INT = 0, FILT_CUBIC = 1;     // else the gauss filter
constexpr int PDPC_GRAD = 1, PDPC_HV = 2;

// ops/intra.py CUBIC_FILTER
__constant__ int kCubic[32][4] = {
    {0, 64, 0, 0}, {-1, 63, 2, 0}, {-2, 62, 4, 0}, {-2, 60, 7, -1},
    {-2, 58, 10, -2}, {-3, 57, 12, -2}, {-4, 56, 14, -2}, {-4, 55, 15, -2},
    {-4, 54, 16, -2}, {-5, 53, 18, -2}, {-6, 52, 20, -2}, {-6, 49, 24, -3},
    {-6, 46, 28, -4}, {-5, 44, 29, -4}, {-4, 42, 30, -4}, {-4, 39, 33, -4},
    {-4, 36, 36, -4}, {-4, 33, 39, -4}, {-4, 30, 42, -4}, {-4, 29, 44, -5},
    {-4, 28, 46, -6}, {-3, 24, 49, -6}, {-2, 20, 52, -6}, {-2, 18, 53, -5},
    {-2, 16, 54, -4}, {-2, 15, 55, -4}, {-2, 14, 56, -4}, {-2, 12, 57, -3},
    {-2, 10, 58, -2}, {-1, 7, 60, -2}, {0, 4, 62, -2}, {0, 2, 63, -1}};

__host__ __device__ constexpr int clog2(int v) { return v <= 1 ? 0 : 1 + clog2(v >> 1); }

template <int W, int H>
struct Geo {
  static constexpr int LW = clog2(W), LH = clog2(H), HW = W * H;
  static constexpr int Q = HW / 4;                   // 4-sample groups a mode
  static constexpr int QPR = W / 4;                  // ... a row
  static constexpr int EXT = 2 * (W > H ? W : H) + 4;        // ext capacity
  static constexpr int SC = (LW + LH - 2) >> 2;      // planar/DC PDPC scale
};

// the cubic rows, one int4 each, into shared memory (threads 0..31)
__device__ __forceinline__ void load_cubic(int4* cub, int tid) {
  if (tid < 32) cub[tid] = make_int4(kCubic[tid][0], kCubic[tid][1], kCubic[tid][2], kCubic[tid][3]);
}

// sample p of a mode's extended main reference
__device__ __forceinline__ int ext_sample(const int* r, const int* d, int p) {
  const int base = d[D_BASE];
  int idx;
  if (d[D_SD] < 0) {
    if (p >= base) {
      const int j = p - base;
      idx = j < d[D_MAINN] ? d[D_MAIN] + j : 0;
    } else {
      idx = d[D_SIDE] + min(((base - p) * d[D_INV] + 256) >> 9, base);
    }
  } else {
    idx = d[D_MAIN] + min(p, REF_LEN - 1);
  }
  return r[idx];
}

// PDPC of one angular sample at work position (yy, xx)
__device__ __forceinline__ int pdpc(const int* r, const int* d, int yy, int xx,
                                    int v, int max_pix) {
  const int kind = d[D_PDPC];
  if (kind == PDPC_GRAD) {
    if (xx < d[D_PLIM]) {
      const int wl = 32 >> ((2 * xx) >> d[D_PSCALE]);
      const int s = r[d[D_SIDE] +
                      min(yy + ((256 + (xx + 1) * d[D_INV]) >> 9) + 1, REF_LEN - 1)];
      v += (wl * (s - v) + 32) >> 6;
    }
  } else if (kind == PDPC_HV) {
    if (xx < d[D_PLIM]) {
      const int wl = 32 >> ((2 * xx) >> d[D_PSCALE]);
      v += (wl * (r[d[D_SIDE] + 1 + yy] - r[d[D_MAIN]]) + 32) >> 6;
    }
    v = clampi(v, 0, max_pix);
  }
  return v;
}

__device__ __forceinline__ int4 filter_row(const int4* cub, int filt, int df) {
  if (filt == FILT_CUBIC) return cub[df];
  const int f = df >> 1;
  return make_int4(16 - f, 32 - f, 16 + f, f);
}

// one angular sample at work position (yy, xx) from the extended reference
__device__ __forceinline__ int angular(const int* e, const int* d,
                                       const int4* cub, int yy, int xx,
                                       int max_pix) {
  const int dpos = d[D_SD] * (yy + 1);
  const int p = d[D_BASE] + (dpos >> 5) + xx;
  if (d[D_FILT] == FILT_INT) return e[p + 1];
  const int4 wt = filter_row(cub, d[D_FILT], dpos & 31);
  const int v = (e[p] * wt.x + e[p + 1] * wt.y + e[p + 2] * wt.z + e[p + 3] * wt.w + 32) >> 6;
  return d[D_CLIP] ? clampi(v, 0, max_pix) : v;
}

// output samples (oy, ox + j), j < 4, of angular mode d from its extended
// reference e
__device__ __forceinline__ void angular_quad(const int* e, const int* r,
                                             const int* d, const int4* cub,
                                             int oy, int ox, int max_pix,
                                             int v[4]) {
  if (d[D_VERT]) {
    // work row = output row: one deltaInt / deltaFract for the four
    const int dpos = d[D_SD] * (oy + 1);
    const int p = d[D_BASE] + (dpos >> 5) + ox;
    if (d[D_FILT] == FILT_INT) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = e[p + 1 + j];
    } else {
      const int4 wt = filter_row(cub, d[D_FILT], dpos & 31);
      int t[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) t[k] = e[p + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = (t[j] * wt.x + t[j + 1] * wt.y + t[j + 2] * wt.z +
                       t[j + 3] * wt.w + 32) >> 6;
        v[j] = d[D_CLIP] ? clampi(a, 0, max_pix) : a;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = pdpc(r, d, oy, ox + j, v[j], max_pix);
  } else {
    // horizontal: output (oy, ox + j) is work (yy = ox + j, xx = oy)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = pdpc(r, d, ox + j, oy, angular(e, d, cub, ox + j, oy, max_pix),
                  max_pix);
  }
}

}  // namespace ang
}  // namespace uvg
