// K10 mip_preds: the MIP prediction of every (mode, transpose) candidate for
// every block of a size class.
//
// Replaces: uvg266_tpu/ops/mip.py:108 make_mip_preds_fn. Per block at (x, y)
// of a plane src [H, W] (coordinates clamped to the plane, which is the
// reference's edge padding):
//   top[i]  = src[y - 1, x + i]  i < w        left[j] = src[y + j, x - 1]  j < h
//   tt, ll  = top, left downsampled to red_bdry samples (rounded means)
// and per transpose t: bdry = t ? [ll | tt] : [tt | ll], in_off = bdry[0],
//   inp     = bdry - in_off, inp[0] = size_id < 2 ? (1 << (bd-1)) - in_off : 0
//   offset  = 32 - 32 * sum(inp)
//   red[m][k] = clip(((sum_i M[m][k][i] * inp[i] + offset) >> 6) + in_off)
// (k over red_pred^2, transposed back when t), then linear upsampling by
// w / red_pred horizontally, with left[ups_v - 1 + r * ups_v] as the sample
// before column 0 of reduced row r, and by h / red_pred vertically with top
// as the row before row 0. Output [B, 2 * n_modes, h, w]: transpose False
// modes 0..n-1, then transpose True. All of it stays within int32 at 8 and
// 10 bits; >> of a negative sum is an arithmetic shift.
//
// Bound on this card: bytes, by the write of the predictions (n_cand * w * h
// int32 per block, 113 MB per 832x480 frame over the four square classes);
// the reduced prediction is at most 8 multiply-adds per reduced sample and
// the upsampling six operations per output. Design: one thread block per
// block. Both boundaries, their downsampled forms and the reduced
// predictions of all candidates (at most 768 ints) live in shared memory;
// the weight matrix (at most 3 KB, uint8) is read through the read-only
// cache. Each thread then computes output samples directly from the reduced
// predictions (both upsampling stages fused, no intermediate plane), so
// neighbouring threads write neighbouring addresses.

#include "common.cuh"

namespace {

struct Mip {
  int H, W, w, h, size_id, n_modes, red_bdry, red_pred, ups_h, ups_v, half,
      max_pix;
};

constexpr int MAX_SIDE = 64;
constexpr int MAX_RED_ALL = 768;       // 2 * n_modes * red_pred^2 at most

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

__global__ void mip_preds_kernel(const int* __restrict__ src,
                                 const int* __restrict__ xs,
                                 const int* __restrict__ ys,
                                 const uint8_t* __restrict__ mat, Mip g,
                                 int* __restrict__ preds) {
  __shared__ int top[MAX_SIDE];
  __shared__ int left[MAX_SIDE];
  __shared__ int bd[2][8];             // [transpose][2 * red_bdry]: inp
  __shared__ int in_off[2];
  __shared__ int offset[2];
  __shared__ int red[MAX_RED_ALL];     // [transpose][mode][ry][rx]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int x = xs[b], y = ys[b];
  const int w = g.w, h = g.h;

  for (int i = tid; i < w + h; i += nt) {
    if (i < w) {
      top[i] = src[uvg::clampi(y - 1, 0, g.H - 1) * g.W +
                   uvg::clampi(x + i, 0, g.W - 1)];
    } else {
      const int j = i - w;
      left[j] = src[uvg::clampi(y + j, 0, g.H - 1) * g.W +
                    uvg::clampi(x - 1, 0, g.W - 1)];
    }
  }
  __syncthreads();
  const int rb = g.red_bdry;
  const int in_size = 2 * rb;
  if (tid < 2) {
    // one thread per transpose: downsample, build inp and the offset
    int bdry[8];
    for (int k = 0; k < in_size; ++k) {
      // transpose False: [tt | ll]; True: [ll | tt]
      const bool from_top = (k < rb) != (tid == 1);
      const int* ref = from_top ? top : left;
      const int len = from_top ? w : h;
      const int kk = k < rb ? k : k - rb;
      int v;
      if (rb < len) {
        const int f = len / rb;
        const int lg = ilog2(f);
        int s = 0;
        for (int q = 0; q < f; ++q) s += ref[kk * f + q];
        v = (s + (1 << (lg - 1))) >> lg;
      } else {
        v = ref[kk];
      }
      bdry[k] = v;
    }
    const int off = bdry[0];
    int sum = 0;
    for (int k = 0; k < in_size; ++k) {
      int v = bdry[k] - off;
      if (k == 0) v = g.size_id < 2 ? g.half - off : 0;
      bd[tid][k] = v;
      sum += v;
    }
    in_off[tid] = off;
    offset[tid] = 32 - 32 * sum;
  }
  __syncthreads();
  const int rp = g.red_pred;
  const int rp2 = rp * rp;
  const int n_red = 2 * g.n_modes * rp2;
  for (int i = tid; i < n_red; i += nt) {
    const int t = i / (g.n_modes * rp2);
    const int m = (i / rp2) % g.n_modes;
    const int pos = i % rp2;           // output position (ry, rx)
    const int ry = pos / rp, rx = pos % rp;
    // the matrix row of this output: transposed candidates read k = (rx, ry)
    const int k = t ? rx * rp + ry : pos;
    const uint8_t* row = mat + (static_cast<long long>(m) * rp2 + k) * in_size;
    int acc = offset[t];
    for (int q = 0; q < in_size; ++q) acc += static_cast<int>(row[q]) * bd[t][q];
    red[i] = uvg::clampi((acc >> 6) + in_off[t], 0, g.max_pix);
  }
  __syncthreads();
  const int hw = w * h;
  const int n_out = 2 * g.n_modes * hw;
  const int uh = g.ups_h, uv = g.ups_v;
  const int lgh = ilog2(uh), lgv = ilog2(uv);
  int* out = preds + static_cast<long long>(b) * n_out;
  for (int i = tid; i < n_out; i += nt) {
    const int c = i / hw;              // candidate: t * n_modes + m
    const int Y = (i % hw) / w, X = i % w;
    const int* r = red + c * rp2;
    const int rx = X / uh, ph = X % uh + 1;
    const int ry = Y / uv, pv = Y % uv + 1;
    // the horizontally upsampled value of reduced row rr at column X
    auto hval = [&](int rr) -> int {
      const int cur = r[rr * rp + rx];
      if (uh == 1) return cur;
      const int before = rx == 0 ? left[uv - 1 + rr * uv] : r[rr * rp + rx - 1];
      return ((uh - ph) * before + ph * cur + (1 << (lgh - 1))) >> lgh;
    };
    int v = hval(ry);
    if (uv > 1) {
      const int before = ry == 0 ? top[X] : hval(ry - 1);
      v = ((uv - pv) * before + pv * v + (1 << (lgv - 1))) >> lgv;
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" int mip_preds(const void* src, int H, int W, const void* xs,
                         const void* ys, int B, int w, int h, int bitdepth,
                         const void* mat, void* preds, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (w > MAX_SIDE || h > MAX_SIDE || w < 4 || h < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int size_id = (w == 4 && h == 4) ? 0
                      : (w == 4 || h == 4 || (w == 8 && h == 8)) ? 1 : 2;
  const int n_modes = size_id == 0 ? 16 : size_id == 1 ? 8 : 6;
  const int red_pred = size_id < 2 ? 4 : 8;
  Mip g{H, W, w, h, size_id, n_modes, size_id == 0 ? 2 : 4, red_pred,
        w / red_pred, h / red_pred, 1 << (bitdepth - 1), (1 << bitdepth) - 1};
  const int threads = w * h >= 256 ? 256 : 64;
  mip_preds_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(xs),
      static_cast<const int*>(ys), static_cast<const uint8_t*>(mat), g,
      static_cast<int*>(preds));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(mip_preds)
