// K2 predict67: all 67 intra prediction modes of every block of a class,
// or the M modes of a subset whose slots 0 and 1 are planar and DC (the
// rough search's stage 1, M = 35: the reference's make_predict_fn over
// slice_mode_tables(tables, [0, 1, 2, 4, ..., 66])).
//
// Replaces: uvg266_tpu/ops/intra_batch.py:420 make_predict_matmul_fn (the
// bit-exact twin of the gather form make_predict_fn, :276). The TPU form
// multiplies the packed references by a dense float32 matrix A
// [4*REF_LEN, 67*h*w] (856 MB at 64x64). Here each angular sample is
// computed as VVC defines it, from one small descriptor per mode
// (ops/tables.py mode_descriptors: main and side sections, sample_disp and
// the inverse angle, the filter, the clip, the PDPC kind, scale and
// extent), so no per-sample table is read: planar (filtered references when
// w*h > 32) and DC, each with the position-dependent PDPC, then a clip, as
// before (make_predict_matmul_fn :467-513). Products are < 2^20: int32 is
// exact.
//
// Bound on this card: bytes, by the write of preds [B, M, h, w] int32
// (about 420 MB per 832x480 frame over the four square classes). Design:
// templates over (w, h), so every divide and shift is a constant; one
// thread block of 256 threads per (block, chunk of modes), the chunks cut
// so a class fills the card (a 64x64 class of 91 blocks runs 6 chunks);
// the block's 780 reference samples in shared memory; the extended main
// reference of every mode of the chunk built there next
// (build_mode_tables' ext_idx: the side reference projected through the
// inverse angle for negative slopes); after that barrier all the chunk's
// samples with no barrier between modes: per work row one deltaInt /
// deltaFract and one filter row (the cubic rows from
// __constant__ memory, staged in shared memory), whose four taps are
// contiguous in the extended reference. Each thread writes four adjacent
// samples of one output row with a 16-byte store; horizontal modes index
// their transposed work position per sample instead of passing through a
// transposing tile, so their stores are as wide and no barrier is added.

#include <algorithm>

#include "common.cuh"

namespace {

// the descriptor fields (ops/tables.py D_*)
enum {
  D_VERT, D_MAIN, D_SIDE, D_SD, D_INV, D_FILT, D_CLIP, D_PDPC, D_PSCALE,
  D_PLIM, D_BASE, D_EXTN, D_MAINN, D_MODE, DESC_N = 16
};
constexpr int FILT_INT = 0, FILT_CUBIC = 1;     // else the gauss filter
constexpr int PDPC_GRAD = 1, PDPC_HV = 2;
constexpr int THREADS = 256;

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

// PDPC of one angular sample at work position (yy, xx)
__device__ __forceinline__ int pdpc(const int* r, const int* d, int yy, int xx,
                                    int v, int max_pix) {
  const int kind = d[D_PDPC];
  if (kind == PDPC_GRAD) {
    if (xx < d[D_PLIM]) {
      const int wl = 32 >> ((2 * xx) >> d[D_PSCALE]);
      const int s = r[d[D_SIDE] +
                      min(yy + ((256 + (xx + 1) * d[D_INV]) >> 9) + 1, uvg::REF_LEN - 1)];
      v += (wl * (s - v) + 32) >> 6;
    }
  } else if (kind == PDPC_HV) {
    if (xx < d[D_PLIM]) {
      const int wl = 32 >> ((2 * xx) >> d[D_PSCALE]);
      v += (wl * (r[d[D_SIDE] + 1 + yy] - r[d[D_MAIN]]) + 32) >> 6;
    }
    v = uvg::clampi(v, 0, max_pix);
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
  return d[D_CLIP] ? uvg::clampi(v, 0, max_pix) : v;
}

template <int W, int H>
__device__ __forceinline__ void planar_dc(const int* r, int mode, int dc, int oy,
                                          int ox, int max_pix, int v[4]) {
  using G = Geo<W, H>;
  const int L = uvg::REF_LEN;
  const int ts = mode == 0 ? (G::HW > 32 ? 2 : 0) : 0;
  const int ls = mode == 0 ? (G::HW > 32 ? 3 : 1) : 1;
  const int ll = r[ls * L + 1 + oy];
  const int wt = 32 >> min(31, (2 * oy) >> G::SC);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = ox + j;
    const int tt = r[ts * L + 1 + x];
    int p;
    if (mode == 0) {
      const int top_right = r[ts * L + W + 1];
      const int bottom_left = r[ls * L + H + 1];
      const int hor = ll * (1 << G::LW) + (top_right - ll) * (x + 1);
      const int ver = tt * (1 << G::LH) + (bottom_left - tt) * (oy + 1);
      p = (hor * (1 << G::LH) + ver * (1 << G::LW) + (1 << (G::LW + G::LH))) >>
          (1 + G::LW + G::LH);
    } else {
      p = dc;
    }
    const int wl = 32 >> min(31, (2 * x) >> G::SC);
    p = p + ((wl * (ll - p) + wt * (tt - p) + 32) >> 6);
    v[j] = uvg::clampi(p, 0, max_pix);
  }
}

// desc_g [67, DESC_N] (mode_descriptors); modes: the mode of each of the M
// output slots (slots 0 and 1 planar and DC), or null for all 67 in order;
// blockIdx.y: the chunk of mpc slots
template <int W, int H>
__global__ void __launch_bounds__(THREADS)
    predict67_kernel(const int* __restrict__ refs, const int* __restrict__ desc_g,
                     const int* __restrict__ modes, int M, int mpc, int max_pix,
                     int* __restrict__ preds) {
  using G = Geo<W, H>;
  __shared__ int r[uvg::NREF];
  __shared__ int ext[uvg::NUM_MODES][G::EXT];
  __shared__ int sdesc[uvg::NUM_MODES][DESC_N];
  __shared__ int4 cub[32];
  __shared__ int dc_s;
  const int cu = blockIdx.x;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * mpc;
  const int ns = min(mpc, M - m0);
  const int* rg = refs + static_cast<long long>(cu) * uvg::NREF;
  for (int i = tid; i < uvg::NREF; i += THREADS) r[i] = rg[i];
  for (int i = tid; i < ns * DESC_N; i += THREADS) {
    const int s = i / DESC_N, f = i % DESC_N;
    const int mode = modes == nullptr ? m0 + s : uvg::clampi(modes[m0 + s], 0, 66);
    sdesc[s][f] = desc_g[mode * DESC_N + f];
  }
  if (tid < 32) cub[tid] = make_int4(kCubic[tid][0], kCubic[tid][1], kCubic[tid][2], kCubic[tid][3]);
  __syncthreads();
  if (tid == 0) {
    // DC from the unfiltered references
    int sum = 0;
    if (W >= H) for (int i = 0; i < W; ++i) sum += r[1 + i];
    if (W <= H) for (int i = 0; i < H; ++i) sum += r[uvg::REF_LEN + 1 + i];
    constexpr int denom = W == H ? (W << 1) : (W > H ? W : H);
    dc_s = (sum + (denom >> 1)) >> clog2(denom);
  }
  int* out = preds + static_cast<long long>(cu) * M * G::HW;
  // the extended main reference of each angular mode of the chunk
  for (int i = tid; i < ns * G::EXT; i += THREADS) {
    const int s = i / G::EXT, p = i % G::EXT;
    const int* d = sdesc[s];
    if (d[D_MODE] < 2 || p >= d[D_EXTN]) continue;
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
      idx = d[D_MAIN] + min(p, uvg::REF_LEN - 1);
    }
    ext[s][p] = r[idx];
  }
  __syncthreads();
  for (int q = tid; q < ns * G::Q; q += THREADS) {
    const int s = q / G::Q, qq = q % G::Q;
    const int* d = sdesc[s];
    const int oy = qq / G::QPR, ox = (qq % G::QPR) * 4;
    int v[4];
    if (d[D_MODE] < 2) {
      planar_dc<W, H>(r, d[D_MODE], dc_s, oy, ox, max_pix, v);
    } else if (d[D_VERT]) {
      // work row = output row: one deltaInt / deltaFract for the four
      const int* e = ext[s];
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
          v[j] = d[D_CLIP] ? uvg::clampi(a, 0, max_pix) : a;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = pdpc(r, d, oy, ox + j, v[j], max_pix);
    } else {
      // horizontal: output (oy, ox + j) is work (yy = ox + j, xx = oy)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = pdpc(r, d, ox + j, oy,
                    angular(ext[s], d, cub, ox + j, oy, max_pix), max_pix);
    }
    *reinterpret_cast<int4*>(out + static_cast<long long>(m0 + s) * G::HW + oy * W + ox) =
        make_int4(v[0], v[1], v[2], v[3]);
  }
}

template <int W, int H>
int launch(const int* refs, int B, int max_pix, const int* desc, int ext_max,
           const int* modes, int M, int* preds, cudaStream_t stream) {
  using G = Geo<W, H>;
  if (ext_max > G::EXT) return static_cast<int>(cudaErrorInvalidValue);
  // chunks of modes, enough of them that the class fills the card (about
  // four thread blocks per SM)
  const int want = std::min(M, std::max(1, (4 * 132 + B - 1) / B));
  const int mpc = (M + want - 1) / want;
  const dim3 grid(B, (M + mpc - 1) / mpc);
  predict67_kernel<W, H><<<grid, THREADS, 0, stream>>>(refs, desc, modes, M, mpc,
                                                       max_pix, preds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int predict67(const void* refs, int B, int w, int h, int max_pix,
                         const void* desc, int ext_max, const void* modes, int M,
                         void* preds, void* stream) {
  if (modes == nullptr) M = uvg::NUM_MODES;
  if (M < 2 || M > uvg::NUM_MODES) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int* rf = static_cast<const int*>(refs);
  const int* ds = static_cast<const int*>(desc);
  const int* md = static_cast<const int*>(modes);
  int* out = static_cast<int*>(preds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UVG_P67(WW, HH) \
  if (w == WW && h == HH) return launch<WW, HH>(rf, B, max_pix, ds, ext_max, md, M, out, st);
#define UVG_P67_ROW(WW) \
  UVG_P67(WW, 4) UVG_P67(WW, 8) UVG_P67(WW, 16) UVG_P67(WW, 32) UVG_P67(WW, 64)
  UVG_P67_ROW(4) UVG_P67_ROW(8) UVG_P67_ROW(16) UVG_P67_ROW(32) UVG_P67_ROW(64)
#undef UVG_P67_ROW
#undef UVG_P67
  return static_cast<int>(cudaErrorInvalidValue);
}

UVG_ERROR_ENTRY(predict67)
