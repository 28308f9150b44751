// K2 predict67: all 67 intra prediction modes of every block of a class,
// or the M modes of a subset whose slots 0 and 1 are planar and DC (the
// rough search's stage 1, M = 35: the reference's make_predict_fn over
// slice_mode_tables(tables, [0, 1, 2, 4, ..., 66])).
//
// Replaces: uvg266_tpu/ops/intra_batch.py:420 make_predict_matmul_fn (the
// bit-exact twin of the gather form make_predict_fn, :276). The TPU form
// multiplies the packed references by a dense float32 matrix A
// [4*REF_LEN, 67*h*w] (856 MB at 64x64); here the angular modes gather
// straight from the static tables instead:
//   the angular sample of common.cuh angular_sample (shared with K12b);
//   planar (filtered references when w*h > 32) and DC, each
//   with the position-dependent PDPC, then a clip (make_predict_matmul_fn
//   :467-513). Products are < 2^20, so int32 is exact.
//
// Bound on this card: bytes, by the write of preds [B, 67, h, w] int32
// (about 420 MB per 832x480 frame over the four square classes). Design:
// one thread block per (block, group of modes) with the block's 780
// reference samples staged in shared memory; one thread per output sample,
// grid-strided inside the group, so the stores are coalesced. The tables
// are stored narrow (K int16, W int8: 12 bytes per (mode, sample) with the
// PDPC tables) and read with one 8-byte and one 4-byte load; at 64x64 they
// are 3.3 MB and stay in L2 across blocks.

#include <algorithm>

#include "common.cuh"

namespace {

struct Tables {
  uvg::AngTables ang;
  const int* pd_wl;           // [w]
  const int* pd_wt;           // [h]
};

struct Shape {
  int w, h, log2_w, log2_h, max_pix, M, modes_per_block;
  bool planar_filtered, apply_pd;
};

// modes: the mode of each of the M output slots (slots 0 and 1 planar and
// DC), or null for all 67 modes in order
__global__ void predict67_kernel(const int* __restrict__ refs, Tables t,
                                 const int* __restrict__ modes, Shape s,
                                 int* __restrict__ preds) {
  __shared__ int r[uvg::NREF];
  __shared__ int dc_s;
  const int cu = blockIdx.x;
  const int hw = s.w * s.h;
  const int m0 = blockIdx.y * s.modes_per_block;
  const int m1 = min(m0 + s.modes_per_block, s.M);
  const int* rg = refs + static_cast<long long>(cu) * uvg::NREF;
  for (int i = threadIdx.x; i < uvg::NREF; i += blockDim.x) r[i] = rg[i];
  __syncthreads();
  const int L = uvg::REF_LEN;
  if (m0 <= 1 && m1 > 1 && threadIdx.x == 0) {
    // DC from the unfiltered references
    int sum = 0;
    if (s.w >= s.h) for (int i = 0; i < s.w; ++i) sum += r[1 + i];
    if (s.w <= s.h) for (int i = 0; i < s.h; ++i) sum += r[L + 1 + i];
    const int denom = s.w == s.h ? (s.w << 1) : max(s.w, s.h);
    dc_s = (sum + (denom >> 1)) >> (31 - __clz(denom));
  }
  __syncthreads();
  const int psec_t = s.planar_filtered ? 2 : 0;
  const int psec_l = s.planar_filtered ? 3 : 1;
  int* out = preds + static_cast<long long>(cu) * s.M * hw;
  for (int e = m0 * hw + threadIdx.x; e < m1 * hw; e += blockDim.x) {
    const int slot = e / hw;
    const int p = e - slot * hw;
    const int mode = modes == nullptr ? slot : uvg::clampi(modes[slot], 0, 66);
    const int y = p >> s.log2_w;
    const int x = p & (s.w - 1);
    int v;
    if (mode >= 2) {
      v = uvg::angular_sample(r, t.ang, mode, static_cast<long long>(mode) * hw + p,
                              s.max_pix);
    } else {
      int tsec, lsec;
      if (mode == 0) {
        tsec = psec_t;
        lsec = psec_l;
        const int tw = r[tsec * L + 1 + x];
        const int lh = r[lsec * L + 1 + y];
        const int top_right = r[tsec * L + s.w + 1];
        const int bottom_left = r[lsec * L + s.h + 1];
        const int hor = lh * (1 << s.log2_w) + (top_right - lh) * (x + 1);
        const int ver = tw * (1 << s.log2_h) + (bottom_left - tw) * (y + 1);
        v = (hor * (1 << s.log2_h) + ver * (1 << s.log2_w) +
             (1 << (s.log2_w + s.log2_h))) >> (1 + s.log2_w + s.log2_h);
      } else {
        tsec = 0;
        lsec = 1;
        v = dc_s;
      }
      if (s.apply_pd) {
        const int tt = r[tsec * L + 1 + x];
        const int ll = r[lsec * L + 1 + y];
        v = v + ((t.pd_wl[x] * (ll - v) + t.pd_wt[y] * (tt - v) + 32) >> 6);
      }
      v = uvg::clampi(v, 0, s.max_pix);
    }
    out[e] = v;
  }
}

}  // namespace

extern "C" int predict67(const void* refs, int B, int w, int h, int max_pix,
                         const void* K, const void* W, const void* pdpc_wl,
                         const void* pdpc_sidx, const void* hv_wl,
                         const void* hv_sidx, const void* needs_clip,
                         const void* pdpc_on, const void* hv_on,
                         const void* hv_topleft, const void* pd_wl,
                         const void* pd_wt, const void* modes, int M,
                         void* preds, void* stream) {
  Tables t{{static_cast<const short4*>(K), static_cast<const char4*>(W),
            static_cast<const int8_t*>(pdpc_wl), static_cast<const int16_t*>(pdpc_sidx),
            static_cast<const int8_t*>(hv_wl), static_cast<const int16_t*>(hv_sidx),
            static_cast<const uint8_t*>(needs_clip), static_cast<const uint8_t*>(pdpc_on),
            static_cast<const uint8_t*>(hv_on), static_cast<const int16_t*>(hv_topleft)},
           static_cast<const int*>(pd_wl), static_cast<const int*>(pd_wt)};
  const int hw = w * h;
  if (modes == nullptr) M = uvg::NUM_MODES;
  if (M < 2 || M > uvg::NUM_MODES) return static_cast<int>(cudaErrorInvalidValue);
  // about 2048 outputs per thread block: one mode at 64x64, 32 at 8x8
  const int mpb = std::max(1, std::min(M, 2048 / hw));
  Shape s{w, h, uvg::log2i(w), uvg::log2i(h), max_pix, M, mpb,
          w * h > 32, w >= 4 && h >= 4};
  if (B <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid(B, (M + mpb - 1) / mpb);
  predict67_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(refs), t, static_cast<const int*>(modes), s,
      static_cast<int*>(preds));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(predict67)
