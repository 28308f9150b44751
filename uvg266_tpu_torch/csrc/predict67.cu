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
// exact. The angular arithmetic lives in angular.cuh, shared with K12b.
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

#include "angular.cuh"

namespace {

using namespace uvg::ang;
constexpr int THREADS = 256;

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
  load_cubic(cub, tid);
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
    ext[s][p] = ext_sample(r, d, p);
  }
  __syncthreads();
  for (int q = tid; q < ns * G::Q; q += THREADS) {
    const int s = q / G::Q, qq = q % G::Q;
    const int* d = sdesc[s];
    const int oy = qq / G::QPR, ox = (qq % G::QPR) * 4;
    int v[4];
    if (d[D_MODE] < 2) {
      planar_dc<W, H>(r, d[D_MODE], dc_s, oy, ox, max_pix, v);
    } else {
      angular_quad(ext[s], r, d, cub, oy, ox, max_pix, v);
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
