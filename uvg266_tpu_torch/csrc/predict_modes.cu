// K12b predict_modes: angular intra predictions of every block for a mode
// list of its own.
//
// Replaces: uvg266_tpu/ops/intra_batch.py:374 make_predict_modes_fn (the
// refine stage of the rough search, ops/rd_cost.py make_rough_refine_fn).
// Per block b and slot j: the angular prediction of mode
// clamp(modes[b, j], 2, 66) (duplicates computed once per slot), K2's
// arithmetic from angular.cuh: one descriptor per mode (ops/tables.py
// mode_descriptors), the mode's extended main reference, the 4-tap filter
// or copy, the clip, the gradient or hor/ver PDPC.
//
// Bound on this card: bytes, by the write of preds [B, R, h, w] int32 (25.1
// MB per 832x480 frame over the four square classes at R = 4), beside the
// mode lists, the 67 descriptors and the reference samples the blocks'
// modes read. Design: K2's route, templates over (w, h), so every divide is
// a constant; a thread block of 256 threads writes about 2048 output ints:
// U blocks with all R slots (U = 2048 / (R*w*h): 32 at 4x4, 8 at 8x8), or a
// chunk of one block's slots where one block's slots hold more (32x32,
// 64x64), so that one thread block's loads overlap another's stores. Per
// block only the leading samples of each reference section that the
// angular modes of a (w, h) block read (ops/tables.py mode_reach: 70 of the
// 780 at 8x8) go to shared memory, copied asynchronously, with each slot's
// clamped mode. The 67 descriptors come as a kernel parameter, their main
// and side sections already offsets in that compact copy
// (compact_descriptors): no load from device memory but the references
// and the mode lists before the first barrier. Then the extended main
// reference of each slot whose mode projects its side reference
// (sample_disp < 0), a warp a slot; the other modes read their main
// reference in place. After that barrier each thread forms four adjacent
// samples of an output row and writes them with one 16-byte store
// (horizontal modes index their transposed work position, as in K2).

#include <algorithm>

#include "angular.cuh"

namespace {

using namespace uvg::ang;
constexpr int THREADS = 256;
constexpr int OUT_INTS = 2048;          // output ints a thread block
constexpr int DN = D_MODE + 1;          // the descriptor fields the kernel reads

// the 67 descriptors in the compact copy (compact_descriptors), passed by
// value: the kernel reads them from its parameters, with no load from
// device memory before its first barrier
struct Descs {
  int d[uvg::NUM_MODES][DN];
};

// the leading samples of each reference section a thread block loads
struct Reach {
  int off1, off2, off3, nr;             // section offsets in a block's copy
};

// an asynchronous 4-byte copy into shared memory (sm_80 and later): all of
// a thread block's loads are in flight at once
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// blockIdx.x: U blocks from b0 = blockIdx.x * U; blockIdx.y: the slot chunk
// [s0, s0 + S) (S = R unless one block's slots are split)
template <int W, int H>
__global__ void __launch_bounds__(THREADS)
    predict_modes_kernel(const __grid_constant__ Descs ds,
                         const int* __restrict__ refs,
                         const int* __restrict__ modes, int B, int R, int U,
                         int S, Reach rc_, int max_pix, int* __restrict__ preds) {
  using G = Geo<W, H>;
  // output quads a thread: a thread block writes at most max(OUT_INTS, HW)
  constexpr int ITEMS = ((OUT_INTS > G::HW ? OUT_INTS : G::HW) / 4 + THREADS - 1) / THREADS;
  extern __shared__ int4 smem4[];
  int4* cub = smem4;                                  // [32]
  int* smode = reinterpret_cast<int*>(smem4 + 32);    // [U * S]
  int* sbase = smode + U * S;                         // [U * S] a block's copy
  int* rc = sbase + U * S;                            // [U * nr]
  int* ext = rc + U * rc_.nr;                         // [U * S * EXT]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * U;
  const int nb = min(U, B - b0);
  const int s0 = blockIdx.y * S;
  const int ns = min(S, R - s0);
  const int nsu = nb * ns;                            // (block, slot) pairs
  for (int i = tid; i < nb * rc_.nr; i += THREADS) {
    const int u = i / rc_.nr, o = i - u * rc_.nr;
    const int k = (o >= rc_.off1) + (o >= rc_.off2) + (o >= rc_.off3);
    const int o0 = k == 0 ? 0 : k == 1 ? rc_.off1 : k == 2 ? rc_.off2 : rc_.off3;
    cp_async4(rc + i, refs + static_cast<long long>(b0 + u) * uvg::NREF +
                          k * uvg::REF_LEN + o - o0);
  }
  load_cubic(cub, tid);
  for (int i = tid; i < nsu; i += THREADS) {
    const int u = i / ns, s = i - u * ns;
    smode[i] = uvg::clampi(modes[static_cast<long long>(b0 + u) * R + s0 + s], 2, 66);
    sbase[i] = u * rc_.nr;
  }
  cp_async_wait_all();
  __syncthreads();
  // the extended main reference of each slot whose mode projects its side
  // reference (sample_disp < 0), a warp a slot; with sample_disp >= 0 it is
  // the main reference itself (ext[p] = r[main + p], p < D_EXTN < REF_LEN)
  for (int su = tid >> 5; su < nsu; su += THREADS / 32) {
    const int* d = ds.d[smode[su]];
    if (d[D_SD] >= 0) continue;
    for (int p = tid & 31; p < d[D_EXTN]; p += 32)
      ext[su * G::EXT + p] = ext_sample(rc + sbase[su], d, p);
  }
  __syncthreads();
  // the (block, slot) pairs of a thread block are consecutive in preds
  // (all slots of U blocks, or slots s0 .. s0 + ns - 1 of one block)
  int* out = preds + (static_cast<long long>(b0) * R + s0) * G::HW;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int q = tid + k * THREADS;
    if (q >= nsu * G::Q) break;
    const int su = q / G::Q, qq = q % G::Q;
    const int* d = ds.d[smode[su]];
    const int* r = rc + sbase[su];
    const int oy = qq / G::QPR, ox = (qq % G::QPR) * 4;
    int v[4];
    angular_quad(d[D_SD] < 0 ? ext + su * G::EXT : r + d[D_MAIN], r, d, cub,
                 oy, ox, max_pix, v);
    *reinterpret_cast<int4*>(out + static_cast<long long>(su) * G::HW + oy * W + ox) =
        make_int4(v[0], v[1], v[2], v[3]);
  }
}

template <int W, int H>
int launch(const int* refs, const int* modes, int B, int R, int max_pix,
           const int* desc, int ext_max, const int reach[4], int* preds,
           cudaStream_t stream) {
  using G = Geo<W, H>;
  if (ext_max > G::EXT) return static_cast<int>(cudaErrorInvalidValue);
  Reach rc{reach[0], reach[0] + reach[1], reach[0] + reach[1] + reach[2],
           reach[0] + reach[1] + reach[2] + reach[3]};
  Descs ds;
  for (int m = 0; m < uvg::NUM_MODES; ++m)
    for (int f = 0; f < DN; ++f) ds.d[m][f] = desc[m * DESC_N + f];
  // about OUT_INTS output ints a thread block
  const int per = std::max(1, OUT_INTS / G::HW);       // slots a thread block
  int U = 1, S = R;
  if (per >= R) U = std::min(per / R, B);
  else S = per;
  const size_t bytes = 32 * sizeof(int4) +
      sizeof(int) * (2 * static_cast<size_t>(U) * S +
                     static_cast<size_t>(U) * rc.nr +
                     static_cast<size_t>(U) * S * G::EXT);
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        predict_modes_kernel<W, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((B + U - 1) / U, (R + S - 1) / S);
  predict_modes_kernel<W, H><<<grid, THREADS, bytes, stream>>>(
      ds, refs, modes, B, R, U, S, rc, max_pix, preds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// refs [B, 4*REF_LEN], modes [B, R] int32 on the card; desc [67, DESC_N]
// int32 on the host (compact_descriptors), ext_max the longest extended
// reference; n_top .. n_fleft: the leading samples of each section the
// angular modes read (mode_reach), which compact_descriptors' offsets
// follow; preds [B, R, h, w] int32, 16-byte aligned
extern "C" int predict_modes(const void* refs, const void* modes, int B, int R,
                             int w, int h, int max_pix, const void* desc,
                             int ext_max, int n_top, int n_left, int n_ftop,
                             int n_fleft, void* preds, void* stream) {
  if (B <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
  const int rh[4] = {n_top, n_left, n_ftop, n_fleft};
  for (int k = 0; k < 4; ++k)
    if (rh[k] < 0 || rh[k] > uvg::REF_LEN) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(preds) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* rf = static_cast<const int*>(refs);
  const int* md = static_cast<const int*>(modes);
  const int* dh = static_cast<const int*>(desc);
  int* out = static_cast<int*>(preds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UVG_PM(WW, HH) \
  if (w == WW && h == HH) return launch<WW, HH>(rf, md, B, R, max_pix, dh, ext_max, rh, out, st);
#define UVG_PM_ROW(WW) \
  UVG_PM(WW, 4) UVG_PM(WW, 8) UVG_PM(WW, 16) UVG_PM(WW, 32) UVG_PM(WW, 64)
  UVG_PM_ROW(4) UVG_PM_ROW(8) UVG_PM_ROW(16) UVG_PM_ROW(32) UVG_PM_ROW(64)
#undef UVG_PM_ROW
#undef UVG_PM
  return static_cast<int>(cudaErrorInvalidValue);
}

UVG_ERROR_ENTRY(predict_modes)
