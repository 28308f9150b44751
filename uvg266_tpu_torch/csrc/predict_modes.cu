// K12b predict_modes: angular intra predictions of every block for a mode
// list of its own.
//
// Replaces: uvg266_tpu/ops/intra_batch.py:374 make_predict_modes_fn (the
// refine stage of the rough search, ops/rd_cost.py make_rough_refine_fn).
// Per block b and slot j: the angular prediction of mode modes[b, j] in
// [2, 66] (duplicates allowed), the arithmetic of K2's angular modes
// (common.cuh angular_sample, shared with predict67.cu): 4-tap gather and
// weighted sum, clip where the mode needs it, gradient and hor/ver PDPC.
//
// Bound on this card: bytes, by the write of preds [B, R, h, w] int32 and
// the table reads (12 bytes per predicted sample from the [67, h*w] tables,
// which stay in L2). Design: predict67's: one thread block per block, its
// 780 reference samples in shared memory, one thread per output sample,
// strided, so the stores are coalesced; the mode of each slot is read from
// the list instead of being the slot itself.

#include "common.cuh"

namespace {

__global__ void predict_modes_kernel(const int* __restrict__ refs,
                                     uvg::AngTables t, int hw, int R,
                                     int max_pix, const int* __restrict__ modes,
                                     int* __restrict__ preds) {
  __shared__ int r[uvg::NREF];
  const int cu = blockIdx.x;
  const int* rg = refs + static_cast<long long>(cu) * uvg::NREF;
  for (int i = threadIdx.x; i < uvg::NREF; i += blockDim.x) r[i] = rg[i];
  __syncthreads();
  const int* ml = modes + static_cast<long long>(cu) * R;
  int* out = preds + static_cast<long long>(cu) * R * hw;
  for (int e = threadIdx.x; e < R * hw; e += blockDim.x) {
    const int slot = e / hw;
    const int p = e - slot * hw;
    // a mode outside [2, 66] is not an angular mode: clamped so that no
    // table is read out of bounds
    const int mode = uvg::clampi(ml[slot], 2, 66);
    out[e] = uvg::angular_sample(r, t, mode, static_cast<long long>(mode) * hw + p,
                                 max_pix);
  }
}

}  // namespace

// modes [B, R] int32 on the card; preds [B, R, h, w] int32
extern "C" int predict_modes(const void* refs, const void* modes, int B, int R,
                             int w, int h, int max_pix, const void* K,
                             const void* W, const void* pdpc_wl,
                             const void* pdpc_sidx, const void* hv_wl,
                             const void* hv_sidx, const void* needs_clip,
                             const void* pdpc_on, const void* hv_on,
                             const void* hv_topleft, void* preds, void* stream) {
  uvg::AngTables t{static_cast<const short4*>(K), static_cast<const char4*>(W),
                   static_cast<const int8_t*>(pdpc_wl),
                   static_cast<const int16_t*>(pdpc_sidx),
                   static_cast<const int8_t*>(hv_wl),
                   static_cast<const int16_t*>(hv_sidx),
                   static_cast<const uint8_t*>(needs_clip),
                   static_cast<const uint8_t*>(pdpc_on),
                   static_cast<const uint8_t*>(hv_on),
                   static_cast<const int16_t*>(hv_topleft)};
  if (B <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
  predict_modes_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(refs), t, w * h, R, max_pix,
      static_cast<const int*>(modes), static_cast<int*>(preds));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(predict_modes)
