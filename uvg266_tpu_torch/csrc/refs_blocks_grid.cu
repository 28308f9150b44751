// K1 refs_blocks_grid: intra reference lines and source blocks for one size
// class on a static position grid; K12a refs_blocks: the same at block
// origins given as two arrays (second C entry, same device code).
//
// Replaces: uvg266_tpu/ops/intra_batch.py:619 make_refs_blocks_grid_fn and
// its smoothing/packing, _smooth_pack (:600); :552 make_refs_blocks_fn.
//
// For block b = (by, bx) at (x, y) = (x0 + bx*sx, y0 + by*sy) of frame f,
// or at (x, y) = (xs[b], ys[b]):
//   top[i]  = P[y, x + min(i, Lt-1)]      Lt = min(3w+3, REF_LEN)
//   left[i] = P[y + min(i, Ll-1), x]      Ll = min(3h+3, REF_LEN)
// where P is the reference plane edge-padded by one at top and left:
//   P[r, c] = refsrc[clamp(r-1), clamp(c-1)],
// refsrc being src itself (all-intra) or a plane of the same shape that the
// references are read from while the blocks still come from src (the
// QP-matched pseudo-reconstruction of inter slices, K5).
// The filtered copies are [1 2 1]/4 over positions 1..2w-1 (top) and
// 1..2h-1 (left); position 0 of both is (l[1] + 2*l[0] + t[1] + 2) >> 2,
// and positions from 2w (2h) on are the unfiltered samples. Output
// refs [F*B, 4*REF_LEN] = [top | left | ftop | fleft] and blocks
// [F*B, h, w] = src[clamp(y + r), clamp(x + c)].
//
// Bound on this card: bytes. It reads the plane (L2-resident, 1.6 MB at
// 832x480) and writes 3.1 KB of references plus h*w*4 bytes per block; a
// handful of integer operations per output. Design: one thread per output
// sample (grid-stride), clamped coordinates in place of a padded copy of
// the plane, so neighbouring threads write neighbouring addresses and no
// intermediate tensor reaches device memory. One launch covers every frame
// of a batch and both outputs.

#include <algorithm>

#include "common.cuh"

namespace {

struct Grid {
  int H, W, w, h, x0, y0, sx, sy, gx, B, Lt, Ll;
};

__device__ __forceinline__ int psample(const int* __restrict__ s, const Grid& g,
                                       int r, int c) {
  return s[uvg::clampi(r - 1, 0, g.H - 1) * g.W + uvg::clampi(c - 1, 0, g.W - 1)];
}

__device__ __forceinline__ int top_at(const int* __restrict__ s, const Grid& g,
                                      int x, int y, int i) {
  return psample(s, g, y, x + min(i, g.Lt - 1));
}

__device__ __forceinline__ int left_at(const int* __restrict__ s, const Grid& g,
                                       int x, int y, int i) {
  return psample(s, g, y + min(i, g.Ll - 1), x);
}

// xs, ys: the block origins [B], or null for those of the grid
__global__ void refs_blocks_grid_kernel(const int* __restrict__ src,
                                        const int* __restrict__ refsrc,
                                        const int* __restrict__ xs,
                                        const int* __restrict__ ys, Grid g,
                                        int F, int* __restrict__ refs,
                                        int* __restrict__ blocks) {
  const int n_refs = F * g.B * uvg::NREF;
  const int hw = g.h * g.w;
  const int n_all = n_refs + F * g.B * hw;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n_all;
       idx += gridDim.x * blockDim.x) {
    if (idx < n_refs) {
      const int j = idx % uvg::NREF;
      const int fb = idx / uvg::NREF;
      const int b = fb % g.B;
      const int* s = refsrc + static_cast<long long>(fb / g.B) * g.H * g.W;
      const int x = xs ? xs[b] : g.x0 + (b % g.gx) * g.sx;
      const int y = ys ? ys[b] : g.y0 + (b / g.gx) * g.sy;
      const int sec = j / uvg::REF_LEN;
      const int i = j % uvg::REF_LEN;
      const bool is_top = (sec & 1) == 0;   // sections 0, 2: top
      int v;
      if (sec < 2) {
        v = is_top ? top_at(s, g, x, y, i) : left_at(s, g, x, y, i);
      } else if (i == 0) {
        v = (left_at(s, g, x, y, 1) + 2 * left_at(s, g, x, y, 0) +
             top_at(s, g, x, y, 1) + 2) >> 2;
      } else {
        const int last = is_top ? 2 * g.w : 2 * g.h;   // rw - 1, rh - 1
        if (i < last) {
          const int a = is_top ? top_at(s, g, x, y, i - 1) : left_at(s, g, x, y, i - 1);
          const int m = is_top ? top_at(s, g, x, y, i) : left_at(s, g, x, y, i);
          const int c = is_top ? top_at(s, g, x, y, i + 1) : left_at(s, g, x, y, i + 1);
          v = (a + 2 * m + c + 2) >> 2;
        } else {
          v = is_top ? top_at(s, g, x, y, i) : left_at(s, g, x, y, i);
        }
      }
      refs[idx] = v;
    } else {
      const int k = idx - n_refs;
      const int p = k % hw;
      const int fb = k / hw;
      const int b = fb % g.B;
      const int* s = src + static_cast<long long>(fb / g.B) * g.H * g.W;
      const int x = (xs ? xs[b] : g.x0 + (b % g.gx) * g.sx) + p % g.w;
      const int y = (ys ? ys[b] : g.y0 + (b / g.gx) * g.sy) + p / g.w;
      blocks[k] = s[uvg::clampi(y, 0, g.H - 1) * g.W + uvg::clampi(x, 0, g.W - 1)];
    }
  }
}

int launch(const int* src, const int* refsrc, const int* xs, const int* ys,
           const Grid& g, int F, int* refs, int* blocks, cudaStream_t stream) {
  const long long n = static_cast<long long>(F) * g.B * (uvg::NREF + g.w * g.h);
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  refs_blocks_grid_kernel<<<uvg::grid_for(n, threads), threads, 0, stream>>>(
      src, refsrc, xs, ys, g, F, refs, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int refs_blocks_grid(const void* src, const void* refsrc, int F,
                                int H, int W, int w,
                                int h, int x0, int y0, int sx, int sy, int gx,
                                int gy, void* refs, void* blocks, void* stream) {
  Grid g{H, W, w, h, x0, y0, sx, sy, gx, gx * gy,
         std::min(3 * w + 3, uvg::REF_LEN), std::min(3 * h + 3, uvg::REF_LEN)};
  return launch(static_cast<const int*>(src), static_cast<const int*>(refsrc),
                nullptr, nullptr, g, F, static_cast<int*>(refs),
                static_cast<int*>(blocks), static_cast<cudaStream_t>(stream));
}

// K12a: one plane, B blocks at (xs[b], ys[b]) (int32 arrays on the device)
extern "C" int refs_blocks(const void* src, int H, int W, const void* xs,
                           const void* ys, int B, int w, int h, void* refs,
                           void* blocks, void* stream) {
  Grid g{H, W, w, h, 0, 0, w, h, 1, B,
         std::min(3 * w + 3, uvg::REF_LEN), std::min(3 * h + 3, uvg::REF_LEN)};
  return launch(static_cast<const int*>(src), static_cast<const int*>(src),
                static_cast<const int*>(xs), static_cast<const int*>(ys), g, 1,
                static_cast<int*>(refs), static_cast<int*>(blocks),
                static_cast<cudaStream_t>(stream));
}

UVG_ERROR_ENTRY(refs_blocks_grid)
UVG_ERROR_ENTRY(refs_blocks)
