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
// Bound on this card: bytes. It writes 3120 B of references and h*w*4
// bytes of block per block (at 8x8 the references are 92% of the output)
// and reads the plane (L2-resident, 1.6 MB at 832x480); a few integer
// operations per output. Design: templates over (w, h) for the 25 shapes
// in {4, 8, 16, 32, 64}^2, so every division and modulus is by a constant;
// a thread block of 256 threads holds U blocks (about 1536 int4 of output:
// 7 blocks at 8x8, one at 64x64), in four steps between three barriers,
// each a constant number of unrolled iterations a thread:
// 1. U threads take the blocks' origins (from (x0, y0, sx, sy, gx), or one
//    read of xs and ys) and frame offsets into shared memory;
// 2. the Lt + Ll samples of each block's unfiltered top and left lines are
//    loaded into shared memory once (a few loads a thread; the 780-int
//    row repeats most of them: at 8x8 Lt = 27 of 195), while the block's
//    h rows are copied
//    with one int4 load and store per four samples where the row lies in
//    the plane at x % 4 == 0 (w % 4 == 0 always; W % 4 == 0 and a 16-byte
//    aligned plane checked by the entry), with four clamped scalar loads
//    elsewhere (edge blocks); every load is issued before the first
//    store, so a thread waits for the cache once, not once a load;
// 3. the 780-int row [top | left | ftop | fleft] of each block is formed
//    in shared memory from the lines, position i of all four sections by
//    one thread (two or six reads of the lines for four outputs);
// 4. the rows are written with int4 stores (3120-byte rows: 16-byte
//    aligned), so consecutive threads write consecutive 16 bytes.
// One launch covers every frame of a batch and both outputs.

#include "common.cuh"

namespace {

constexpr int NT = 256;                  // threads a thread block
constexpr int RQ = uvg::NREF / 4;        // int4 of a reference row (195)

template <int W, int H>
struct RGeo {
  static constexpr int LT = 3 * W + 3 < uvg::REF_LEN ? 3 * W + 3 : uvg::REF_LEN;
  static constexpr int LL = 3 * H + 3 < uvg::REF_LEN ? 3 * H + 3 : uvg::REF_LEN;
  static constexpr int LINES = LT + LL;
  static constexpr int WQ = W / 4;       // int4 of a block row
  static constexpr int BQ = H * WQ;      // int4 of a block
  static constexpr int U = RQ + BQ >= 1536 ? 1 : 1536 / (RQ + BQ);
};

// where the blocks lie: at (xs[b], ys[b]), or on the grid when xs is null
struct Pos {
  const int* xs;
  const int* ys;
  int x0, y0, sx, sy, gx, B;
};

template <int W, int H>
__global__ void __launch_bounds__(NT)
    refs_blocks_kernel(const int* __restrict__ src, const int* __restrict__ refsrc,
                       Pos pos, int Hp, int Wp, int n, bool vec,
                       int* __restrict__ refs, int* __restrict__ blocks) {
  using G = RGeo<W, H>;
  // each thread's share of a step, a constant: the loops unroll, and every
  // load of step 2 is issued before its first store
  constexpr int KL = (G::U * G::LINES + NT - 1) / NT;
  constexpr int KB = (G::U * G::BQ + NT - 1) / NT;
  constexpr int KI = (G::U * uvg::REF_LEN + NT - 1) / NT;
  constexpr int KR = (G::U * RQ + NT - 1) / NT;
  __shared__ int ox[G::U], oy[G::U];
  __shared__ long long base[G::U];              // the frame's plane offset
  __shared__ int lines[G::U][G::LINES];         // top (LT), then left (LL)
  __shared__ __align__(16) int row[G::U][uvg::NREF];
  const int tid = threadIdx.x;
  const int fb0 = blockIdx.x * G::U;
  const int nu = min(G::U, n - fb0);

  // 1. the origins
  if (tid < nu) {
    const int fb = fb0 + tid;
    const int f = fb / pos.B, b = fb - f * pos.B;
    ox[tid] = pos.xs ? pos.xs[b] : pos.x0 + (b % pos.gx) * pos.sx;
    oy[tid] = pos.ys ? pos.ys[b] : pos.y0 + (b / pos.gx) * pos.sy;
    base[tid] = static_cast<long long>(f) * Hp * Wp;
  }
  __syncthreads();

  // 2. the unfiltered lines into shared memory, the blocks to their output
  int lv[KL];
  int4 bv[KB];
#pragma unroll
  for (int k = 0; k < KL; ++k) {
    const int e = tid + k * NT;
    if (e < nu * G::LINES) {
      const int u = e / G::LINES, i = e - u * G::LINES;
      const int r = i < G::LT ? oy[u] - 1 : oy[u] + (i - G::LT) - 1;
      const int c = i < G::LT ? ox[u] + i - 1 : ox[u] - 1;
      lv[k] = refsrc[base[u] + uvg::clampi(r, 0, Hp - 1) * Wp +
                     uvg::clampi(c, 0, Wp - 1)];
    }
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int e = tid + k * NT;
    if (e < nu * G::BQ) {
      const int u = e / G::BQ, q = e - u * G::BQ;
      const int r = q / G::WQ, x = ox[u] + (q - r * G::WQ) * 4;
      const int* s = src + base[u] +
                     static_cast<long long>(uvg::clampi(oy[u] + r, 0, Hp - 1)) * Wp;
      if (vec && (ox[u] & 3) == 0 && ox[u] >= 0 && ox[u] + W <= Wp) {
        bv[k] = *reinterpret_cast<const int4*>(s + x);
      } else {
        bv[k] = make_int4(s[uvg::clampi(x, 0, Wp - 1)], s[uvg::clampi(x + 1, 0, Wp - 1)],
                          s[uvg::clampi(x + 2, 0, Wp - 1)],
                          s[uvg::clampi(x + 3, 0, Wp - 1)]);
      }
    }
  }
  int* lflat = &lines[0][0];
#pragma unroll
  for (int k = 0; k < KL; ++k) {
    const int e = tid + k * NT;
    if (e < nu * G::LINES) lflat[e] = lv[k];
  }
  int4* bout = reinterpret_cast<int4*>(blocks) + static_cast<long long>(fb0) * G::BQ;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int e = tid + k * NT;
    if (e < nu * G::BQ) bout[e] = bv[k];
  }
  __syncthreads();

  // 3. the reference rows in shared memory: position i of all four
  // sections [top | left | ftop | fleft] from one read of the lines
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    const int e = tid + k * NT;
    if (e < nu * uvg::REF_LEN) {
      const int u = e / uvg::REF_LEN, i = e - u * uvg::REF_LEN;
      const int* t = lines[u];
      const int* l = t + G::LT;
      const int ti = t[min(i, G::LT - 1)], li = l[min(i, G::LL - 1)];
      int ft = ti, fl = li;
      if (i == 0) {
        ft = fl = (l[1] + 2 * l[0] + t[1] + 2) >> 2;
      } else {
        // i + 1 <= 2w < Lt and i + 1 <= 2h < Ll: ti, li are t[i], l[i]
        if (i < 2 * W) ft = (t[i - 1] + 2 * ti + t[i + 1] + 2) >> 2;
        if (i < 2 * H) fl = (l[i - 1] + 2 * li + l[i + 1] + 2) >> 2;
      }
      int* r = row[u];
      r[i] = ti;
      r[uvg::REF_LEN + i] = li;
      r[2 * uvg::REF_LEN + i] = ft;
      r[3 * uvg::REF_LEN + i] = fl;
    }
  }
  __syncthreads();

  // 4. the rows out, 16 bytes a thread
  int4* rout = reinterpret_cast<int4*>(refs) + static_cast<long long>(fb0) * RQ;
  const int4* rs = reinterpret_cast<const int4*>(&row[0][0]);
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int e = tid + k * NT;
    if (e < nu * RQ) rout[e] = rs[e];
  }
}

template <int W, int H>
int launch(const int* src, const int* refsrc, const Pos& pos, int Hp, int Wp,
           int n, bool vec, int* refs, int* blocks, cudaStream_t stream) {
  using G = RGeo<W, H>;
  const int grid = (n + G::U - 1) / G::U;
  refs_blocks_kernel<W, H><<<grid, NT, 0, stream>>>(src, refsrc, pos, Hp, Wp, n,
                                                    vec, refs, blocks);
  return static_cast<int>(cudaGetLastError());
}

// F frames of B blocks each; refs and blocks 16-byte aligned
int dispatch(const void* src, const void* refsrc, const Pos& pos, int F, int Hp,
             int Wp, int w, int h, void* refs, void* blocks, void* stream) {
  const long long n = static_cast<long long>(F) * pos.B;
  if (n >= (1LL << 31) || reinterpret_cast<uintptr_t>(refs) % 16 ||
      reinterpret_cast<uintptr_t>(blocks) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int* s = static_cast<const int*>(src);
  const int* rs = static_cast<const int*>(refsrc);
  // int4 row loads: every row start 16-byte aligned where x % 4 == 0
  const bool vec = Wp % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  int* r = static_cast<int*>(refs);
  int* b = static_cast<int*>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UVG_REFS(WW, HH) \
  if (w == WW && h == HH) return launch<WW, HH>(s, rs, pos, Hp, Wp, static_cast<int>(n), vec, r, b, st);
#define UVG_REFS_ROW(WW) UVG_REFS(WW, 4) UVG_REFS(WW, 8) UVG_REFS(WW, 16) UVG_REFS(WW, 32) UVG_REFS(WW, 64)
  UVG_REFS_ROW(4) UVG_REFS_ROW(8) UVG_REFS_ROW(16) UVG_REFS_ROW(32) UVG_REFS_ROW(64)
#undef UVG_REFS_ROW
#undef UVG_REFS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int refs_blocks_grid(const void* src, const void* refsrc, int F,
                                int H, int W, int w,
                                int h, int x0, int y0, int sx, int sy, int gx,
                                int gy, void* refs, void* blocks, void* stream) {
  const Pos pos{nullptr, nullptr, x0, y0, sx, sy, gx, gx * gy};
  return dispatch(src, refsrc, pos, F, H, W, w, h, refs, blocks, stream);
}

// K12a: one plane, B blocks at (xs[b], ys[b]) (int32 arrays on the device)
extern "C" int refs_blocks(const void* src, int H, int W, const void* xs,
                           const void* ys, int B, int w, int h, void* refs,
                           void* blocks, void* stream) {
  const Pos pos{static_cast<const int*>(xs), static_cast<const int*>(ys), 0, 0,
                w, h, 1, B};
  return dispatch(src, src, pos, 1, H, W, w, h, refs, blocks, stream);
}

UVG_ERROR_ENTRY(refs_blocks_grid)
UVG_ERROR_ENTRY(refs_blocks)
