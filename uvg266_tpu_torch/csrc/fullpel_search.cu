// K9a fullpel_search: dense full-pel motion search of every block of a
// class over a (2r+1)^2 window of one reference plane.
//
// Replaces: uvg266_tpu/ops/me.py:40 make_fullpel_search_fn (called by
// control/encoder.py search_inter_blocks). The reference fetches each
// block's edge-extended window (ops/inter.py fetch_extended_block, a clamp
// of coordinates) on the host and computes, for every offset (dy, dx) in
// [-r, r]^2,
//   cost = (b2 - 2 * corr + r2) + pen[dy, dx]
// with b2 = sum blk^2, corr = sum blk * win (a grouped convolution) and
// r2 = the box sum of win^2, each a float32 sum in XLA's order; then the
// first minimum in raster order (dy major). Here each term is the exact
// integer (below 2^32 for a 64x64 block at 10 bits: 4096 * 1023^2),
// rounded to float32 once, and the terms are combined in the reference's
// order: ((b2 - 2*corr) + r2) + pen. Where every term is below 2^24 (8
// bits up to 16x16) this equals the reference bit for bit; elsewhere it is
// the correctly rounded value and the reference's own summation error is
// the difference.
//
// Bound on this card: operations: (2r+1)^2 * h * w multiply-adds for corr
// per block (about 0.9 G operations per class at 832x480, r = 16), r2 as
// box sums, against 2 * h * w samples read.
//
// Design: the block's window ((h+2r) x (w+2r), read from the plane on the
// card through clamped coordinates, eight loads in flight a thread), the
// block and the penalty sit in shared memory, the samples as floats
// (integers below 2^10, exact). A thread owns one dy and a strip of S = 12
// consecutive dx (three strips cover the 33 offsets of a row at r = 16)
// and computes everything of those offsets:
// - r2 by box sums: the window's column sums of win^2 over h rows (all
//   threads, each a column and a run of 11 dy, sliding, exact in uint32),
//   then the thread's 12 row sums of those over w columns, sliding;
// - corr register-tiled: it walks the block rows (a share of them where
//   the block is large) and for each group of 8 columns loads the group's
//   window samples and block samples as 16-byte loads, each window sample
//   serving S multiply-adds and each block sample (the same address for
//   the block's threads: a broadcast) S more. The multiply-adds are
//   float32 FMAs, which the card issues at twice the rate of 32-bit
//   integer multiply-adds, and they are exact: the 8 products of a group
//   sum to below 8 * 1023^2 < 2^23; each group accumulates onto 2^23 (an
//   integer float whose ulp is 1 up to 2^24), and the group's exact sum,
//   read back from the float's bits, is added to the thread's uint32
//   total;
// - the cost of its offsets and their first minimum; one warp a block
//   then reduces the threads' (cost, index) pairs.
// Two blocks share a thread block up to 16x16; where they lie side by side
// in a row of the plane, as a class's grid does, their windows overlap
// and one union window is read, with one set of column sums. From 32x32
// on the block rows are split between threads and their exact uint32
// partial sums added. Consecutive lanes take consecutive dy of a strip,
// and the window's row stride is an odd number of 16-byte units, so the 8
// lanes of a quarter warp read 8 different bank groups. The shapes the
// default pu_depth_inter reaches (16x16, 8x8 at r = 16) are compiled with
// constant sizes. tools/k9a_phases.py splits the kernel's time by phase.

#include "common.cuh"

namespace {

constexpr int S = 12;                 // offsets (dx) a thread
constexpr int DYC = 11;               // dy a column-sum task slides over
constexpr int MAX_THREADS = 800;      // 64x64 at r = 16: 8 x 99 tasks
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIAS = 8388608.0f;    // 2^23
constexpr unsigned BIAS_BITS = 0x4B000000u;
static_assert(8 * 1023 * 1023 < (1 << 23),
              "a group of 8 products of 10-bit samples stays below 2^23");

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// a float count rounded up to an odd number of 16-byte units
__host__ __device__ inline int odd_units(int floats) {
  const int u = (floats + 3) / 4;
  return 4 * (u | 1);
}

// an integer-valued float below 2^23 as an integer
__device__ __forceinline__ unsigned as_uint(float v) {
  return __float_as_uint(__fadd_rn(v, BIAS)) - BIAS_BITS;
}

__device__ __forceinline__ int pick4(const int* v, int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Load the windows' array, wh rows of ncols columns: window column c of
// row i is the plane's sample (clamped) at (ox[0] + c, oy[0] + i) where the
// blocks lie side by side, else block c / ww's at (ox + c % ww, oy + i).
// Eight loads in flight a thread; ncols is a constant where the shape is.
__device__ __forceinline__ void load_window_rows(
    const int* __restrict__ ref, int H, int W, const int* ox, const int* oy,
    bool adj, int ww, int wh, int ncols, int stride, float* win) {
  const int total = wh * ncols;
  for (int q0 = threadIdx.x; q0 < total; q0 += 8 * blockDim.x) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * blockDim.x, i = q / ncols, c = q - i * ncols;
      v[u] = 0;
      if (q < total) {
        int px = ox[0] + c, py = oy[0] + i;
        if (!adj) {                  // (selects: ox, oy stay in registers)
          const int bi = c / ww;
          px = pick4(ox, bi) + c - bi * ww;
          py = pick4(oy, bi) + i;
        }
        v[u] = __ldg(ref + static_cast<long long>(uvg::clampi(py, 0, H - 1)) * W +
                     uvg::clampi(px, 0, W - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * blockDim.x, i = q / ncols, c = q - i * ncols;
      if (q < total) win[i * stride + c] = static_cast<float>(v[u]);
    }
  }
}

struct Geo {
  int w, h, r, n, nn, strips, ntask, ww, wh, NB, cst, stride, chunks;
};

__host__ __device__ inline Geo geometry(int w, int h, int r, int NB) {
  Geo g;
  g.w = w;
  g.h = h;
  g.r = r;
  g.n = 2 * r + 1;
  g.nn = g.n * g.n;
  g.strips = (g.n + S - 1) / S;
  g.ntask = g.n * g.strips;                 // (strip, dy) pairs a block
  g.ww = w + 2 * r;
  g.wh = h + 2 * r;
  g.NB = NB;
  // the NB windows side by side in one array of wh rows: block bi's at
  // column bi * w where the blocks lie side by side in a row of the plane
  // (their windows overlap: one union is read), else at bi * ww; the last
  // strip's thread reads up to its window's column strips * S + w - 1
  g.cst = up4(NB * g.ww);                   // column sums' row stride
  g.stride = odd_units(max(NB * g.ww, (NB - 1) * g.ww + g.strips * S + w));
  g.chunks = (g.n + DYC - 1) / DYC;
  return g;
}

// shared memory, in 4-byte words, each part 16-byte aligned: the column
// sums, the split rows' partial corr, the threads' best (cost, index), b2,
// the penalty (a thread reads its offsets' entries 33 apart: from device
// memory each lane would be a transaction of its own), the blocks and the
// windows
struct Layout {
  int colsum, part, red_c, red_i, b2, pen, blk, win, total;
};

__host__ __device__ inline Layout layout(const Geo& g, int KS) {
  Layout l;
  l.colsum = 0;
  l.part = up4(g.n * g.cst);
  l.red_c = l.part + up4(g.NB * (KS - 1) * g.ntask * S);
  l.red_i = l.red_c + up4(g.NB * g.ntask);
  l.b2 = l.red_i + up4(g.NB * g.ntask);
  l.pen = l.b2 + 4;
  l.blk = l.pen + up4(g.nn);
  l.win = l.blk + up4(g.NB * g.w * g.h);
  l.total = l.win + g.wh * g.stride;
  return l;
}

template <int JC, int WT, int HT, int RT>
__global__ void __launch_bounds__(MAX_THREADS)
fullpel_search_kernel(const int* __restrict__ ref, int H, int W,
                      const int* __restrict__ blocks,
                      const int* __restrict__ xs, const int* __restrict__ ys,
                      int B, int w_, int h_, int r_, int NB_, int KS_,
                      const float* __restrict__ pen, int* __restrict__ mvx,
                      int* __restrict__ mvy, float* __restrict__ cost) {
  // the constant shapes are <= 16x16: two blocks a thread block, no split
  const int NB = WT ? 2 : NB_, KS = WT ? 1 : KS_;
  const Geo g = geometry(WT ? WT : w_, HT ? HT : h_, RT ? RT : r_, NB);
  const Layout l = layout(g, KS);
  const int w = g.w, h = g.h, hw = w * h;
  extern __shared__ int4 smem4[];
  unsigned* sm = reinterpret_cast<unsigned*>(smem4);
  unsigned* colsum = sm + l.colsum;            // [n][cst]
  unsigned* part = sm + l.part;                // [NB][KS-1][ntask][S]
  float* red_c = reinterpret_cast<float*>(sm + l.red_c);   // [NB][ntask]
  int* red_i = reinterpret_cast<int*>(sm + l.red_i);       // [NB][ntask]
  unsigned* b2 = sm + l.b2;                    // [NB]
  float* pen_s = reinterpret_cast<float*>(sm + l.pen);     // [nn]
  float* blk = reinterpret_cast<float*>(sm + l.blk);       // [NB][h][w]
  float* win = reinterpret_cast<float*>(sm + l.win);       // [wh][stride]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b0 = blockIdx.x * NB;

  // the window origins (each thread reads them: no barrier), and whether
  // the blocks lie side by side
  int ox[4], oy[4];
  bool adj = b0 + NB <= B;
#pragma unroll
  for (int bi = 0; bi < 4; ++bi) {             // NB <= 4
    const int b = min(b0 + min(bi, NB - 1), B - 1);
    ox[bi] = __ldg(xs + b) - g.r;
    oy[bi] = __ldg(ys + b) - g.r;
    if (bi < NB) adj = adj && ox[bi] == ox[0] + bi * w && oy[bi] == oy[0];
  }
  const int ncols = adj ? (NB - 1) * w + g.ww : NB * g.ww;
  // the penalty and a block sample are loaded, then the windows (whose
  // columns past ncols only the masked offsets read), so that their round
  // trips overlap
  float pv[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int q = tid + u * blockDim.x;
    pv[u] = q < g.nn ? __ldg(pen + q) : 0.0f;
  }
  int bfirst = 0;
  if (tid < NB * hw && b0 + tid / hw < B)
    bfirst = __ldg(blocks + static_cast<long long>(b0) * hw + tid);
  {
    if (adj)
      load_window_rows(ref, H, W, ox, oy, true, g.ww, g.wh,
                       (NB - 1) * w + g.ww, g.stride, win);
    else
      load_window_rows(ref, H, W, ox, oy, false, g.ww, g.wh, NB * g.ww,
                       g.stride, win);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = tid + u * blockDim.x;
      if (q < g.nn) pen_s[q] = pv[u];
    }
    for (int q = tid + 8 * blockDim.x; q < g.nn; q += blockDim.x)
      pen_s[q] = __ldg(pen + q);
    if (tid < NB * hw) blk[tid] = static_cast<float>(bfirst);
    for (int q = tid + blockDim.x; q < NB * hw; q += blockDim.x) {
      const int b = b0 + q / hw;
      blk[q] = b < B ? static_cast<float>(
                           __ldg(blocks + static_cast<long long>(b0) * hw + q))
                     : 0.0f;
    }
  }
  __syncthreads();

  // r2, step 1: column sums of win^2 over h rows, each task a column of
  // the windows and a run of DYC dy, sliding (exact modulo 2^32, and the
  // sums are below it); b2, a warp per block
  for (int q = tid; q < g.chunks * ncols; q += blockDim.x) {
    const int c = q / ncols, x = q - c * ncols;
    const int d0 = c * DYC, d1 = min(d0 + DYC, g.n);
    const float* wc = win + x;
    unsigned s = 0u;
    for (int i = d0; i < d0 + h; ++i) {
      const unsigned v = as_uint(wc[i * g.stride]);
      s += v * v;
    }
    unsigned* cs = colsum + x;
    cs[d0 * g.cst] = s;
    for (int dy = d0 + 1; dy < d1; ++dy) {
      const unsigned a = as_uint(wc[(dy + h - 1) * g.stride]),
                     o = as_uint(wc[(dy - 1) * g.stride]);
      s += a * a - o * o;
      cs[dy * g.cst] = s;
    }
  }
  for (int bi = warp; bi < NB; bi += nwarps) {
    unsigned s = 0u;
    for (int q = lane; q < hw; q += 32) {
      const unsigned v = as_uint(blk[bi * hw + q]);
      s += v * v;
    }
    for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) b2[bi] = s;
  }
  __syncthreads();

  // this thread's block, row share, strip and dy
  const int per_blk = KS * g.ntask;
  const int bi = tid / per_blk, rem = tid - bi * per_blk;
  const int ks = rem / g.ntask, task = rem - ks * g.ntask;
  const int strip = task / g.n, dy = task - strip * g.n, dx0 = strip * S;
  const bool active = bi < NB;
  unsigned acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0u;
  const int base = adj ? bi * w : bi * g.ww;     // the block's window column
  if (active) {
    const int rows = h / KS, i0 = ks * rows;
    const float* wb = win + base + dx0;
    const float* bb = blk + bi * hw;
    for (int i = i0; i < i0 + rows; ++i) {
      const float* wr = wb + (dy + i) * g.stride;
      const float* br = bb + i * w;
      for (int c0 = 0; c0 < w; c0 += JC) {
        float v[JC + S], bv[JC], a[S];
#pragma unroll
        for (int q = 0; q < (JC + S) / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(wr + c0 + 4 * q);
          v[4 * q] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int q = 0; q < JC / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(br + c0 + 4 * q);
          bv[4 * q] = t.x;
          bv[4 * q + 1] = t.y;
          bv[4 * q + 2] = t.z;
          bv[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int s = 0; s < S; ++s) a[s] = BIAS;
#pragma unroll
        for (int t = 0; t < JC; ++t)
#pragma unroll
          for (int s = 0; s < S; ++s) a[s] = __fmaf_rn(bv[t], v[t + s], a[s]);
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] += __float_as_uint(a[s]) - BIAS_BITS;
      }
    }
  }
  // the split rows' partial sums, added by the first share's thread
  if (KS > 1) {
    if (active && ks > 0) {
      unsigned* pp = part + (((bi * (KS - 1) + ks - 1) * g.ntask) + task) * S;
#pragma unroll
      for (int s = 0; s < S; ++s) pp[s] = acc[s];
    }
    __syncthreads();
    if (active && ks == 0) {
      for (int q = 1; q < KS; ++q) {
        const unsigned* qp = part + (((bi * (KS - 1) + q - 1) * g.ntask) + task) * S;
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] += qp[s];
      }
    }
  }
  // the costs of this thread's offsets: r2 from the column sums, sliding
  // along dx; the first minimum (dx ascends)
  if (active && ks == 0) {
    const unsigned* cs = colsum + dy * g.cst + base + dx0;
    unsigned r2 = 0u;
    for (int x = 0; x < w; ++x) r2 += cs[x];
    const float b2f = __uint2float_rn(b2[bi]);
    float best_c = INFINITY;
    int best_i = g.nn;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (dx0 + s < g.n) {
        if (s > 0) r2 += cs[s + w - 1] - cs[s - 1];
        const int k = dy * g.n + dx0 + s;
        float c = __fsub_rn(b2f, __fmul_rn(2.0f, __uint2float_rn(acc[s])));
        c = __fadd_rn(c, __uint2float_rn(r2));
        c = __fadd_rn(c, pen_s[k]);
        if (c < best_c) {
          best_c = c;
          best_i = k;
        }
      }
    }
    red_c[bi * g.ntask + task] = best_c;
    red_i[bi * g.ntask + task] = best_i;
  }
  __syncthreads();

  // the first minimum in raster order, a warp per block: the smaller
  // cost, on a tie the smaller index
  for (int bj = warp; bj < NB; bj += nwarps) {
    const int b = b0 + bj;
    if (b >= B) continue;
    float best_c = INFINITY;
    int best_i = g.nn;
    for (int q = lane; q < g.ntask; q += 32) {
      const float c = red_c[bj * g.ntask + q];
      const int k = red_i[bj * g.ntask + q];
      if (c < best_c || (c == best_c && k < best_i)) {
        best_c = c;
        best_i = k;
      }
    }
    for (int o = 16; o >= 1; o >>= 1) {
      const float oc = __shfl_xor_sync(FULL, best_c, o);
      const int oi = __shfl_xor_sync(FULL, best_i, o);
      if (oc < best_c || (oc == best_c && oi < best_i)) {
        best_c = oc;
        best_i = oi;
      }
    }
    if (lane == 0) {
      mvx[b] = best_i % g.n - g.r;
      mvy[b] = best_i / g.n - g.r;
      cost[b] = best_c;
    }
  }
}

template <int JC, int WT, int HT, int RT>
cudaError_t launch(const int* ref, int H, int W, const int* blocks,
                   const int* xs, const int* ys, int B, int w, int h, int r,
                   const float* pen, int* mvx, int* mvy, float* cost,
                   cudaStream_t st) {
  // split the rows of blocks above 16x16 (KS | h); several blocks a
  // thread block below; at most MAX_THREADS threads
  int KS = 1;
  while (KS < 8 && w * h / (KS * 2) >= 256) KS *= 2;
  int NB = KS == 1 ? 2 : 1;
  const int ntask = geometry(w, h, r, 1).ntask;
  const auto threads = [&] { return (NB * KS * ntask + 31) / 32 * 32; };
  while (NB > 1 && threads() > MAX_THREADS) NB >>= 1;
  while (KS > 1 && threads() > MAX_THREADS) KS >>= 1;
  if (threads() > MAX_THREADS) return cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned) *
      static_cast<size_t>(layout(geometry(w, h, r, NB), KS).total);
  if (smem > 232448) return cudaErrorInvalidValue;     // 227 KB a block
  auto kern = fullpel_search_kernel<JC, WT, HT, RT>;
  // opted in per card and instance, raised to the largest asked (above
  // 48 KB: uvg::SmemGrant)
  static uvg::SmemGrant grant;
  const cudaError_t e = grant.ensure(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<(B + NB - 1) / NB, threads(), smem, st>>>(
      ref, H, W, blocks, xs, ys, B, w, h, r, NB, KS, pen, mvx, mvy, cost);
  return cudaGetLastError();
}

}  // namespace

// ref [H, W] int32 plane; blocks [B, h, w] int32; xs, ys [B] int32 block
// origins; pen [(2r+1)^2] float32 -> mvx, mvy [B] int32, cost [B] float32
extern "C" int fullpel_search(const void* ref, int H, int W, const void* blocks,
                              const void* xs, const void* ys, int B, int w,
                              int h, int r, const void* pen, void* mvx,
                              void* mvy, void* cost, void* stream) {
  if (r < 0 || w < 4 || h < 4 || w > 64 || h > 64 || (w & (w - 1)) ||
      (h & (h - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const auto* rf = static_cast<const int*>(ref);
  const auto* bl = static_cast<const int*>(blocks);
  const auto* x = static_cast<const int*>(xs);
  const auto* y = static_cast<const int*>(ys);
  const auto* p = static_cast<const float*>(pen);
  auto* mx = static_cast<int*>(mvx);
  auto* my = static_cast<int*>(mvy);
  auto* co = static_cast<float*>(cost);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w == 16 && h == 16 && r == 16)
    e = launch<8, 16, 16, 16>(rf, H, W, bl, x, y, B, w, h, r, p, mx, my, co, st);
  else if (w == 8 && h == 8 && r == 16)
    e = launch<8, 8, 8, 16>(rf, H, W, bl, x, y, B, w, h, r, p, mx, my, co, st);
  else if (w >= 8)
    e = launch<8, 0, 0, 0>(rf, H, W, bl, x, y, B, w, h, r, p, mx, my, co, st);
  else
    e = launch<4, 0, 0, 0>(rf, H, W, bl, x, y, B, w, h, r, p, mx, my, co, st);
  return static_cast<int>(e);
}

UVG_ERROR_ENTRY(fullpel_search)
