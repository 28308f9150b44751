// K7 frame_inter: whole-frame dense full-pel motion search against one
// reference, for every size class of the partition lattice.
//
// Replaces: uvg266_tpu/ops/me_frame.py:159 make_frame_inter_fn, up to its
// RD cost (K6, rd_cost_pred.cu, which the wrapper launches next). Two
// passes per call:
//
// 1. tile SSD maps. For every 8x8 tile t of src [H, W] and every full-pel
//    offset (dy, dx) in [-r, r]^2, k = (dy + r) * n + (dx + r), n = 2r + 1:
//      ssd[t][k] = sum_ij (src[8ty + i][8tx + j]
//                          - ref_pad[8ty + dy + r + i][8tx + dx + r + j])^2
//    ref_pad [H + 2r, W + 2r] is the edge-padded reference. The reference
//    builds this map as b^2 - 2 corr + r^2 in float32 through grouped
//    convolutions (tile_ssd_maps); at 8 bits every term and partial sum is
//    an integer below 2^24, so it is exactly this integer SSD (< 2^23).
//    Here it is b^2 - 2 corr + r^2 in uint32: the same integer modulo 2^32
//    for any int32 planes, so exact wherever the SSD fits int32 (12-bit
//    samples included).
// 2. per class (w, h, grid) and per block b at (x, y) of the grid:
//      acc[k] = float32 sum of the tiles' ssd[.][k] in (i, j) raster order
//               (the order of class_block_maps, me_frame.py:90-95)
//      idx    = first argmin_k float32(acc[k] + pen[k])
//      pred   = ref_pad[y + dy + r + i][x + dx + r + j]   (a plain gather;
//               the reference selects it with one-hot matmuls)
//      blk    = src[y + i][x + j],  extra = bits_tab[idx]
//    A 32x32 block sums 16 tiles and can pass 2^24, so the float32 sum in
//    the reference's order is kept: an exact integer sum rounded once
//    would move argmins.
//
// Bound on this card: operations (a multiply-add per sample and offset for
// corr, 435 M at 832x480 and r = 16; the r^2 box sums and b^2 are small),
// against 1.6 MB of planes read and 27 MB of maps written.
//
// Design, tile pass: a thread block takes a patch of PX x PY tiles that
// share one window of the padded reference in shared memory, (8 PX + 2r) x
// (8 PY + 2r) (64 x 56 at r = 16: read once instead of twelve times),
// loaded a row a warp, a column a lane (no division per sample). r^2 is
// the 8x8 box sum of the squared window, column sums then row sums, once
// per patch; b^2 once per tile. A thread owns one tile and one dy and a
// strip of NS consecutive dx (all 33 at r = 16): it keeps NS accumulators,
// reads each of the tile's 8 source rows as a broadcast and each window
// row's NS + 7 values once, so that one shared load feeds NS multiply-adds
// (33 at r = 16; the window's odd row stride keeps the lanes' rows on
// distinct banks). The maps leave through shared memory as one coalesced
// run per row of tiles. r = 16, the only range the encoder uses, is a
// template instance with every size a constant (4 x 3 tiles, 396 tasks in
// 13 warps); any other r takes a generic instance (one tile, strips of 8).
// No float FMA, dp4a or 8-bit tensor core: they are exact only for 8-bit
// samples, and the entry carries no bit depth.
//
// Design, class pass: one launch over all classes, as many warps a block
// as it has tiles, up to eight (a thread block holds one 32x32 block, two
// 16x16 or eight 8x8), the lanes on the offsets; for 1x1, 2x2 and 4x4
// tiles a loop with the shape a constant loads every tile of 8, 4 or 1
// offsets before the sums, which run in raster order (other shapes load
// eight tiles ahead); the (cost, index) first minimum by a shuffle
// reduction, then across the block's warps; the prediction and source
// gathers written as 16-byte stores.

#include "common.cuh"

namespace {

constexpr int TILE = 8;
constexpr int NCLS = 10;   // ints per class record, see frame_inter()
constexpr unsigned FULL = 0xffffffffu;

// The shared-memory layout of the tile pass (in 4-byte words) for range r,
// a patch of PX x PY tiles and strips of NS offsets
struct TileGeo {
  int r, n, nn, strips, tasks;
  int ww, wh;          // window width, height (samples)
  int wcols, wstride;  // window columns kept (zero past ww), row stride
  int bw, bh;          // box sums: positions per row, rows
  int win, src, b2, box, stage, total;   // offsets and the total
};

template <int PX, int PY, int NS>
__host__ __device__ inline TileGeo tile_geo(int r) {
  TileGeo g;
  g.r = r;
  g.n = 2 * r + 1;
  g.nn = g.n * g.n;
  g.strips = (g.n + NS - 1) / NS;
  g.tasks = PX * PY * g.n * g.strips;
  g.ww = TILE * PX + 2 * r;
  g.wh = TILE * PY + 2 * r;
  g.wcols = g.ww + (g.n % NS ? NS : 0);   // a partial strip reads past ww
  g.wstride = g.wcols | 1;
  g.bw = g.ww - TILE + 1;
  g.bh = g.wh - TILE + 1;
  g.win = 0;
  g.src = g.win + g.wh * g.wstride;
  g.b2 = g.src + PX * PY * 65;             // tiles at a stride of 65 words
  g.box = g.b2 + PX * PY;
  g.stage = g.box + g.bh * (g.bw | 1);
  const int st = PX * PY * g.nn, cs = g.bh * g.ww;   // maps, column sums
  g.total = g.stage + (st > cs ? st : cs);
  return g;
}

// R_ > 0: the range as a constant (and NS = 2 R_ + 1); R_ = 0: any r
template <int R_, int PX, int PY, int NS>
__global__ void __launch_bounds__(R_ ? 416 : 256, R_ ? 2 : 1)
tile_ssd_kernel(const int* __restrict__ src, const int* __restrict__ ref_pad,
                int H, int W, int r_, unsigned* __restrict__ ssd) {
  const TileGeo g = tile_geo<PX, PY, NS>(R_ ? R_ : r_);
  extern __shared__ unsigned smem[];
  unsigned* win = smem + g.win;
  unsigned* srct = smem + g.src;
  unsigned* b2 = smem + g.b2;
  unsigned* box = smem + g.box;
  unsigned* stage = smem + g.stage;
  const int bst = g.bw | 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const int TX = W / TILE, TY = H / TILE;
  const int tx0 = blockIdx.x * PX, ty0 = blockIdx.y * PY;
  const int pxn = min(PX, TX - tx0), pyn = min(PY, TY - ty0);
  const int Wp = W + 2 * g.r, Hp = H + 2 * g.r;
  // the window (zero past the plane and past ww), a row a warp and a
  // column a lane, and the source tiles
  for (int i = warp; i < g.wh; i += nwarps) {
    const int gy = TILE * ty0 + i;
    const int* row = ref_pad + static_cast<long long>(gy) * Wp + TILE * tx0;
    for (int j = lane; j < g.wcols; j += 32)
      win[i * g.wstride + j] =
          (gy < Hp && j < g.ww && TILE * tx0 + j < Wp) ? __ldg(row + j) : 0u;
  }
  for (int q = tid; q < PX * PY * 64; q += nthr) {
    const int tl = q >> 6, e = q & 63, py = tl / PX, px = tl - py * PX;
    srct[tl * 65 + e] =
        (py < pyn && px < pxn)
            ? __ldg(src + static_cast<long long>(TILE * (ty0 + py) + (e >> 3)) * W
                    + TILE * (tx0 + px) + (e & 7))
            : 0;
  }
  __syncthreads();
  // r^2: the column sums of 8 squared window rows (in the stage area), then
  // the row sums of 8 of them; b^2 per tile
  unsigned* cs = stage;
  for (int y = warp; y < g.bh; y += nwarps)
    for (int x = lane; x < g.ww; x += 32) {
      unsigned acc = 0u;
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const unsigned v = win[(y + i) * g.wstride + x];
        acc += v * v;
      }
      cs[y * g.ww + x] = acc;
    }
  for (int tl = warp; tl < PX * PY; tl += nwarps) {
    const unsigned v0 = srct[tl * 65 + lane], v1 = srct[tl * 65 + 32 + lane];
    unsigned acc = v0 * v0 + v1 * v1;
    for (int o = 16; o >= 1; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) b2[tl] = acc;
  }
  __syncthreads();
  for (int y = warp; y < g.bh; y += nwarps)
    for (int x = lane; x < g.bw; x += 32) {
      unsigned acc = 0u;
#pragma unroll
      for (int j = 0; j < TILE; ++j) acc += cs[y * g.ww + x + j];
      box[y * bst + x] = acc;
    }
  __syncthreads();
  // corr and the SSD: task (tile, dy, strip of NS dx)
  const int per_tile = g.n * g.strips;
  for (int task = tid; task < g.tasks; task += nthr) {
    const int tl = task / per_tile, rem = task - tl * per_tile;
    const int a = rem / g.strips, s = rem - a * g.strips;
    const int py = tl / PX, px = tl - py * PX;
    if (py >= pyn || px >= pxn) continue;
    const int b0 = s * NS;
    unsigned acc[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) acc[q] = 0u;
    const unsigned* st = srct + tl * 65;
    const unsigned* wr = win + (TILE * py + a) * g.wstride + TILE * px + b0;
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      unsigned sv[TILE];
#pragma unroll
      for (int j = 0; j < TILE; ++j) sv[j] = st[i * TILE + j];
      const unsigned* row = wr + i * g.wstride;
#pragma unroll
      for (int c = 0; c < NS + TILE - 1; ++c) {
        const unsigned w = row[c];
#pragma unroll
        for (int j = 0; j < TILE; ++j)
          if (c - j >= 0 && c - j < NS) acc[c - j] += sv[j] * w;
      }
    }
    const unsigned bb = b2[tl];
    const unsigned* bx = box + (TILE * py + a) * bst + TILE * px + b0;
    unsigned* out = stage + tl * g.nn + a * g.n + b0;
#pragma unroll
    for (int q = 0; q < NS; ++q)
      if (R_ || b0 + q < g.n) out[q] = bb + bx[q] - 2u * acc[q];
  }
  __syncthreads();
  // the maps: a row of the patch's tiles is one run of pxn * nn words
  for (int py = 0; py < pyn; ++py) {
    unsigned* dst = ssd + (static_cast<long long>(ty0 + py) * TX + tx0) * g.nn;
    const unsigned* from = stage + py * PX * g.nn;
    for (int q = tid; q < pxn * g.nn; q += nthr) dst[q] = from[q];
  }
}

template <int R_, int PX, int PY, int NS>
cudaError_t launch_tiles(const int* src, const int* ref_pad, int H, int W,
                         int r, unsigned* ssd, cudaStream_t st) {
  const TileGeo g = tile_geo<PX, PY, NS>(r);
  const size_t smem = sizeof(unsigned) * static_cast<size_t>(g.total);
  auto kern = tile_ssd_kernel<R_, PX, PY, NS>;
  // above 48 KB by opt-in, raised once per instance to the largest asked
  // (so that no attribute call lands inside a CUDA graph's capture after
  // the first launch)
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  const dim3 grid((W / TILE + PX - 1) / PX, (H / TILE + PY - 1) / PY);
  const int threads = R_ ? (g.tasks + 31) / 32 * 32 : 256;
  kern<<<grid, threads, smem, st>>>(src, ref_pad, H, W, r, ssd);
  return cudaGetLastError();
}

constexpr int MAXC = 8;    // classes a launch of the class pass
constexpr int WPB = 8;     // warps a thread block

struct Classes {
  int n;
  int wT[MAXC], hT[MAXC], x0[MAXC], y0[MAXC], sx[MAXC], sy[MAXC], gx[MAXC];
  int nb[MAXC];            // blocks of the class
  int G[MAXC];             // warps a block (1, 2, 4 or 8)
  int b_off[MAXC];
  int first[MAXC + 1];     // each class's first thread block; first[n]: all
  long long px_off[MAXC];
};

__device__ __forceinline__ bool better(float oc, int oi, float bc, int bi) {
  return oi >= 0 && (bi < 0 || oc < bc || (oc == bc && oi < bi));
}

// warps a block of the class pass: as many as its tiles, up to a thread
// block
__host__ __device__ constexpr int warps_for(int tiles) {
  return tiles >= 8 ? 8 : tiles >= 4 ? 4 : tiles >= 2 ? 2 : 1;
}

// tile t's map of a block of WT tiles a row (maps nn words, rs words a
// row of tiles)
template <int WT>
__device__ __forceinline__ const int* tile_map(const int* base, int t, int rs,
                                               int nn) {
  return base + (t / WT) * rs + (t % WT) * nn;
}

// The (cost, index) minimum of a lane's offsets k0, k0 + S, ... of one
// block whose tile maps start at base: per offset the float32 sum of its
// tiles' SSDs in raster order, + pen; ascending k, strict <, so the first
// minimum. WT x HT tiles as constants (S = 32 warps_for(WT HT); KQ offsets'
// tiles all loaded before their sums), or WT = HT = 0: wT x hT at run time,
// the tiles loaded eight ahead of their sums.
template <int WT, int HT>
__device__ __forceinline__ void lane_min(const int* __restrict__ base,
                                         int TX, int nn, int wT, int hT,
                                         const float* __restrict__ pen,
                                         int k0, int S_, float& bc, int& bi) {
  constexpr int NT = WT * HT;
  if constexpr (NT > 0) {
    constexpr int S = 32 * warps_for(NT);
    constexpr int KQ = NT == 1 ? 8 : NT <= 4 ? 4 : 1;
    const int rs = TX * nn;
    for (; k0 + (KQ - 1) * S < nn; k0 += KQ * S) {
      int v[NT][KQ];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int q = 0; q < KQ; ++q)
          v[t][q] = __ldg(tile_map<WT>(base, t, rs, nn) + k0 + q * S);
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        float acc = __int2float_rn(v[0][q]);
#pragma unroll
        for (int t = 1; t < NT; ++t) acc = __fadd_rn(acc, __int2float_rn(v[t][q]));
        const float cost = __fadd_rn(acc, __ldg(pen + k0 + q * S));
        if (bi < 0 || cost < bc) {
          bc = cost;
          bi = k0 + q * S;
        }
      }
    }
    for (; k0 < nn; k0 += S) {
      float acc = __int2float_rn(__ldg(base + k0));
#pragma unroll
      for (int t = 1; t < NT; ++t)
        acc = __fadd_rn(acc, __int2float_rn(__ldg(tile_map<WT>(base, t, rs, nn) + k0)));
      const float cost = __fadd_rn(acc, __ldg(pen + k0));
      if (bi < 0 || cost < bc) {
        bc = cost;
        bi = k0;
      }
    }
  } else {
    const int nt = wT * hT;
    for (; k0 < nn; k0 += S_) {
      float acc = 0.f;
      int ti = 0, tj = 0;                  // tile t0's row and column
      for (int t0 = 0; t0 < nt; t0 += 8) {
        int v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          v[u] = t0 + u < nt
                     ? __ldg(base + (static_cast<long long>(ti) * TX + tj) * nn + k0)
                     : 0;
          if (++tj == wT) {
            tj = 0;
            ++ti;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (t0 + u < nt) {
            const float f = __int2float_rn(v[u]);
            acc = t0 + u == 0 ? f : __fadd_rn(acc, f);
          }
      }
      const float cost = __fadd_rn(acc, __ldg(pen + k0));
      if (bi < 0 || cost < bc) {
        bc = cost;
        bi = k0;
      }
    }
  }
}

__global__ void __launch_bounds__(32 * WPB, 4)
block_search_kernel(const int* __restrict__ src,
                    const int* __restrict__ ref_pad,
                    const int* __restrict__ ssd,
                    const float* __restrict__ pen,
                    const float* __restrict__ bits_tab, int W, int TX, int r,
                    Classes cl, int* __restrict__ idx_out,
                    int* __restrict__ pred_out, int* __restrict__ blk_out,
                    float* __restrict__ extra_out) {
  __shared__ float wc[WPB];
  __shared__ int wi[WPB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c = 0;
  while (blockIdx.x >= cl.first[c + 1]) ++c;
  // a thread block holds WPB / G blocks of class c, G warps each
  const int G = cl.G[c], wg = warp % G;
  const int b = (blockIdx.x - cl.first[c]) * (WPB / G) + warp / G;
  const bool active = b < cl.nb[c];
  const int gx = cl.gx[c], wT = cl.wT[c], hT = cl.hT[c];
  const int x = cl.x0[c] + (b % gx) * cl.sx[c];
  const int y = cl.y0[c] + (b / gx) * cl.sy[c];
  const int n = 2 * r + 1, nn = n * n;
  const int* base = ssd + (static_cast<long long>(y / TILE) * TX + x / TILE) * nn;
  float bc = 0.f;
  int bi = -1;
  // the group's lanes on the offsets: lane (wg, lane) takes k = 32 wg +
  // lane + 32 G m
  const int S = 32 * G;
  if (active) {
    const int k0 = wg * 32 + lane;
    if (wT == 1 && hT == 1)
      lane_min<1, 1>(base, TX, nn, wT, hT, pen, k0, S, bc, bi);
    else if (wT == 2 && hT == 2)
      lane_min<2, 2>(base, TX, nn, wT, hT, pen, k0, S, bc, bi);
    else if (wT == 4 && hT == 4)
      lane_min<4, 4>(base, TX, nn, wT, hT, pen, k0, S, bc, bi);
    else
      lane_min<0, 0>(base, TX, nn, wT, hT, pen, k0, S, bc, bi);
  }
  for (int o = 16; o >= 1; o >>= 1) {
    const float oc = __shfl_xor_sync(FULL, bc, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (better(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
  if (G > 1) {                             // uniform in the thread block
    if (lane == 0) {
      wc[warp] = bc;
      wi[warp] = bi;
    }
    __syncthreads();
    const int g0 = warp - wg;
    for (int q = 0; q < G; ++q)
      if (better(wc[g0 + q], wi[g0 + q], bc, bi)) {
        bc = wc[g0 + q];
        bi = wi[g0 + q];
      }
  }
  if (!active) return;
  const int bo = cl.b_off[c] + b;
  if (wg == 0 && lane == 0) {
    idx_out[bo] = bi;
    extra_out[bo] = bits_tab[bi];
  }
  const int dy = bi / n - r, dx = bi % n - r;
  const int w = wT * TILE, hw = w * cl.hT[c] * TILE;
  const int Wp = W + 2 * r;
  const long long o = cl.px_off[c] + static_cast<long long>(b) * hw;
  for (int p = 4 * (wg * 32 + lane); p < hw; p += 4 * S) {
    const int i = p / w, j = p - i * w;
    const int* rp = ref_pad + static_cast<long long>(y + dy + r + i) * Wp
                    + x + dx + r + j;
    const int* sp = src + static_cast<long long>(y + i) * W + x + j;
    const int4 pv = make_int4(__ldg(rp), __ldg(rp + 1), __ldg(rp + 2),
                              __ldg(rp + 3));
    const int4 bv = make_int4(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                              __ldg(sp + 3));
    *reinterpret_cast<int4*>(pred_out + o + p) = pv;
    *reinterpret_cast<int4*>(blk_out + o + p) = bv;
  }
}

}  // namespace

// classes: host array of n_classes records of NCLS ints
//   (w, h, x0, y0, sx, sy, gx, gy, b_off, px_off): the grid, and where the
//   class's blocks start in the idx/extra outputs (b_off) and in the
//   pred/blk outputs (px_off, in samples). ssd: scratch [(H/8)*(W/8), n*n].
//   n_classes = 0 runs the tile pass alone. pred and blk 16-byte aligned.
extern "C" int frame_inter(const void* src, const void* ref_pad, int H, int W,
                           int r, const void* pen, const void* bits_tab,
                           const void* classes, int n_classes, void* ssd,
                           void* idx, void* pred, void* blk, void* extra,
                           void* stream) {
  if (H % TILE || W % TILE || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int TY = H / TILE, TX = W / TILE;
  const auto* s = static_cast<const int*>(src);
  const auto* rp = static_cast<const int*>(ref_pad);
  auto* map = static_cast<unsigned*>(ssd);
  const int* cl = static_cast<const int*>(classes);
  for (int q = 0; q < n_classes; ++q) {
    const int* e = cl + q * NCLS;
    if (e[0] <= 0 || e[1] <= 0 || e[0] % TILE || e[1] % TILE || e[2] % TILE
        || e[3] % TILE || e[4] % TILE || e[5] % TILE)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_classes > 0 && (reinterpret_cast<uintptr_t>(pred) % 16
                        || reinterpret_cast<uintptr_t>(blk) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (TY * TX > 0) {
    const TileGeo g = r == 16 ? tile_geo<4, 3, 33>(r) : tile_geo<1, 1, 8>(r);
    if (sizeof(unsigned) * static_cast<size_t>(g.total) > 232448)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        r == 16 ? launch_tiles<16, 4, 3, 33>(s, rp, H, W, r, map, st)
                : launch_tiles<0, 1, 1, 8>(s, rp, H, W, r, map, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // MAXC classes a launch; a class without blocks takes no thread block
  for (int q0 = 0; q0 < n_classes; q0 += MAXC) {
    Classes c{};
    c.n = min(MAXC, n_classes - q0);
    int tbs = 0;
    for (int q = 0; q < c.n; ++q) {
      const int* e = cl + (q0 + q) * NCLS;
      const int tiles = (e[0] / TILE) * (e[1] / TILE);
      c.wT[q] = e[0] / TILE;
      c.hT[q] = e[1] / TILE;
      c.x0[q] = e[2];
      c.y0[q] = e[3];
      c.sx[q] = e[4];
      c.sy[q] = e[5];
      c.gx[q] = e[6];
      c.nb[q] = e[6] > 0 && e[7] > 0 ? e[6] * e[7] : 0;
      c.G[q] = warps_for(tiles);
      c.b_off[q] = e[8];
      c.px_off[q] = e[9];
      c.first[q] = tbs;
      const int per = WPB / c.G[q];
      tbs += (c.nb[q] + per - 1) / per;
    }
    c.first[c.n] = tbs;
    if (tbs == 0) continue;
    block_search_kernel<<<tbs, 32 * WPB, 0, st>>>(
        s, rp, static_cast<const int*>(ssd), static_cast<const float*>(pen),
        static_cast<const float*>(bits_tab), W, TX, r, c,
        static_cast<int*>(idx), static_cast<int*>(pred), static_cast<int*>(blk),
        static_cast<float*>(extra));
  }
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(frame_inter)
