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
// int32 per block, 82 MB per 832x480 frame over the four square classes);
// the reduced prediction is at most 8 multiply-adds per reduced sample and
// the upsampling three operations per output and stage. Design: templates
// over (w, h), so every geometry value is a constant expression and every
// division a shift. A thread block of 256 threads writes about 4096
// consecutive ints of the output: CPB candidates of one block where a
// block's candidates hold more (1092 thread blocks at 64x64, 1170 at
// 32x32), else all candidates of NB blocks (4 at 8x8, 8 at 4x4). It loads
// the boundaries (the top row coalesced), downsamples them in parallel,
// computes the reduced predictions of its candidates in parallel, builds the
// horizontally upsampled reduced rows once per candidate (red_pred x w), and
// then forms each output as one vertical step between two such rows (or
// the top row), four consecutive columns per thread, written as one 16-byte
// store with the default caching: K3 satd67 reads the predictions next, and
// one class's (at most 26 MB) fit in the 50 MB L2.

#include "common.cuh"

namespace {

constexpr int NT = 256;                // threads per thread block
constexpr int TARGET = 4096;           // output ints per thread block

__host__ __device__ constexpr int ilog2c(int v) { return v <= 1 ? 0 : 1 + ilog2c(v >> 1); }

// the largest divisor of nc whose candidates of hw samples fit TARGET
__host__ __device__ constexpr int cand_per_tb(int nc, int hw) {
  int best = 1;
  for (int d = 1; d <= nc; ++d)
    if (nc % d == 0 && d * hw <= TARGET) best = d;
  return best;
}

template <int W, int H>
struct Mip {
  static constexpr int SIZE_ID = (W == 4 && H == 4) ? 0
                                 : (W == 4 || H == 4 || (W == 8 && H == 8)) ? 1 : 2;
  static constexpr int N_MODES = SIZE_ID == 0 ? 16 : SIZE_ID == 1 ? 8 : 6;
  static constexpr int NC = 2 * N_MODES;          // candidates per block
  static constexpr int RB = SIZE_ID == 0 ? 2 : 4; // red_bdry
  static constexpr int IN = 2 * RB;               // matrix row length
  static constexpr int RP = SIZE_ID < 2 ? 4 : 8;  // red_pred
  static constexpr int RP2 = RP * RP;
  static constexpr int UH = W / RP, UV = H / RP;  // upsampling factors
  static constexpr int LGH = ilog2c(UH), LGV = ilog2c(UV);
  static constexpr int FT = W / RB, FL = H / RB;  // downsampling factors
  static constexpr int HW = W * H;
  static constexpr bool SPLIT = HW * NC >= TARGET;  // a block's candidates split
  static constexpr int CPB = SPLIT ? cand_per_tb(NC, HW) : NC;
  static constexpr int NB = SPLIT ? 1 : TARGET / (HW * NC);
  static constexpr int TPB = NC / CPB;            // thread blocks per block
  static constexpr int U = NB * CPB;              // candidates per thread block
  static constexpr int ROWS = UH == 1 ? 4 : U * RP * W;   // upsampled rows
  static_assert(U * HW <= TARGET && HW % 4 == 0, "thread block geometry");
  static_assert((U * RP2 + ROWS + NB * (W + H + 2 * RB)) * 4 <= 48 * 1024,
                "static shared memory");
};

// the downsampled boundary sample k of ref (len = f * RB samples)
template <int F>
__device__ __forceinline__ int down(const int* ref, int k) {
  if constexpr (F == 1) {
    return ref[k];
  } else {
    constexpr int LG = ilog2c(F);
    int s = 0;
#pragma unroll
    for (int q = 0; q < F; ++q) s += ref[k * F + q];
    return (s + (1 << (LG - 1))) >> LG;
  }
}

template <int W, int H>
__global__ void __launch_bounds__(NT)
    mip_preds_kernel(const int* __restrict__ src, int Hp, int Wp,
                     const int* __restrict__ xs, const int* __restrict__ ys,
                     int B, const uint8_t* __restrict__ mat, int half,
                     int max_pix, int* __restrict__ preds) {
  using G = Mip<W, H>;
  __shared__ __align__(16) int top[G::NB][W];
  __shared__ int left[G::NB][H];
  __shared__ int dsv[G::NB][2][G::RB];   // [block][top, left][k]
  __shared__ __align__(16) int red[G::U * G::RP2];     // [u][ry][rx]
  __shared__ __align__(16) int rows[G::ROWS];          // [u][ry][X]
  const int tid = threadIdx.x;
  // the thread block's blocks b0 .. b0 + NB - 1, candidates c0 .. c0 + CPB - 1
  const int b0 = G::SPLIT ? blockIdx.x / G::TPB : blockIdx.x * G::NB;
  const int c0 = G::SPLIT ? (blockIdx.x % G::TPB) * G::CPB : 0;

  for (int i = tid; i < G::NB * (W + H); i += NT) {
    const int nb = i / (W + H), j = i % (W + H);
    const int b = b0 + nb;
    int v = 0;
    if (b < B) {
      const int x = xs[b], y = ys[b];
      v = j < W ? src[uvg::clampi(y - 1, 0, Hp - 1) * Wp + uvg::clampi(x + j, 0, Wp - 1)]
                : src[uvg::clampi(y + j - W, 0, Hp - 1) * Wp + uvg::clampi(x - 1, 0, Wp - 1)];
    }
    if (j < W) top[nb][j] = v;
    else left[nb][j - W] = v;
  }
  __syncthreads();
  for (int i = tid; i < G::NB * 2 * G::RB; i += NT) {
    const int nb = i / (2 * G::RB), s = (i / G::RB) & 1, k = i % G::RB;
    dsv[nb][s][k] = s == 0 ? down<G::FT>(top[nb], k) : down<G::FL>(left[nb], k);
  }
  __syncthreads();
  // reduced predictions: one thread per candidate and reduced sample
  for (int i = tid; i < G::U * G::RP2; i += NT) {
    const int u = i / G::RP2, pos = i % G::RP2;
    const int nb = u / G::CPB, c = c0 + u % G::CPB;
    const int t = c >= G::N_MODES ? 1 : 0, m = c - t * G::N_MODES;
    const int ry = pos / G::RP, rx = pos % G::RP;
    const int k = t ? rx * G::RP + ry : pos;          // the matrix row
    const uint8_t* row = mat + (m * G::RP2 + k) * G::IN;
    const int off = dsv[nb][t][0];
    int inp[G::IN];
#pragma unroll
    for (int q = 0; q < G::RB; ++q) {
      inp[q] = dsv[nb][t][q] - off;
      inp[G::RB + q] = dsv[nb][1 - t][q] - off;
    }
    inp[0] = G::SIZE_ID < 2 ? half - off : 0;
    int sum = 0, acc = 0;
#pragma unroll
    for (int q = 0; q < G::IN; ++q) {
      sum += inp[q];
      acc += static_cast<int>(__ldg(row + q)) * inp[q];
    }
    red[i] = uvg::clampi(((acc + 32 - 32 * sum) >> 6) + off, 0, max_pix);
  }
  __syncthreads();
  // horizontally upsampled reduced rows (the reduced rows themselves when
  // UH == 1)
  if constexpr (G::UH > 1) {
    for (int i = tid; i < G::U * G::RP * W; i += NT) {
      const int u = i / (G::RP * W), rr = (i / W) % G::RP, X = i % W;
      const int rx = X >> G::LGH, ph = (X & (G::UH - 1)) + 1;
      const int* r = red + u * G::RP2 + rr * G::RP;
      const int before = rx == 0 ? left[u / G::CPB][G::UV - 1 + rr * G::UV] : r[rx - 1];
      rows[i] = ((G::UH - ph) * before + ph * r[rx] + (1 << (G::LGH - 1))) >> G::LGH;
    }
    __syncthreads();
  }
  const int* hrows = G::UH > 1 ? rows : red;         // [u][RP][W]
  int* out = preds + (static_cast<long long>(b0) * G::NC + c0) * G::HW;
  // ints of the thread block's output that belong to real blocks
  const int valid = G::SPLIT ? G::U * G::HW : min(B - b0, G::NB) * G::NC * G::HW;
  for (int i = tid; i < G::U * G::HW / 4; i += NT) {
    const int e = i * 4;
    const int u = e / G::HW, Y = (e % G::HW) / W, X = e % W;
    const int* hr = hrows + u * G::RP * W;
    int4 v;
    if constexpr (G::UV == 1) {
      v = *reinterpret_cast<const int4*>(hr + Y * W + X);
    } else {
      const int ry = Y >> G::LGV, pv = (Y & (G::UV - 1)) + 1;
      const int4 cur = *reinterpret_cast<const int4*>(hr + ry * W + X);
      const int4 bef = ry == 0 ? *reinterpret_cast<const int4*>(&top[u / G::CPB][X])
                               : *reinterpret_cast<const int4*>(hr + (ry - 1) * W + X);
      constexpr int R = 1 << (G::LGV - 1);
      v.x = ((G::UV - pv) * bef.x + pv * cur.x + R) >> G::LGV;
      v.y = ((G::UV - pv) * bef.y + pv * cur.y + R) >> G::LGV;
      v.z = ((G::UV - pv) * bef.z + pv * cur.z + R) >> G::LGV;
      v.w = ((G::UV - pv) * bef.w + pv * cur.w + R) >> G::LGV;
    }
    if (e < valid) *reinterpret_cast<int4*>(out + e) = v;
  }
}

template <int W, int H>
int launch(const void* src, int Hp, int Wp, const void* xs, const void* ys,
           int B, int bitdepth, const void* mat, void* preds, cudaStream_t st) {
  using G = Mip<W, H>;
  const int grid = G::SPLIT ? B * G::TPB : (B + G::NB - 1) / G::NB;
  mip_preds_kernel<W, H><<<grid, NT, 0, st>>>(
      static_cast<const int*>(src), Hp, Wp, static_cast<const int*>(xs),
      static_cast<const int*>(ys), B, static_cast<const uint8_t*>(mat),
      1 << (bitdepth - 1), (1 << bitdepth) - 1, static_cast<int*>(preds));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mip_preds(const void* src, int H, int W, const void* xs,
                         const void* ys, int B, int w, int h, int bitdepth,
                         const void* mat, void* preds, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UVG_MIP(WW, HH)                                                          \
  if (w == WW && h == HH)                                                        \
    return launch<WW, HH>(src, H, W, xs, ys, B, bitdepth, mat, preds, st);
#define UVG_MIP_ROW(WW) UVG_MIP(WW, 4) UVG_MIP(WW, 8) UVG_MIP(WW, 16) UVG_MIP(WW, 32) UVG_MIP(WW, 64)
  UVG_MIP_ROW(4) UVG_MIP_ROW(8) UVG_MIP_ROW(16) UVG_MIP_ROW(32) UVG_MIP_ROW(64)
#undef UVG_MIP_ROW
#undef UVG_MIP
  return static_cast<int>(cudaErrorInvalidValue);
}

UVG_ERROR_ENTRY(mip_preds)
