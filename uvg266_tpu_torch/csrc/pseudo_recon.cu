// K5 pseudo_recon: quantisation round trip of a luma plane on a 16x16 grid.
//
// Replaces: uvg266_tpu/ops/pseudo_recon.py:80 make_pseudo_recon_fn (twin of
// the host pseudo_recon_plane). Per 16x16 tile of src [H, W] (H, W
// multiples of 16):
//   dc   = round_half_even(sum(tile) / 256)       (exact, in integers)
//   res  = tile - dc
//   tmp  = (res @ M^T + (1 << (s1-1))) >> s1      M: the 16x16 DCT2
//   coef = (M @ tmp + (1 << (s2-1))) >> s2
//   q    = sign(coef) * min((|coef| * scale + add) >> q_bits, 32767)
//   dq   = clip16((q * dscale + (1 << (dq_shift-1))) >> dq_shift)
//   u    = clip16((M^T @ dq + (1 << (i1-1))) >> i1)
//   rr   = clip16((u @ M + (1 << (i2-1))) >> i2)
//   out  = clip(rr + dc, 0, max)
// in the reference's int32 arithmetic (no int16 wrap between the forward
// stages, unlike K4; quant and dequant products wrap as int32, done in
// uint32; the quant rounding add is always the intra slice's 171, from the
// caller). The reference rounds the mean with jnp.round (half to even) of
// an exact float32 quotient; here the quotient and remainder of the integer
// sum decide, which is the same for every non-negative sum.
//
// Bound on this card: bytes, 8 per sample (3.2 MB at 832x480, 16.7 MB at
// 1920x1088); next, int32 multiply-adds (64 a clock an SM, half the float32
// rate): the four 16-point passes take 4 * 88 / 16 = 22 a sample as full
// partial butterflies. Design: one thread per line of a tile, 16 threads a
// tile, four tiles a thread block of 64 threads. A thread loads its row with
// four 16-byte loads, the 16 threads of a tile sum the tile with warp
// shuffles (the DC; no shared atomic), and the row pass runs on the
// registers. Each pass is butterfly.cuh's partial butterfly in its 16-point
// line form (fwd_line16 / inv_line16: every output of the line, the even
// half split twice more, 88 multiply-adds, the coefficients read four at a
// time by all threads at one address, the rounding offset on the first
// multiply-add), and writes its line transposed into shared memory, so the
// next pass reads a row again (four 16-byte loads, a row stride of 20 ints
// and a tile stride of 336: no bank conflict). The column pass keeps its
// coefficients and runs the quantiser, the dequantiser and the inverse
// column pass in registers; the inverse row pass adds the DC, and lanes y
// and y ^ 1 store their two rows 32 contiguous bytes an instruction
// (shuffles swap the halves). Three barriers. A last thread block with
// fewer tiles idles its spare threads (1560 tiles at 832x480 are 390
// blocks; 45 at 144x80 leave one tile in the last). The butterflies sum in
// another order than the 16-term products, exactly: every partial sum
// stays inside int32 (10-bit checkerboard: the forward passes below 2^26,
// the inverse ones below 2^27).

#include "butterfly.cuh"
#include "common.cuh"

namespace {

constexpr int T = 16;
constexpr int TPB = 4;                 // tiles a thread block
constexpr int THREADS = TPB * T;       // a thread per line
constexpr int LSW = 20;                // shared row stride (16-byte rows)
constexpr int TSW = T * LSW + 16;      // shared tile stride

struct Params {
  int W, tiles_x, n_tiles, s1, s2, i1, i2, q_bits, scale, add, dscale,
      dq_shift, max_pix;
};

__device__ __forceinline__ void load_row(const int* p, int (&v)[T]) {
#pragma unroll
  for (int c = 0; c < T; c += 4) {
    const int4 q = *reinterpret_cast<const int4*>(p + c);
    v[c] = q.x;
    v[c + 1] = q.y;
    v[c + 2] = q.z;
    v[c + 3] = q.w;
  }
}

__global__ void __launch_bounds__(THREADS)
    pseudo_recon_kernel(const int* __restrict__ src,
                        const int8_t* __restrict__ mat, Params p,
                        int* __restrict__ out) {
  __shared__ __align__(16) int S1[TPB * TSW];
  __shared__ __align__(16) int S2[TPB * TSW];
  __shared__ __align__(16) int cf[uvg::LINE16_N];
  const int tid = threadIdx.x;
  const int t = tid / T, y = tid % T;       // the tile, the thread's line
  const int tile = blockIdx.x * TPB + t;
  const bool active = tile < p.n_tiles;
  uvg::load_line16(mat, cf, tid, THREADS);
  int* s1 = S1 + t * TSW;
  int* s2 = S2 + t * TSW;
  int v[T], o[T];
  int dc = 0;
  const int par = y & 1;
  long long g0 = 0;                         // the lane pair's even row
  if (active) {
    const int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
    g0 = static_cast<long long>(ty * T + y - par) * p.W + tx * T;
    load_row(src + g0 + par * p.W, v);
  } else {
#pragma unroll
    for (int x = 0; x < T; ++x) v[x] = 0;
  }
  int s = 0;
#pragma unroll
  for (int x = 0; x < T; ++x) s += v[x];
  // the tile's 16 lines are 16 neighbouring lanes of one warp
#pragma unroll
  for (int m = T / 2; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  dc = s >> 8;                         // sum / 256, rounded half to even
  const int rem = s & 255;
  if (rem > 128 || (rem == 128 && (dc & 1))) dc += 1;
#pragma unroll
  for (int x = 0; x < T; ++x) v[x] -= dc;
  __syncthreads();                     // the coefficients
  if (active) {
    // tmp[y][k] = rsh(sum_x res[y][x] * M[k][x], s1): the row, no int16
    // wrap; stored transposed (row k holds column k)
    uvg::fwd_line16(v, cf, 1 << (p.s1 - 1), o);
#pragma unroll
    for (int k = 0; k < T; ++k) s1[k * LSW + y] = o[k] >> p.s1;
  }
  __syncthreads();
  if (active) {
    // column k = y: coef[k2][k] = rsh(sum_y M[k2][y] * tmp[y][k], s2);
    // quant, dequant; u[yy][k] = clip16(rsh(sum_k2 M[k2][yy] * dq[k2][k],
    // i1)), stored back in rows
    load_row(s1 + y * LSW, v);
    uvg::fwd_line16(v, cf, 1 << (p.s2 - 1), o);
#pragma unroll
    for (int k2 = 0; k2 < T; ++k2) {
      const int coef = o[k2] >> p.s2;
      const int level = min(uvg::wrap_mul_add(abs(coef), p.scale, p.add) >> p.q_bits, 32767);
      const int q = ((coef > 0) - (coef < 0)) * level;
      v[k2] = uvg::clip16(uvg::wrap_mul_add(q, p.dscale, 1 << (p.dq_shift - 1)) >> p.dq_shift);
    }
    uvg::inv_line16(v, cf, 1 << (p.i1 - 1), o);
#pragma unroll
    for (int yy = 0; yy < T; ++yy) s2[yy * LSW + y] = uvg::clip16(o[yy] >> p.i1);
  }
  __syncthreads();
  {
    // rr[y][x] = clip16(rsh(sum_k u[y][k] * M[k][x], i2)); + dc, clip (on
    // every lane, for the shuffles; an idle tile stores nothing)
    load_row(s2 + y * LSW, v);
    uvg::inv_line16(v, cf, 1 << (p.i2 - 1), o);
#pragma unroll
    for (int x = 0; x < T; ++x) o[x] = uvg::clampi(uvg::clip16(o[x] >> p.i2) + dc, 0, p.max_pix);
    // lanes y and y ^ 1 store 32 contiguous bytes of one of their two rows
    // an instruction: store k writes row (y & ~1) + (k & 1), columns
    // 8 * (k >> 1) + 4 * par .. + 3; the row's owner keeps its four and
    // hands its partner the other four
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int h = 8 * (k >> 1), rsel = k & 1;
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int send = par ? o[h + j] : o[h + 4 + j];
        const int recv = __shfl_xor_sync(0xffffffffu, send, 1);
        q[j] = par == rsel ? (par ? o[h + 4 + j] : o[h + j]) : recv;
      }
      if (active)
        *reinterpret_cast<int4*>(out + g0 + rsel * p.W + h + 4 * par) =
            make_int4(q[0], q[1], q[2], q[3]);
    }
  }
}

}  // namespace

// src, out [H, W] int32 on the card, 16-byte aligned; mat the 16x16 DCT2
// int8
extern "C" int pseudo_recon(const void* src, int H, int W, const void* mat,
                            int bitdepth, int q_bits, int scale, int add,
                            int dscale, int dq_shift, void* out, void* stream) {
  if (H % T || W % T) return static_cast<int>(cudaErrorInvalidValue);
  if (H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(src) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = W / T, n_tiles = tiles_x * (H / T);
  // transforms.py fwd_shifts(16, 16, bd) / inv_shifts(bd)
  const Params p{W, tiles_x, n_tiles, 4 - 1 + bitdepth - 8, 4 - 1 + 7, 7,
                 20 - bitdepth, q_bits, scale, add, dscale, dq_shift,
                 (1 << bitdepth) - 1};
  pseudo_recon_kernel<<<(n_tiles + TPB - 1) / TPB, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int8_t*>(mat), p,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(pseudo_recon)
