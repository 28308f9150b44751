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
// uint32). The reference rounds the mean with jnp.round (half to even) of
// an exact float32 quotient; here the quotient and remainder of the integer
// sum decide, which is the same for every non-negative sum.
//
// Bound on this card: bytes, barely. Four 16-term multiply-add passes per
// sample (64 int32 operations) against 8 bytes moved per sample: 0.4 MB and
// 26 M operations at 832x480. Design: one thread block of 256 threads per
// tile, one thread per sample; the tile, the stages and the int8 DCT2
// matrix live in shared memory; the DC sum is a shared-memory integer
// atomic, exact in any order.

#include "common.cuh"

namespace {

constexpr int T = 16;

struct Params {
  int W, s1, s2, i1, i2, q_bits, scale, add, dscale, dq_shift, max_pix;
};

__global__ void pseudo_recon_kernel(const int* __restrict__ src,
                                    const int8_t* __restrict__ mat, Params p,
                                    int* __restrict__ out) {
  __shared__ int A[T * T];
  __shared__ int B[T * T];
  __shared__ int M[T * T];
  __shared__ int sum_s;
  const int tid = threadIdx.x;
  const int y = tid / T, x = tid % T;
  const long long row = static_cast<long long>(blockIdx.y * T + y) * p.W;
  const int col = blockIdx.x * T + x;
  if (tid == 0) sum_s = 0;
  M[tid] = mat[tid];
  const int pix = src[row + col];
  __syncthreads();
  atomicAdd(&sum_s, pix);
  __syncthreads();
  const int s = sum_s;
  int dc = s >> 8;                       // sum / 256, rounded half to even
  const int rem = s & 255;
  if (rem > 128 || (rem == 128 && (dc & 1))) dc += 1;
  A[tid] = pix - dc;
  __syncthreads();
  // tmp[y][k] = rsh(sum_x res[y][x] * M[k][x], s1)
  int acc = 0;
  for (int i = 0; i < T; ++i) acc += A[y * T + i] * M[x * T + i];
  B[tid] = (acc + (1 << (p.s1 - 1))) >> p.s1;
  __syncthreads();
  // coef[k2][k] = rsh(sum_y M[k2][y] * tmp[y][k], s2)
  acc = 0;
  for (int i = 0; i < T; ++i) acc += M[y * T + i] * B[i * T + x];
  const int coef = (acc + (1 << (p.s2 - 1))) >> p.s2;
  const int level = min(uvg::wrap_mul_add(abs(coef), p.scale, p.add) >> p.q_bits, 32767);
  const int q = ((coef > 0) - (coef < 0)) * level;
  A[tid] = uvg::clip16(uvg::wrap_mul_add(q, p.dscale, 1 << (p.dq_shift - 1)) >> p.dq_shift);
  __syncthreads();
  // u[y][k] = clip16(rsh(sum_k2 M[k2][y] * dq[k2][k], i1))
  acc = 0;
  for (int i = 0; i < T; ++i) acc += M[i * T + y] * A[i * T + x];
  B[tid] = uvg::clip16((acc + (1 << (p.i1 - 1))) >> p.i1);
  __syncthreads();
  // rr[y][x] = clip16(rsh(sum_k u[y][k] * M[k][x], i2))
  acc = 0;
  for (int i = 0; i < T; ++i) acc += B[y * T + i] * M[i * T + x];
  const int rr = uvg::clip16((acc + (1 << (p.i2 - 1))) >> p.i2);
  out[row + col] = uvg::clampi(rr + dc, 0, p.max_pix);
}

}  // namespace

extern "C" int pseudo_recon(const void* src, int H, int W, const void* mat,
                            int bitdepth, int q_bits, int scale, int add,
                            int dscale, int dq_shift, void* out, void* stream) {
  if (H % T || W % T) return static_cast<int>(cudaErrorInvalidValue);
  if (H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  // transforms.py fwd_shifts(16, 16, bd) / inv_shifts(bd)
  const Params p{W, 4 - 1 + bitdepth - 8, 4 - 1 + 7, 7, 20 - bitdepth,
                 q_bits, scale, add, dscale, dq_shift, (1 << bitdepth) - 1};
  const dim3 grid(W / T, H / T);
  pseudo_recon_kernel<<<grid, T * T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int8_t*>(mat), p,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

UVG_ERROR_ENTRY(pseudo_recon)
