// K14 quant_levels / dequant_levels: the scalar quantiser and dequantiser
// of coefficient blocks, elementwise.
//
// Replaces: uvg266_tpu/ops/quant.py:153 make_quant_fn (entry quant_levels)
// and :174 make_dequant_fn (entry dequant_levels). The wrapper computes the
// scalars from qp_scaled, the block shape and the bit depth as the
// reference does; per element, in int32 that wraps as the reference's
// (done in uint32):
//   quant    level = (|c| * scale + add) >> q_bits   (|INT32_MIN| wraps to
//                                                     itself, as in XLA)
//            q     = clip16(sign(c) * level)
//   dequant  c     = clip16((q * scale + add) >> shift)
// The input is int16 or int32 (elem_bytes 2 or 4: the int16 coefficients of
// K13 are read in place), the output int32.
//
// Bound on this card: bytes (an input element read and an int32 written
// against about six integer operations). Design: eight elements a thread,
// 128 threads a thread block (an 832x480 class's 49920 threads spread
// evenly over the 132 SMs, three thread blocks each), the loads before the
// stores, int4 stores and loads as wide as the
// input's alignment allows (int4 when it is 16-byte aligned, as a fresh
// tensor is); a grid sized to the elements; the sign and |c| as selects,
// no branch. A scalar head (until the output is 16-byte aligned) and tail
// (the last n mod 8 elements) in the same launch take any contiguous
// tensor, views at an offset included.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;      // 390 thread blocks at 832x480's classes: three an SM
constexpr int VEC = 8;

template <bool QUANT>
__device__ __forceinline__ int level_of(int c, int scale, int add, int shift) {
  if constexpr (QUANT) {
    const unsigned s = static_cast<unsigned>(c >> 31);          // ~0 if c < 0
    const unsigned a = (static_cast<unsigned>(c) ^ s) - s;       // |c|, wrapped
    const int level = static_cast<int>(a * static_cast<unsigned>(scale) +
                                       static_cast<unsigned>(add)) >> shift;
    const int q = static_cast<int>((static_cast<unsigned>(level) ^ s) - s);
    return uvg::clip16(c == 0 ? 0 : q);
  } else {
    return uvg::clip16(uvg::wrap_mul_add(c, scale, add) >> shift);
  }
}

__device__ __forceinline__ void unpack2(unsigned u, int& a, int& b) {
  a = static_cast<int>(static_cast<int16_t>(u & 0xffffu));
  b = static_cast<int>(u) >> 16;
}

// v[0..8) = p[0..8), p aligned to `align` bytes (a uniform choice)
__device__ __forceinline__ void load8(const int* p, int align, int (&v)[VEC]) {
  if (align >= 16) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else if (align >= 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int2 a = __ldg(reinterpret_cast<const int2*>(p) + i);
      v[2 * i] = a.x, v[2 * i + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ void load8(const int16_t* p, int align, int (&v)[VEC]) {
  if (align >= 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(a.x, v[0], v[1]), unpack2(a.y, v[2], v[3]);
    unpack2(a.z, v[4], v[5]), unpack2(a.w, v[6], v[7]);
  } else if (align >= 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p) + i);
      unpack2(a.x, v[4 * i], v[4 * i + 1]), unpack2(a.y, v[4 * i + 2], v[4 * i + 3]);
    }
  } else if (align >= 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      unpack2(__ldg(reinterpret_cast<const unsigned*>(p) + i), v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

// thread t: elements head + 8t .. head + 8t + 7 (t < nvec), element t of
// the head (t < head) and of the tail (t < n - head - 8 nvec); I, the
// index type, is int where n allows it
template <typename T, bool QUANT, typename I>
__global__ void __launch_bounds__(THREADS)
    levels_kernel(const T* __restrict__ in, I n, int head, I nvec, int align,
                  int scale, int add, int shift, int* __restrict__ out) {
  const I t = static_cast<I>(blockIdx.x) * THREADS + static_cast<I>(threadIdx.x);
  if (t < nvec) {
    const I e = head + VEC * t;
    int v[VEC];
    load8(in + e, align, v);
    int4* o = reinterpret_cast<int4*>(out + e);
    o[0] = make_int4(level_of<QUANT>(v[0], scale, add, shift),
                     level_of<QUANT>(v[1], scale, add, shift),
                     level_of<QUANT>(v[2], scale, add, shift),
                     level_of<QUANT>(v[3], scale, add, shift));
    o[1] = make_int4(level_of<QUANT>(v[4], scale, add, shift),
                     level_of<QUANT>(v[5], scale, add, shift),
                     level_of<QUANT>(v[6], scale, add, shift),
                     level_of<QUANT>(v[7], scale, add, shift));
  }
  const I tail = head + VEC * nvec;
  if (t < head) out[t] = level_of<QUANT>(static_cast<int>(in[t]), scale, add, shift);
  if (t < n - tail)
    out[tail + t] = level_of<QUANT>(static_cast<int>(in[tail + t]), scale, add, shift);
}

template <typename T, bool QUANT, typename I>
void launch_typed(const void* in, long long n, int head, int align, int scale,
                  int add, int shift, void* out, cudaStream_t st) {
  const long long nvec = (n - head) / VEC;
  const long long threads = std::max<long long>(nvec, VEC);
  levels_kernel<T, QUANT, I><<<static_cast<int>((threads + THREADS - 1) / THREADS),
                               THREADS, 0, st>>>(
      static_cast<const T*>(in), static_cast<I>(n), head, static_cast<I>(nvec),
      align, scale, add, shift, static_cast<int*>(out));
}

template <bool QUANT>
int launch_levels(const void* in, long long n, int elem_bytes, int scale,
                  int add, int shift, void* out, cudaStream_t st) {
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (n < 0 || shift < 0 || shift > 31 || (elem_bytes != 2 && elem_bytes != 4) ||
      o % 4 || reinterpret_cast<uintptr_t>(in) % elem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  // the head aligns the output to 16 bytes; the input's alignment there
  // picks the width of its loads
  const int head = static_cast<int>(std::min<long long>(n, ((16 - o % 16) % 16) / 4));
  const uintptr_t a = reinterpret_cast<uintptr_t>(in) + head * elem_bytes;
  const int align = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
  const bool narrow = n < (1LL << 31) - THREADS * VEC;
  if (elem_bytes == 2 && narrow)
    launch_typed<int16_t, QUANT, int>(in, n, head, align, scale, add, shift, out, st);
  else if (elem_bytes == 2)
    launch_typed<int16_t, QUANT, long long>(in, n, head, align, scale, add, shift, out, st);
  else if (narrow)
    launch_typed<int, QUANT, int>(in, n, head, align, scale, add, shift, out, st);
  else
    launch_typed<int, QUANT, long long>(in, n, head, align, scale, add, shift, out, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coef: n int16 (elem_bytes 2) or int32 (4) elements; out: n int32
extern "C" int quant_levels(const void* coef, long long n, int elem_bytes,
                            int scale, int add, int q_bits, void* out,
                            void* stream) {
  return launch_levels<true>(coef, n, elem_bytes, scale, add, q_bits, out,
                             static_cast<cudaStream_t>(stream));
}

// q: n int16 (elem_bytes 2) or int32 (4) elements; out: n int32
extern "C" int dequant_levels(const void* q, long long n, int elem_bytes,
                              int scale, int add, int shift, void* out,
                              void* stream) {
  return launch_levels<false>(q, n, elem_bytes, scale, add, shift, out,
                              static_cast<cudaStream_t>(stream));
}

UVG_ERROR_ENTRY(quant_levels)
UVG_ERROR_ENTRY(dequant_levels)
