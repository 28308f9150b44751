// VVC's DCT-II matrices as compile-time constants, for kernels that take
// their coefficients as immediates (K13, transform.cu). Plain C++17 as well
// as CUDA: tests/test_torch_transform_design.py compiles it with g++ and
// holds every entry to ops/tr_matrices.py.
#pragma once

#ifdef __CUDACC__
#define UVG_HD __host__ __device__
#else
#define UVG_HD
#endif

namespace uvg {

// VVC's DCT-II: the odd-frequency amplitudes of each size (DCT2_ODD of
// ops/tr_matrices.py), size n's n/2 values at offset n/2 - 1
UVG_HD constexpr int dct2_odd(int n, int i) {
  constexpr int t[63] = {
      64,                                                     // 2
      83, 36,                                                 // 4
      89, 75, 50, 18,                                         // 8
      90, 87, 80, 70, 57, 43, 25, 9,                          // 16
      90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,  // 32
      91, 90, 90, 90, 88, 87, 86, 84, 83, 81, 79, 77, 73, 71, 69, 65,  // 64
      62, 59, 56, 52, 48, 44, 41, 37, 33, 28, 24, 20, 15, 11, 7, 2};
  return t[n / 2 - 1 + i];
}

// M[k][j] of the n-point DCT-II (tr_matrices.py dct2_matrix): the amplitude
// of cos((2j+1) k pi / 2n) by exact index reduction
UVG_HD constexpr int dct2_coef(int n, int k, int j) {
  if (n == 1) return 64;
  int a = ((2 * j + 1) * k) % (4 * n);
  if (a > 2 * n) a = 4 * n - a;
  int sign = 1;
  if (a > n) {
    sign = -1;
    a = 2 * n - a;
  }
  if (a == 0) return sign * 64;
  int m = n;
  while (!(a & 1)) {
    a >>= 1;
    m >>= 1;
  }
  return sign * dct2_odd(m, (a - 1) >> 1);
}

}  // namespace uvg
