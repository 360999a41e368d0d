// The SIP-DG kernels' constant table (type T, n = N points per axis), in
// the order ops/dg_kernel.py:dg_tables writes it.  Included by
// dg_pencil.cuh.
#pragma once

template <int N>
struct Tab {
  static constexpr int N2 = N * N;
  static constexpr int S = 0;            // S[a][m]: basis m at point a
  static constexpr int D = N2;           // collocation derivative
  static constexpr int DS = 2 * N2;      // D S
  static constexpr int TT = 3 * N2;      // SIP eigenbasis, columns
  static constexpr int F = 4 * N2;       // f0, f1: face values
  static constexpr int B = F + 2 * N;    // f0 S, f1 S: basis end values
  static constexpr int C = B + 2 * N;    // f0 D S, f1 D S: end derivatives
  static constexpr int W = C + 2 * N;    // quadrature weights
  static constexpr int GSYM = W + N;     // 9
  static constexpr int GVEC = GSYM + 9;  // 9, gvec[d][e]
  static constexpr int SIGMA = GVEC + 9; // 3
  static constexpr int JXW = SIGMA + 3;  // 3
  static constexpr int ST = JXW + 3;     // S T
  static constexpr int DST = ST + N2;    // D S T
  static constexpr int SIZE = DST + N2;
};
