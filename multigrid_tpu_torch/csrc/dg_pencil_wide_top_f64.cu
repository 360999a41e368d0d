// The double SIP-DG pencil kernels at n = 15..17 points an axis (p =
// 14..16), dg_pencil_wide_f64.cu's at the top degrees, in a translation
// unit of their own so that each builds faster than brick_kron.cu.

#include "dg_pencil.cuh"

extern "C" {

// As dg_apply_f64, at n = 15..17: mode 0 apply (y = A x), 1 residual
// (out = b - A x; b unread in mode 0).  tab: host array of the kernels'
// table in double.
int dg_wide_top_apply_f64(int mode, const double* x, const double* b,
                          const double* tab, double* out, int C0, int C1,
                          int C2, int n, int colloc, void* stream,
                          int* launched) {
  *launched = 0;
  if (mode != APPLY && mode != RESIDUAL) return (int)cudaErrorInvalidValue;
  return wide_entry<double, kWideSplitN, kWideTopN>(
      mode, x, b, nullptr, nullptr, tab, out, 0.0, 0.0, C0, C1, C2, n,
      colloc, stream, launched);
}

// The tile of the double kernel of mode (0 apply, 1 residual) at
// n = 15..17: inplace_tile's fields (cells a pencil, dynamic shared bytes
// a block, threads a block, blocks an SM, registers and local bytes a
// thread).  Launches nothing.
int dg_wide_top_tile_f64(int mode, int n, int* out) {
  return wide_tile<double, kWideSplitN, kWideTopN>(mode, n, out);
}

}  // extern "C"
