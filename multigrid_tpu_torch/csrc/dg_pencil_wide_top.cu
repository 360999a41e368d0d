// The float SIP-DG pencil kernels at n = 15..17 points an axis (p =
// 14..16), dg_pencil_wide.cu's at the top degrees, in a translation unit
// of their own so that each builds faster than brick_kron.cu.

#include "dg_pencil.cuh"

extern "C" {

// As dg_apply_f32, at n = 15..17: mode 0 apply (y = A x), 1 residual
// (out = b - A x; b unread in mode 0).  tab: host array of the kernels'
// table in float.
int dg_wide_top_apply_f32(int mode, const float* x, const float* b,
                          const float* tab, float* out, int C0, int C1,
                          int C2, int n, int colloc, void* stream,
                          int* launched) {
  *launched = 0;
  if (mode != APPLY && mode != RESIDUAL) return (int)cudaErrorInvalidValue;
  return wide_entry<float, kWideSplitN, kWideTopN>(
      mode, x, b, nullptr, nullptr, tab, out, 0.0, 0.0, C0, C1, C2, n,
      colloc, stream, launched);
}

// As dg_cheb_f32, at n = 15..17: out = x + f1 (x - x_old) + f2 T3 diag^-1
// T3^T (b - A x); x and x_old may be null (zero); out may alias x_old,
// never x.
int dg_wide_top_cheb_f32(const float* b, const float* x, const float* x_old,
                         const float* inv_diag, const float* tab, float* out,
                         double f1, double f2, int C0, int C1, int C2, int n,
                         int colloc, void* stream, int* launched) {
  return wide_entry<float, kWideSplitN, kWideTopN>(
      CHEB, x, b, x_old, inv_diag, tab, out, f1, f2, C0, C1, C2, n, colloc,
      stream, launched);
}

// The tile of the float kernel of mode (0 apply, 1 residual, 2 cheb) at
// n = 15..17: inplace_tile's fields (cells a pencil, dynamic shared bytes
// a block, threads a block, blocks an SM, registers and local bytes a
// thread).  Launches nothing.
int dg_wide_top_tile_f32(int mode, int n, int* out) {
  return wide_tile<float, kWideSplitN, kWideTopN>(mode, n, out);
}

}  // extern "C"
