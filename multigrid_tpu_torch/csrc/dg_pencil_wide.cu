// The float SIP-DG pencil kernels at n = 11..14 points an axis (p =
// 10..13): dg_apply<float> (K7, the smoother's residual) and
// dg_cheb<float> (K8, the smoother's Chebyshev step), dg_pencil.cuh's
// pencil body over its in-place layout (the note above wide_cells there
// says why, and what a pencil holds).  dg_apply_f32 and dg_cheb_f32
// (dg_pencil.cu) hand n = 11..17 here; n = 15..17 go on to
// dg_pencil_wide_top.cu.

#include "dg_pencil.cuh"

extern "C" {

// As dg_apply_f32, at n = 11..14 (n = 15..17: dg_wide_top_apply_f32):
// mode 0 apply (y = A x), 1 residual (out = b - A x; b unread in mode 0).  tab:
// host array of the kernels' table in float.
int dg_wide_apply_f32(int mode, const float* x, const float* b,
                      const float* tab, float* out, int C0, int C1, int C2,
                      int n, int colloc, void* stream, int* launched) {
  if (n >= kWideSplitN)  // dg_pencil_wide_top.cu
    return dg_wide_top_apply_f32(mode, x, b, tab, out, C0, C1, C2, n,
                                 colloc, stream, launched);
  *launched = 0;
  if (mode != APPLY && mode != RESIDUAL) return (int)cudaErrorInvalidValue;
  return wide_entry<float, kWideN, kWideSplitN - 1>(
      mode, x, b, nullptr, nullptr, tab, out, 0.0, 0.0, C0, C1, C2, n,
      colloc, stream, launched);
}

// As dg_cheb_f32, at n = 11..14: out = x + f1 (x - x_old) + f2 T3 diag^-1
// T3^T (b - A x); x and x_old may be null (zero); out may alias x_old,
// never x.
int dg_wide_cheb_f32(const float* b, const float* x, const float* x_old,
                     const float* inv_diag, const float* tab, float* out,
                     double f1, double f2, int C0, int C1, int C2, int n,
                     int colloc, void* stream, int* launched) {
  if (n >= kWideSplitN)  // dg_pencil_wide_top.cu
    return dg_wide_top_cheb_f32(b, x, x_old, inv_diag, tab, out, f1, f2, C0,
                                C1, C2, n, colloc, stream, launched);
  return wide_entry<float, kWideN, kWideSplitN - 1>(
      CHEB, x, b, x_old, inv_diag, tab, out, f1, f2, C0, C1, C2, n, colloc,
      stream, launched);
}

// The tile of the float kernel of mode (0 apply, 1 residual, 2 cheb) at
// n = 11..14: inplace_tile's fields (cells a pencil, dynamic shared bytes
// a block, threads a block, blocks an SM, registers and local bytes a
// thread).  Launches nothing.
int dg_wide_tile_f32(int mode, int n, int* out) {
  if (n >= kWideSplitN) return dg_wide_top_tile_f32(mode, n, out);
  return wide_tile<float, kWideN, kWideSplitN - 1>(mode, n, out);
}

}  // extern "C"
