// The double SIP-DG pencil kernels at n = 11..14 points an axis (p =
// 10..13): dg_apply<double> (K9, the outer CG's A p), dg_pencil.cuh's
// pencil body over its in-place layout (the note above wide_cells there
// says why, and what a pencil holds), in a translation unit of its own so
// that nvcc builds it in parallel with the float one.  dg_apply_f64
// (dg_pencil_f64.cu) hands n = 11..17 here; n = 15..17 go on to
// dg_pencil_wide_top_f64.cu.

#include "dg_pencil.cuh"

extern "C" {

// As dg_apply_f64, at n = 11..14 (n = 15..17: dg_wide_top_apply_f64):
// mode 0 apply (y = A x), 1 residual (out = b - A x; b unread in mode 0).  tab:
// host array of the kernels' table in double.
int dg_wide_apply_f64(int mode, const double* x, const double* b,
                      const double* tab, double* out, int C0, int C1, int C2,
                      int n, int colloc, void* stream, int* launched) {
  if (n >= kWideSplitN)  // dg_pencil_wide_top_f64.cu
    return dg_wide_top_apply_f64(mode, x, b, tab, out, C0, C1, C2, n,
                                 colloc, stream, launched);
  *launched = 0;
  if (mode != APPLY && mode != RESIDUAL) return (int)cudaErrorInvalidValue;
  return wide_entry<double, kWideN, kWideSplitN - 1>(
      mode, x, b, nullptr, nullptr, tab, out, 0.0, 0.0, C0, C1, C2, n,
      colloc, stream, launched);
}

// The tile of the double kernel of mode (0 apply, 1 residual) at
// n = 11..14: inplace_tile's fields (cells a pencil, dynamic shared bytes
// a block, threads a block, blocks an SM, registers and local bytes a
// thread).  Launches nothing.
int dg_wide_tile_f64(int mode, int n, int* out) {
  if (n >= kWideSplitN) return dg_wide_top_tile_f64(mode, n, out);
  return wide_tile<double, kWideN, kWideSplitN - 1>(mode, n, out);
}

}  // extern "C"
