// The double SIP-DG pencil kernels (dg_pencil.cuh's note says what they
// compute, what bounds them and how): dg_apply<double> (K9, the outer
// CG's A p).  A translation unit of its own, so that nvcc builds it in
// parallel with the float one.

#include "dg_pencil.cuh"

extern "C" {

// mode: 0 apply (y = A x), 1 residual (out = b - A x; b unread in mode 0).
// tab: host array of the kernels' table in double (ops/dg_kernel.py).
int dg_apply_f64(int mode, const double* x, const double* b,
                 const double* tab, double* out, int C0, int C1, int C2,
                 int n, int colloc, void* stream, int* launched) {
  return dispatch_apply<double>(mode, x, b, tab, out, C0, C1, C2, n, colloc,
                                stream, launched);
}

}  // extern "C"
