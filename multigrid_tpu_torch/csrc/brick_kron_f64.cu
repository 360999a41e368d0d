// brick_kron<double>: the f64 brick operator of the outer FMG and CG (K1),
// the template of brick_kron.cuh in double (its note says what it
// computes, what bounds it and how).  A translation unit of its own, so
// that nvcc builds it in parallel with the float one.

#include "brick_kron.cuh"

extern "C" {

// mode: 0 apply, 1 vmult, 2 residual, 3 cheb; form: 0 the z-slab march,
// 1 the cell form (p >= 8).  taps: host array of
// 4 * p * (2p + 1) doubles (M, c_z L_z, c_y L_y, c_x L_x; each
// [p][2p + 1]).
int brick_kron_f64(int mode, int form, const double* x, const double* b,
                   const double* x_old, double* out, const double* taps,
                   double f1, double f2, int Z, int Y, int X, int p,
                   void* stream, int* launched) {
  return brick_kron_entry<double>(mode, form, x, b, x_old, out, taps, f1, f2,
                                  Z, Y, X, p, stream, launched);
}

}  // extern "C"
