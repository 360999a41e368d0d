// brick_kron<double> at p = 10..16: the z-slab march of brick_kron.cuh
// (its note says what it computes, what bounds it and how), the outer FMG
// residual and CG vmult of poisson_cube at these degrees (K1), in a
// translation unit of its own so that it builds in parallel with the
// others; brick_kron_wide.cu's note says why the march runs here.
// brick_kron_f64 (brick_kron_f64.cu) hands these degrees here.

#include "brick_kron.cuh"

extern "C" {

// as brick_kron_f64, at p = 10..16 (form 0, the z-slab march, only)
int brick_kron_wide_f64(int mode, int form, const double* x, const double* b,
                        const double* x_old, double* out, const double* taps,
                        double f1, double f2, int Z, int Y, int X, int p,
                        void* stream, int* launched) {
  return brick_kron_range<double, kWideDegree, kWideTop>(
      mode, form, x, b, x_old, out, taps, f1, f2, Z, Y, X, p, stream,
      launched);
}

}  // extern "C"
