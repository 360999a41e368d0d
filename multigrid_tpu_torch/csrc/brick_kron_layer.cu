// brick_kron<float> at p = 8, 9 in its third form, the layer march (the
// template brick_layer_kernel of brick_kron.cuh, whose note says what it
// computes, when it runs and why), in a translation unit of its own so
// that it builds beside brick_kron.cu.

#include "brick_kron.cuh"

extern "C" {

// mode: 0 apply, 1 vmult, 2 residual, 3 cheb; form: 2 (the layer march);
// p: 8 or 9.  The other arguments as brick_kron_f32's.
int brick_kron_layer_f32(int mode, int form, const float* x, const float* b,
                         const float* x_old, float* out, const float* taps,
                         double f1, double f2, int Z, int Y, int X, int p,
                         void* stream, int* launched) {
  return brick_layer_entry<float>(mode, form, x, b, x_old, out, taps, f1, f2,
                                  Z, Y, X, p, stream, launched);
}

// p (8 or 9), out[7]: the layer march's tile (cells in x, y, planes a
// group, threads, shared bytes, blocks an SM) and the z-slab march's
// shared bytes at p.  Launches nothing.
int brick_kron_layer_f32_tile(int p, int* out) {
  if (p == 8) return layer_tile<float, 8>(out);
  if (p == 9) return layer_tile<float, 9>(out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
