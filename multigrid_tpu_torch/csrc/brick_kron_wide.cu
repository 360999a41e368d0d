// brick_kron<float> at p = 10..16: the z-slab march of brick_kron.cuh
// (its note says what it computes, what bounds it and how), the V-cycle
// operator of poisson_cube and of poisson_dg's FE_Q(p) hierarchy at these
// degrees (K2), in a translation unit of its own so that it builds in
// parallel with brick_kron.cu.  At p >= 10 the cell form's (2p + 1)^3
// neighbourhood outgrows a block's shared memory (190,440 B in double at
// p = 11, 234,484 B in float at p = 15) and the march's slab does not
// (under 36 KB at p = 16): a tile of one column a thread (one cell, or two
// in x at p = 10, 11), one block an SM, the planes of a cell layer one a
// trip (Tile::RHO_UNROLL), the same taps in the same order as at p <= 9.
// brick_kron_f32 (brick_kron.cu) hands these degrees here.

#include "brick_kron.cuh"

extern "C" {

// as brick_kron_f32, at p = 10..16 (form 0, the z-slab march, only)
int brick_kron_wide_f32(int mode, int form, const float* x, const float* b,
                        const float* x_old, float* out, const float* taps,
                        double f1, double f2, int Z, int Y, int X, int p,
                        void* stream, int* launched) {
  return brick_kron_range<float, kWideDegree, kWideTop>(
      mode, form, x, b, x_old, out, taps, f1, f2, Z, Y, X, p, stream,
      launched);
}

}  // extern "C"
