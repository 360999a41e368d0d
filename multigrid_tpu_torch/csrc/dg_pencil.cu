// The float SIP-DG pencil kernels (dg_pencil.cuh's note says what they
// compute, what bounds them and how): dg_apply<float> (K7, the smoother's
// residual and the Lanczos set-up) and dg_cheb<float> (K8, the smoother's
// Chebyshev step).

#include "dg_pencil.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(threads<N, CHEB>())
dg_cheb_kernel(const __grid_constant__ TabArg<float, N> tab,
               const float* __restrict__ x, float* out,
               const float* __restrict__ bvec, const float* x_old,
               const float* __restrict__ inv_diag, float f1, float f2, int C0,
               int C1, int C2, int colloc) {
  pencil_body<float, N, CHEB>(tab.v, x, out, bvec, x_old, inv_diag, f1, f2,
                              C0, C1, C2, colloc);
}

template <int N>
int launch_cheb(const float* x, const float* tab, float* out, const float* b,
                const float* x_old, const float* inv_diag, double f1,
                double f2, int C0, int C1, int C2, int colloc,
                cudaStream_t stream) {
  static bool configured = false;
  unsigned blocks = 0;
  const int err = pencil_grid<float, N, CHEB>(dg_cheb_kernel<N>, configured,
                                              C0, C1, C2, blocks);
  if (err) return err;
  dg_cheb_kernel<N>
      <<<blocks, threads<N, CHEB>(), smem_bytes<float, N, CHEB>(),
         stream>>>(tab_arg<float, N>(tab), x, out, b, x_old, inv_diag,
                   (float)f1, (float)f2, C0, C1, C2, colloc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 apply (y = A x), 1 residual (out = b - A x; b unread in mode 0).
// tab: host array of the kernels' table in float (ops/dg_kernel.py).
int dg_apply_f32(int mode, const float* x, const float* b, const float* tab,
                 float* out, int C0, int C1, int C2, int n, int colloc,
                 void* stream, int* launched) {
  return dispatch_apply<float>(mode, x, b, tab, out, C0, C1, C2, n, colloc,
                               stream, launched);
}

// out = x + f1 (x - x_old) + f2 T3 diag^-1 T3^T (b - A x); x and x_old may
// be null (zero); out may alias x_old, never x.
int dg_cheb_f32(const float* b, const float* x, const float* x_old,
                const float* inv_diag, const float* tab, float* out,
                double f1, double f2, int C0, int C1, int C2, int n,
                int colloc, void* stream, int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (n) {
#define CHEB_CASE(NN)                                                       \
  case NN:                                                                  \
    err = launch_cheb<NN>(x, tab, out, b, x_old, inv_diag, f1, f2, C0, C1, \
                          C2, colloc, st);                                  \
    break;
    CHEB_CASE(2)
    CHEB_CASE(3)
    CHEB_CASE(4)
    CHEB_CASE(5)
    CHEB_CASE(6)
    CHEB_CASE(7)
    CHEB_CASE(8)
#undef CHEB_CASE
    case 9:
    case 10:  // dg_pencil_high.cu
      return dg_high_cheb_f32(b, x, x_old, inv_diag, tab, out, f1, f2, C0,
                              C1, C2, n, colloc, stream, launched);
    default:  // n = 11..17: dg_pencil_wide.cu
      return dg_wide_cheb_f32(b, x, x_old, inv_diag, tab, out, f1, f2, C0,
                              C1, C2, n, colloc, stream, launched);
  }
  if (err == 0) *launched = 1;
  return err;
}

}  // extern "C"
