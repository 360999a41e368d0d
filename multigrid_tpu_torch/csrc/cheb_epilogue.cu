// cheb_epilogue<T> for Hopper (sm_90a): the epilogue of an A x given as y,
// one elementwise pass over (x, x_old, b, y) giving
//   residual_only: r = b - y on interior nodes, b - x on Dirichlet nodes;
//   otherwise:     x + f1 (x - x_old) + f2 r / diag, diag rebuilt in the
//                  kernel from the separable 1-D lines (1 on Dirichlet).
// It is part of the TPU kernel
//   K2  multigrid_tpu/ops/pallas_windowed_sp.py (the Chebyshev epilogue):
// in float the V-cycle's Chebyshev step with x = 0, which needs no A x (the
// steps with an A x run fused in brick_kron.cuh).  The double instantiation
// served the f64 residual while that operator was a cell scatter; since
// the f64 operator runs brick_kron<double> with the residual fused, it is
// on no solver path and stays compiled and checked against its plain
// version.  A null x, x_old or y reads as zero.  Bound: bandwidth, 4-5
// streams of T per node; a grid-stride loop of 256-thread blocks.
//
// Every entry point writes the number of kernels it launched (1) to
// *launched, so a caller's launch count matches what a trace of the device
// shows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void cheb_epilogue_kernel(const T* __restrict__ b,
                                     const T* __restrict__ y,
                                     const T* __restrict__ x,
                                     const T* x_old,
                                     const T* __restrict__ lines,
                                     T* out, T f1, T f2, int Z, int Y, int X,
                                     int residual_only) {
  const int total = Z * Y * X;
  const int stride = Z + Y + X;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int gx = i % X;
    const int zy = i / X;
    const int gy = zy % Y;
    const int gz = zy / Y;
    const bool interior = gz > 0 && gz < Z - 1 && gy > 0 && gy < Y - 1 &&
                          gx > 0 && gx < X - 1;
    const T xv = x ? x[i] : T(0);
    const T r = b[i] - (interior ? (y ? y[i] : T(0)) : xv);
    if (residual_only) {
      out[i] = r;
      continue;
    }
    const T xo = x_old ? x_old[i] : T(0);
    T d = T(1);
    if (interior) {
      d = T(0);
      for (int e = 0; e < 3; ++e) {
        const T* l = lines + e * stride;
        d += l[gz] * l[Z + gy] * l[Z + Y + gx];
      }
    }
    // out may alias x_old: each element is read before it is written
    out[i] = xv + f1 * (xv - xo) + f2 * r / d;
  }
}

template <typename T>
int cheb_epilogue(const T* b, const T* y, const T* x, const T* x_old,
                  const T* lines, T* out, double f1, double f2, int Z, int Y,
                  int X, int residual_only, cudaStream_t stream,
                  int* launched) {
  const int threads = 256;
  const long long total = (long long)Z * Y * X;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  cheb_epilogue_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      b, y, x, x_old, lines, out, (T)f1, (T)f2, Z, Y, X, residual_only);
  *launched = 1;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cheb_epilogue_f64(const double* b, const double* y, const double* x,
                      const double* x_old, const double* lines, double* out,
                      double f1, double f2, int Z, int Y, int X,
                      int residual_only, void* stream, int* launched) {
  return cheb_epilogue<double>(b, y, x, x_old, lines, out, f1, f2, Z, Y, X,
                               residual_only, (cudaStream_t)stream, launched);
}

int cheb_epilogue_f32(const float* b, const float* y, const float* x,
                      const float* x_old, const float* lines, float* out,
                      double f1, double f2, int Z, int Y, int X,
                      int residual_only, void* stream, int* launched) {
  return cheb_epilogue<float>(b, y, x, x_old, lines, out, f1, f2, Z, Y, X,
                              residual_only, (cudaStream_t)stream, launched);
}

}  // extern "C"
