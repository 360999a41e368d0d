// Brick operator kernels for Hopper (sm_90a): the f64 y = A x on the FE_Q(p)
// node grid, and the Chebyshev / residual epilogue that follows an A x.
//
// brick_apply<double> replaces the TPU kernel
//   K1  multigrid_tpu/ops/pallas_windowed.py    PallasWindowedOzaki._kernel
//       (dp A x on f32 hi/lo pairs, Ozaki bf16 limbs).
// The H100 has native fp64, so there are no limbs and no pairs, and the
// node grid [Z, Y, X] (contiguous, x fastest) replaces the TPU x-window.
// The f32 operator of the V-cycle (K2) is brick_kron.cu: one node-centric
// pass with its epilogue fused.
//
// What A is: for the affine brick with a constant coefficient the element
// matrix is K = sum_d c_d (A_z (x) A_y (x) A_x), A_e = L (1-D stiffness) on
// axis d and M (1-D mass) otherwise -- exactly laplace_dense.element_matrix.
// It is applied by sum factorization: M_x and L_x on x, three y sweeps,
// two z sweeps, about 9 kflop per p = 4 cell against 31 kflop for the
// dense 125 x 125 product.
//
// Design: one thread block per cell, one thread per cell node; the cell's
// values and the two 1-D tables sit in shared memory.  Nodes shared by
// neighbouring cells are summed without atomics: eight launches, one per
// cell parity class (cz, cy, cx mod 2).  Cells of one class share no node,
// so each launch adds into the zeroed output with a plain +=, and the
// result is the same from run to run.  Dirichlet nodes read as zero and
// are never written (the wrapper zeroes the output).
//
// What bounds it: at p = 4 and one cell per block, the per-cell gather of
// 125 scattered values and the read-modify-write of 125 outputs, plus four
// block barriers per cell; the flops are small for the card.  The
// node-centric form of brick_kron.cu, with f64 taps and the residual
// epilogue fused, is the later design for this kernel too.
//
// Every entry point writes the number of kernels it launched to *launched
// (brick_apply: one per non-empty parity class, at most 8; cheb_epilogue: 1),
// so a caller's launch count matches what a trace of the device shows.
//
// cheb_epilogue<T> is the epilogue of an A x given as y: one elementwise
// pass over (x, x_old, b, y) giving
//   residual_only: r = b - y on interior nodes, b - x on Dirichlet nodes;
//   otherwise:     x + f1 (x - x_old) + f2 r / diag, diag rebuilt in the
//                  kernel from the separable 1-D lines (1 on Dirichlet).
// It serves the f64 residual after brick_apply<double> (whose cell scatter
// completes a node only after all eight of its cells), and in f32 the
// Chebyshev step with x = 0, which needs no A x.  A null x, x_old or y
// reads as zero.  Bound: bandwidth, 4-5 streams of T per node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8;  // nodes per cell edge: degree <= 7

template <typename T>
__global__ void brick_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   const T* __restrict__ lm, T c0, T c1, T c2,
                                   int Z, int Y, int X, int n, int pz, int py,
                                   int px, int ncx, int ncy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sL = reinterpret_cast<T*>(smem_raw);
  T* sM = sL + n * n;
  const int n3 = n * n * n;
  T* su = sM + n * n;
  T* s1 = su + n3;
  T* s2 = s1 + n3;

  const int t = threadIdx.x;
  for (int i = t; i < 2 * n * n; i += blockDim.x) sL[i] = lm[i];

  int b = blockIdx.x;
  const int cxi = 2 * (b % ncx) + px;
  b /= ncx;
  const int cyi = 2 * (b % ncy) + py;
  const int czi = 2 * (b / ncy) + pz;

  const int p = n - 1;
  const bool active = t < n3;
  const int k = t % n, j = (t / n) % n, i = t / (n * n);
  const int gz = czi * p + i, gy = cyi * p + j, gx = cxi * p + k;
  const bool interior = active && gz > 0 && gz < Z - 1 && gy > 0 &&
                        gy < Y - 1 && gx > 0 && gx < X - 1;
  const int64_t idx = ((int64_t)gz * Y + gy) * X + gx;
  if (active) su[t] = interior ? x[idx] : T(0);
  __syncthreads();

  // x sweeps: t1 = M_x u, t2 = L_x u
  if (active) {
    T a1 = 0, a2 = 0;
    const T* row = su + (i * n + j) * n;
    for (int m = 0; m < n; ++m) {
      const T v = row[m];
      a1 += sM[k * n + m] * v;
      a2 += sL[k * n + m] * v;
    }
    s1[t] = a1;
    s2[t] = a2;
  }
  __syncthreads();

  // y sweeps: M_y t1 (z term), L_y t1 (y term), M_y t2 (x term)
  T b1 = 0, b2 = 0, b3 = 0;
  if (active) {
    for (int m = 0; m < n; ++m) {
      const T v1 = s1[(i * n + m) * n + k];
      const T v2 = s2[(i * n + m) * n + k];
      const T mj = sM[j * n + m];
      b1 += mj * v1;
      b2 += sL[j * n + m] * v1;
      b3 += mj * v2;
    }
  }
  __syncthreads();
  if (active) {
    su[t] = c0 * b1;            // gets L_z
    s1[t] = c1 * b2 + c2 * b3;  // gets M_z
  }
  __syncthreads();

  // z sweeps and the scatter-add (one parity class: no other block
  // touches these nodes during this launch)
  if (interior) {
    T r = 0;
    for (int m = 0; m < n; ++m) {
      const int o = (m * n + j) * n + k;
      r += sL[i * n + m] * su[o] + sM[i * n + m] * s1[o];
    }
    y[idx] += r;
  }
}

template <typename T>
int brick_apply(const T* x, T* y, const T* lm, double c0, double c1,
                double c2, int Z, int Y, int X, int n, cudaStream_t stream,
                int* launched) {
  *launched = 0;
  if (n < 2 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int p = n - 1;
  const int cz = (Z - 1) / p, cy = (Y - 1) / p, cx = (X - 1) / p;
  const int threads = ((n * n * n + 31) / 32) * 32;
  const size_t smem = (size_t)(2 * n * n + 3 * n * n * n) * sizeof(T);
  for (int pz = 0; pz < 2; ++pz)
    for (int py = 0; py < 2; ++py)
      for (int px = 0; px < 2; ++px) {
        const int ncz = (cz - pz + 1) / 2, ncy = (cy - py + 1) / 2,
                  ncx = (cx - px + 1) / 2;
        if (ncz <= 0 || ncy <= 0 || ncx <= 0) continue;
        brick_apply_kernel<T><<<ncz * ncy * ncx, threads, smem, stream>>>(
            x, y, lm, (T)c0, (T)c1, (T)c2, Z, Y, X, n, pz, py, px, ncx, ncy);
        ++*launched;
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
      }
  return (int)cudaGetLastError();
}

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

int brick_apply_f64(const double* x, double* y, const double* lm, double c0,
                    double c1, double c2, int Z, int Y, int X, int n,
                    void* stream, int* launched) {
  return brick_apply<double>(x, y, lm, c0, c1, c2, Z, Y, X, n,
                             (cudaStream_t)stream, launched);
}

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
