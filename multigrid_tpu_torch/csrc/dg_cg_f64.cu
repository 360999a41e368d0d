// The fused CG of solver_dg for Hopper (sm_90a), in double: the two passes
// of one iteration, with the scalars kept on the device.
//   dg_cg<double>         dg_cg_kernel<N>, the pencil template's cg mode
//                         (dg_pencil.cuh), then a one-block finish
//                         alpha = rz / (p . q);
//   dg_jacobi_cg<double>  dg_jacobi_cg_kernel<N>: per cell r -= alpha q and
//                         z = T3 diag^-1 T3^T r (the transformed Jacobi,
//                         ops/dg_precond.py), partials of r . z and r . r,
//                         then a one-block finish beta = rz_new / rz.
// They replace no Pallas kernel: the TPU row they port is XLA's fusion of
// the whole CG loop under one jit (multigrid_tpu's experiments/solver_dg.py
// make_cg), the counterpart of the reference's interleaved CG
// (solver_dg/program.cc:39-70, vmult_with_cg_update).  One iteration is
//   dg_cg:         x += alpha_prev p_old; p = z + beta p_old; q = A p;
//                  alpha = rz / (p . q)
//   dg_jacobi_cg:  r -= alpha q; z = P^-1 r; beta = (r . z) / rz;
//                  rz = r . z; rr = r . r
// so the x update of an iteration rides on the next operator pass (the
// JAX solvers/fused.py vmult_with_cg_update), and the host reads nothing
// inside the loop.  The first pass of dg_jacobi_cg (first = 1) reads no q,
// leaves r and sets beta = 0; with p_old = 0 the first dg_cg forms p = z.
// Device scalars scal[0..4]: alpha, beta, rz, rr, p . q (ops/dg_kernel.py
// CG_SCALARS).
// Reductions as in cg_vec.cu: each block writes one partial, one block sums
// them in an order fixed by the grid: no atomics, the same bits every run.
//
// What bounds them on an H100: dg_cg streams 6 vectors (x, p_old, z in;
// x, p, q out) beside the operator's ~200 flop a dof at p = 4, the Jacobi
// pass 5 (r, q, inv_diag in; r, z out) and 12 n + 6 flop a dof: both are
// bound by HBM bytes.  A simple design first: the operator pass is the
// apply kernel's, its loads and stores widened (the neighbour reductions
// form p from p_old and z too); the Jacobi pass takes whole cells, n^2
// threads a cell, its six 1-D sweeps through shared memory with the
// residual's line kept in registers for r . z.

#include "dg_pencil.cuh"

namespace {

enum Scalar { ALPHA = 0, BETA = 1, RZ = 2, RR = 3, PQ = 4 };

constexpr int kFinishThreads = 1024;

template <int N>
__global__ void __launch_bounds__(threads<N, CG>(), 1)
dg_cg_kernel(const __grid_constant__ TabArg<double, N> tab,
             const CgArgs<double> cg, double* __restrict__ q, int C0, int C1,
             int C2, int colloc) {
  pencil_body<double, N, CG>(tab.v, nullptr, q, nullptr, nullptr, nullptr,
                             0.0, 0.0, C0, C1, C2, colloc, cg);
}

// One block: the partials' sums in a fixed order, then the scalars.  cg:
// p . q from partial[0, nb); jacobi: r . z and r . r from partial[0, nb)
// and [nb, 2 nb)
__global__ void __launch_bounds__(kFinishThreads)
cg_finish_kernel(const double* __restrict__ partial, int nb,
                 double* __restrict__ scal, int jacobi, int first) {
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < nb; i += kFinishThreads) {
    a += partial[i];
    if (jacobi) b += partial[nb + i];
  }
  a = block_sum(a);
  __syncthreads();  // block_sum's warp sums are read before they are reused
  b = block_sum(b);
  if (threadIdx.x != 0) return;
  if (jacobi) {
    scal[BETA] = first ? 0.0 : a / scal[RZ];
    scal[RZ] = a;
    scal[RR] = b;
  } else {
    scal[PQ] = a;
    scal[ALPHA] = scal[RZ] / a;
  }
}

// cells a block of the Jacobi pass (n^2 threads a cell, about 256 a block)
template <int N>
__host__ __device__ constexpr int jacobi_cells() {
  return 256 / (N * N);
}

template <int N>
__host__ __device__ constexpr int jacobi_threads() {
  return ((jacobi_cells<N>() * N * N + 31) / 32) * 32;
}

// r -= alpha q (unless first); z = T3 diag^-1 T3^T r; the block's partials
// of r . z and r . r.  Lines along 2 (J0), 1, 0 (T^T, the scaling, T),
// 1, 2 (J4); a thread keeps its residual line of J0 for r . z in J4.
template <int N>
__global__ void __launch_bounds__(jacobi_threads<N>())
dg_jacobi_cg_kernel(const __grid_constant__ TabArg<double, N> tab,
                    double* __restrict__ r, const double* __restrict__ q,
                    double* __restrict__ z,
                    const double* __restrict__ inv_diag,
                    const double* __restrict__ scal,
                    double* __restrict__ partial, int64_t n_cells,
                    int first) {
  constexpr int N2 = N * N, N3 = N2 * N, K = jacobi_cells<N>();
  __shared__ double buf[2][K * N3];
  const double* TT = tab.v + Tab<N>::TT;  // the SIP eigenbasis, columns
  const int t = threadIdx.x;
  const bool lane = t < K * N2;
  const int c = lane ? t / N2 : 0, p = t % N2;
  const int64_t cell = (int64_t)blockIdx.x * K + c;
  const bool valid = lane && cell < n_cells;
  const int64_t cbase = (valid ? cell : 0) * N3;
  double* V0 = buf[0] + c * N3;
  double* V1 = buf[1] + c * N3;
  double rl[N], l[N], o[N];
  double rz = 0.0, rr = 0.0;

  // J0 (lines along 2): r -= alpha q; T^T along 2
  if (lane) {
    const double alpha = scal[ALPHA];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int64_t gi = cbase + p * N + m;
      double rv = valid ? r[gi] : 0.0;
      if (valid && !first) {
        rv -= alpha * q[gi];
        r[gi] = rv;
      }
      rl[m] = rv;
      rr += rv * rv;
    }
    mat<double, N>(TT, true, rl, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V0[p * N + m] = o[m];
  }
  __syncthreads();
  // J1 (lines along 1): T^T
  if (lane) {
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V0[node<N>(1, p, m)];
    mat<double, N>(TT, true, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V1[node<N>(1, p, m)] = o[m];
  }
  __syncthreads();
  // J2 (lines along 0): T^T, diag^-1, T
  if (lane) {
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V1[m * N2 + p];
    mat<double, N>(TT, true, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m)
      o[m] = valid ? o[m] * inv_diag[cbase + m * N2 + p] : 0.0;
    mat<double, N>(TT, false, o, l);
#pragma unroll
    for (int m = 0; m < N; ++m) V0[m * N2 + p] = l[m];
  }
  __syncthreads();
  // J3 (lines along 1): T
  if (lane) {
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V0[node<N>(1, p, m)];
    mat<double, N>(TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V1[node<N>(1, p, m)] = o[m];
  }
  __syncthreads();
  // J4 (lines along 2): T, the store of z, r . z
  if (valid) {
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V1[p * N + m];
    mat<double, N>(TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      z[cbase + p * N + m] = o[m];
      rz += rl[m] * o[m];
    }
  }
  rz = block_sum(rz);
  __syncthreads();
  rr = block_sum(rr);
  if (t == 0) {
    partial[blockIdx.x] = rz;
    partial[gridDim.x + blockIdx.x] = rr;
  }
}

template <int N>
int launch_cg(const double* tab, const CgArgs<double>& cg, double* scal,
              double* q, long long partial_len, int C0, int C1, int C2,
              int colloc, cudaStream_t st, int* launched) {
  static bool configured = false;
  unsigned blocks = 0;
  int err = pencil_grid<double, N, CG>(dg_cg_kernel<N>, configured, C0, C1,
                                       C2, blocks);
  if (err) return err;
  if ((long long)blocks > partial_len) return (int)cudaErrorInvalidValue;
  dg_cg_kernel<N><<<blocks, threads<N, CG>(), smem_bytes<double, N, CG>(),
                    st>>>(tab_arg<double, N>(tab), cg, q, C0, C1, C2, colloc);
  err = (int)cudaGetLastError();
  if (err) return err;
  *launched = 1;
  cg_finish_kernel<<<1, kFinishThreads, 0, st>>>(cg.partial, (int)blocks,
                                                 scal, 0, 0);
  err = (int)cudaGetLastError();
  if (err == 0) *launched = 2;
  return err;
}

template <int N>
int launch_jacobi(double* r, const double* q, double* z,
                  const double* inv_diag, double* scal, const double* tab,
                  double* partial, long long partial_len, long long n_cells,
                  int first, cudaStream_t st, int* launched) {
  constexpr int K = jacobi_cells<N>();
  const long long nb = (n_cells + K - 1) / K;
  if (nb >= (1LL << 30) || 2 * nb > partial_len)
    return (int)cudaErrorInvalidValue;
  dg_jacobi_cg_kernel<N><<<(unsigned)nb, jacobi_threads<N>(), 0, st>>>(
      tab_arg<double, N>(tab), r, q, z, inv_diag, scal, partial, n_cells,
      first);
  int err = (int)cudaGetLastError();
  if (err) return err;
  *launched = 1;
  cg_finish_kernel<<<1, kFinishThreads, 0, st>>>(partial, (int)nb, scal, 1,
                                                 first);
  err = (int)cudaGetLastError();
  if (err == 0) *launched = 2;
  return err;
}

}  // namespace

extern "C" {

// The operator pass of one fused CG iteration at n = 2..10 points an axis:
// x += scal[0] p_old; p = z + scal[1] p_old; q = A p; scal[4] = p . q,
// scal[0] = scal[2] / (p . q).  p and q must alias none of p_old, z, x.
// partial: partial_len doubles of scratch (one a pencil block).
// tab: host array of the kernels' table in double (ops/dg_kernel.py).
int dg_cg_f64(const double* p_old, const double* z, double* x, double* p,
              double* q, double* scal, const double* tab, double* partial,
              long long partial_len, int C0, int C1, int C2, int n,
              int colloc, void* stream, int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1) return (int)cudaErrorInvalidValue;
  CgArgs<double> cg;
  cg.p_old = p_old;
  cg.z = z;
  cg.x = x;
  cg.p = p;
  cg.scal = scal;
  cg.partial = partial;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
#define CG_CASE(NN)                                                          \
  case NN:                                                                   \
    return launch_cg<NN>(tab, cg, scal, q, partial_len, C0, C1, C2, colloc, \
                         st, launched);
    CG_CASE(2)
    CG_CASE(3)
    CG_CASE(4)
    CG_CASE(5)
    CG_CASE(6)
    CG_CASE(7)
    CG_CASE(8)
    CG_CASE(9)
    CG_CASE(10)
#undef CG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The preconditioner pass: r -= scal[0] q (first: q unread, r unchanged);
// z = T3 diag^-1 T3^T r on n_cells cells of n^3 values; scal[1] = (r . z)
// / scal[2] (first: 0), scal[2] = r . z, scal[3] = r . r.  partial:
// partial_len doubles of scratch (two a block).
int dg_jacobi_cg_f64(double* r, const double* q, double* z,
                     const double* inv_diag, double* scal, const double* tab,
                     double* partial, long long partial_len,
                     long long n_cells, int n, int first, void* stream,
                     int* launched) {
  *launched = 0;
  if (n_cells < 1 || (!first && q == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
#define JAC_CASE(NN)                                                      \
  case NN:                                                                \
    return launch_jacobi<NN>(r, q, z, inv_diag, scal, tab, partial,       \
                             partial_len, n_cells, first, st, launched);
    JAC_CASE(2)
    JAC_CASE(3)
    JAC_CASE(4)
    JAC_CASE(5)
    JAC_CASE(6)
    JAC_CASE(7)
    JAC_CASE(8)
    JAC_CASE(9)
    JAC_CASE(10)
#undef JAC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
