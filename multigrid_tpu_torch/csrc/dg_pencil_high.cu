// The SIP-DG pencil kernels at n = 9, 10 points an axis (p = 8, 9) for
// Hopper (sm_90a): dg_pencil.cuh's pencil body over its in-place layout
// (InPlace), so that a cell holds 4 n^3 + 22 n^2 values in shared memory
// instead of 7 n^3 + 34 n^2, and two blocks share an SM in double too.
// Three modes:
//   apply     y = A x            dg_high_apply_kernel<9, false> (double)
//   residual  out = b - A x      dg_high_apply_kernel<9, true> (double)
//   cheb      out = x + f1 (x - x_old) + f2 T3 diag^-1 T3^T (b - A x)
//                                dg_high_cheb_kernel<N>, n = 9, 10 (float)
// They replace, at these degrees, the TPU kernels of
// multigrid_tpu/ops/pallas_dg.py that dg_pencil.cuh's template replaces
// below them: K9 PallasDGOzaki._kernel (:639, dg_apply<double>; JAX runs
// XLA there above p = 4) at p = 8 and K8 PallasDGSP.cheb_fused (:490,
// dg_cheb<float>) at p = 8, 9; K7 (:438, dg_apply<float>) and K9 at p = 9
// keep the template's layout, which no variant of this one beat there
// without spilling (PERF.md §6).  dg_pencil.cuh's note says what A
// is and where the phases live (every value's expression is there, once);
// its entries (dg_apply_f64, dg_cheb_f32) call these.
//
// Why a layout of their own: at n = 9, 10 the template's 7 n^3 + 34 n^2
// values a cell let a block of 3 / 2 cells fill an SM in double (188,568 /
// 166,400 bytes): one block of 8 / 7 warps, whose barriers nothing else on
// the SM covers.
//
// Design.
//   * The pencils are the template's (K = pencil<N, MODE>() cells along x,
//     n^2 threads a cell, a pencil a block) and so are the phases: the
//     outputs are the template's bits.
//   * Each phase turns its lines in place (a thread reads and writes only
//     its own lines within a phase): 4 volume buffers a cell where the
//     template keeps 7.  The face stages and the fluxes run in place in
//     three buffers a face (the neighbour's P, Q; then S P, D S P, S Q;
//     then u+, gn+; then the fluxes t_val, t_gr): 22 n^2 face values a cell
//     (with the x traces) where the template keeps 34.  A block of 3 cells
//     at n = 9 takes 56,376 bytes in float, 112,752 in double (two blocks
//     an SM in both types); 2 cells at n = 10, 49,600 in float.
//   * The launch bound names those two blocks, which caps the registers
//     at 128 a thread; the layout's lean order (dg_pencil.cuh's note: the
//     volume term formed again in T4, arrays stored as soon as they are
//     made, a face column at a time, acc_0 and acc_1 swept before vacc)
//     keeps them there.
// What bounds them on an H100: as the template (its note): about 300 flop
// a dof for A x and 400 for the step at p = 8, 9 against 2 (apply), 3
// (residual) or 5 (cheb) streams of T; in float the 67 TFLOP/s rate
// binds, in double the HBM (the 67 TFLOP/s fp64 peak is the tensor
// cores'; DFMAs peak at half of it).  What the design works on is the
// warps an SM and the barriers they wait at.
// An entry reads the table (ops/dg_kernel.py:dg_tables, in T) from host
// memory, writes the number of kernels it launched (1) to *launched and
// returns cudaGetLastError(); each kernel's launches are also counted
// here (dg_high_launches), so that a caller can tell which body ran.

#include <stdint.h>

#include "dg_pencil.cuh"

namespace {

template <typename T, int N, int MODE>
using HighLayout = InPlace<T, N, pencil<N, MODE>()>;

template <typename T, int N, int MODE>
__host__ __device__ constexpr int high_smem_bytes() {
  return HighLayout<T, N, MODE>::SIZE * (int)sizeof(T);
}

// blocks an SM the launch bound names (ptxas then caps the registers at
// 128 a thread): 2, which the shared memory holds in both types (233,472
// bytes an SM, 1 KB reserved a block); 1 and 3 were slower (PERF.md §6,
// PR 21)
constexpr int kHighBlocks = 2;

// launches by kernel, in dg_high_tile's order: cheb, apply, residual
int g_launches[3] = {0, 0, 0};

template <int N, bool RESID>
__global__ void __launch_bounds__(threads<N, APPLY>(), kHighBlocks)
dg_high_apply_kernel(const __grid_constant__ TabArg<double, N> tab,
                     const double* __restrict__ x, double* __restrict__ out,
                     const double* __restrict__ b, int C0, int C1, int C2,
                     int colloc) {
  pencil_body<double, N, RESID ? RESIDUAL : APPLY,
              HighLayout<double, N, APPLY>>(tab.v, x, out, b, nullptr,
                                            nullptr, 0.0, 0.0, C0, C1, C2,
                                            colloc);
}

template <int N>
__global__ void __launch_bounds__(threads<N, CHEB>(), kHighBlocks)
dg_high_cheb_kernel(const __grid_constant__ TabArg<float, N> tab,
                    const float* __restrict__ x, float* out,
                    const float* __restrict__ bvec, const float* x_old,
                    const float* __restrict__ inv_diag, float f1, float f2,
                    int C0, int C1, int C2, int colloc) {
  pencil_body<float, N, CHEB, HighLayout<float, N, CHEB>>(
      tab.v, x, out, bvec, x_old, inv_diag, f1, f2, C0, C1, C2, colloc);
}

// ---- launches

template <int N, bool RESID>
int launch_high_apply(const double* x, const double* b, const double* tab,
                      double* out, int C0, int C1, int C2, int colloc,
                      cudaStream_t stream) {
  static bool configured = false;
  constexpr int bytes = high_smem_bytes<double, N, APPLY>();
  unsigned blocks = 0;
  const int err = inplace_grid(dg_high_apply_kernel<N, RESID>, configured,
                               bytes, C0, C1, C2, pencil<N, APPLY>(), blocks);
  if (err) return err;
  dg_high_apply_kernel<N, RESID>
      <<<blocks, threads<N, APPLY>(), bytes, stream>>>(
          tab_arg<double, N>(tab), x, out, b, C0, C1, C2, colloc);
  const int launch_err = (int)cudaGetLastError();
  if (launch_err == 0) ++g_launches[RESID ? 2 : 1];
  return launch_err;
}

template <int N>
int launch_high_cheb(const float* x, const float* tab, float* out,
                     const float* b, const float* x_old,
                     const float* inv_diag, double f1, double f2, int C0,
                     int C1, int C2, int colloc, cudaStream_t stream) {
  static bool configured = false;
  constexpr int bytes = high_smem_bytes<float, N, CHEB>();
  unsigned blocks = 0;
  const int err = inplace_grid(dg_high_cheb_kernel<N>, configured, bytes,
                               C0, C1, C2, pencil<N, CHEB>(), blocks);
  if (err) return err;
  dg_high_cheb_kernel<N>
      <<<blocks, threads<N, CHEB>(), bytes, stream>>>(
          tab_arg<float, N>(tab), x, out, b, x_old, inv_diag, (float)f1,
          (float)f2, C0, C1, C2, colloc);
  const int launch_err = (int)cudaGetLastError();
  if (launch_err == 0) ++g_launches[0];
  return launch_err;
}

int high_apply(int mode, const double* x, const double* b, const double* tab,
               double* out, int C0, int C1, int C2, int n, int colloc,
               void* stream, int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1 || (mode != APPLY && mode != RESIDUAL))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool r = mode == RESIDUAL;
  int err;
  if (n == 9)
    err = r ? launch_high_apply<9, true>(x, b, tab, out, C0, C1, C2, colloc,
                                         st)
            : launch_high_apply<9, false>(x, b, tab, out, C0, C1, C2, colloc,
                                          st);
  else
    return (int)cudaErrorInvalidValue;
  if (err == 0) *launched = 1;
  return err;
}

// The tile of one kernel (inplace_tile)
template <typename T, int N, int MODE, typename Kernel>
int high_tile(Kernel kernel, int* out) {
  return inplace_tile(kernel, pencil<N, MODE>(), high_smem_bytes<T, N, MODE>(),
                      threads<N, MODE>(), out);
}

template <int N>
int tile_of(int kernel, int* out) {
  if (kernel == 0) return high_tile<float, N, CHEB>(dg_high_cheb_kernel<N>, out);
  if constexpr (N == 9) {
    if (kernel == 1)
      return high_tile<double, N, APPLY>(dg_high_apply_kernel<N, false>, out);
    if (kernel == 2)
      return high_tile<double, N, APPLY>(dg_high_apply_kernel<N, true>, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// As dg_apply_f64 (dg_pencil_f64.cu), at n = 9 points an axis: mode 0
// apply (y = A x), 1 residual (out = b - A x; b unread in mode 0).  tab:
// host array of the kernels' table in double.
int dg_high_apply_f64(int mode, const double* x, const double* b,
                      const double* tab, double* out, int C0, int C1, int C2,
                      int n, int colloc, void* stream, int* launched) {
  return high_apply(mode, x, b, tab, out, C0, C1, C2, n, colloc, stream,
                    launched);
}

// As dg_cheb_f32 (dg_pencil.cu), at n = 9, 10: out = x + f1 (x - x_old) +
// f2 T3 diag^-1 T3^T (b - A x); x and x_old may be null (zero); out may
// alias x_old, never x.
int dg_high_cheb_f32(const float* b, const float* x, const float* x_old,
                     const float* inv_diag, const float* tab, float* out,
                     double f1, double f2, int C0, int C1, int C2, int n,
                     int colloc, void* stream, int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (n == 9)
    err = launch_high_cheb<9>(x, tab, out, b, x_old, inv_diag, f1, f2, C0,
                              C1, C2, colloc, st);
  else if (n == 10)
    err = launch_high_cheb<10>(x, tab, out, b, x_old, inv_diag, f1, f2, C0,
                               C1, C2, colloc, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err == 0) *launched = 1;
  return err;
}

// The tile at n = 9, 10 points an axis, for reports; kernel: 0 cheb
// (float; n = 9, 10), 1 apply, 2 residual (double; n = 9).  out[0..5] =
// cells a pencil, dynamic shared bytes a block, threads a block, blocks an
// SM (the occupancy calculator), registers a thread, local bytes a thread
// (spills).
// Launches nothing.
int dg_high_tile(int kernel, int n, int* out) {
  if (n == 9) return tile_of<9>(kernel, out);
  if (n == 10) return tile_of<10>(kernel, out);
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = the launches of these kernels since the library was loaded,
// in dg_high_tile's order (cheb, apply, residual; every n together).
// Launches nothing.
int dg_high_launches(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_launches[i];
  return 0;
}

}  // extern "C"
