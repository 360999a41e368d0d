// The SIP-DG pencil kernels for Hopper (sm_90a): the operator's phases,
// written once as device functions templated on the value type T, the
// points per axis N, the mode and a shared-memory layout, and one pencil
// body over them with three thin entries:
//   apply     y = A x            dg_apply_kernel<T, N, false>
//   residual  out = b - A x      dg_apply_kernel<T, N, true>
//   cheb      out = x + f1 (x - x_old) + f2 T3 diag^-1 T3^T (b - A x)
//                                dg_cheb_kernel<N> (float only)
// They replace the TPU kernels (multigrid_tpu/ops/pallas_dg.py)
//   K9  PallasDGOzaki._kernel  f64 A x on f32 hi/lo pairs and bf16 limbs
//       (p <= 4): dg_apply<double>, dg_pencil_f64.cu;
//   K7  PallasDGSP._kernel     f32 A x on 3 x 8-bit limbs: dg_apply<float>,
//       dg_pencil.cu;
//   K8  PallasDGSP.cheb_fused -> _kernel_cheb, the f32 Chebyshev step with
//       the transformed Jacobi: dg_cheb<float>, dg_pencil.cu.
// Every kernel that applies A calls the phase functions below: this body
// (dg_pencil.cu, dg_pencil_f64.cu; at p = 8, 9 also dg_pencil_high.cu,
// the same body over the in-place layout) and solver_dg's fused CG pass
// (dg_cg_f64.cu: a block marches a column of pencils along z, loads each
// value once and keeps the next layer's loads in flight; its own are the
// march, its T0 and the store of q).  A layout says where each phase reads
// and writes in shared memory and when a value is formed; the expression
// of every value is in one place, here.
// The H100 runs fp64 natively: no limbs, no pairs, no degree cap, and the
// vectors keep the natural block layout [C0, C1, C2, n, n, n] (x fastest)
// instead of the TPU's [cz + 1, N, F] lane layout.
//
// What A is (the JAX DGLaplace.apply, multigrid_tpu/ops/dg.py:312-367): for
// a constant affine Jacobian, per cell with n = p + 1 collocation points
//   v = S u (skipped for the Gauss kind, S = I); g_e = D_e v;
//   acc_e = w3 sum_f Gsym[e][f] g_f  (volume term);
//   for each of the 6 faces (d, s): own traces u- = f_s .d v and
//   gn = gvec_d . (f_s .d g); the neighbour's traces u+, gn+ from its own
//   cell (or the Dirichlet mirror u+ = -u-, gn+ = gn- at the boundary);
//   jump = u- - u+; t_val = sigma_d jump - (gn- + gn+)/2 lifted into v's
//   slot (vacc) and t_gr = -jump/2 lifted into acc_e with gvec_d[e];
//   y = S3^T (vacc + sum_e D_e^T acc_e).
// The face terms follow ops/dg_face.py, the CPU mirror of these kernels:
// each face inside a block is evaluated once and lifted into both cells.
//
// Design.  A block takes a pencil of K cells along x (K n^3 contiguous
// values; the last pencil of a row may be ragged), n^2 threads a cell.  In
// each phase a thread owns one line of n nodes of its cell in registers,
// along axis 0 (i, stride n^2), 1 (j) or 2 (k), and every 1-D contraction
// runs along the owned line in registers; between phases the lines turn
// through shared memory (one barrier), so each contraction reads each
// value once.  The tables (read on the host, from the table argument) are
// a __grid_constant__ kernel parameter, so they enter the FMAs as constant
// operands with no load and no copy before the launch.  Faces:
//   * +-z, +-y, and x at the pencil's two ends: the neighbour's block is
//     reduced along the normal (b = f S, c = f D S) and swept over the face
//     (two stages, one face row or column a thread), or the Dirichlet
//     mirror where the face is on the domain boundary (never at a pencil
//     end inside it);
//   * x faces between two cells of the pencil: one thread per face point
//     forms the jump u- - u+ from both cells' own traces (before any
//     scaling: f32 cancels some 1e5-fold on smooth iterates), then one
//     flux_val / flux_grad pair, lifted with + into the lower cell and with
//     -/+ into the upper one.
// Phases (line axis), separated by block barriers:
//   T0 (0) load x; S_0 x, DS_0 x; neighbour reductions
//   T1 (1) S_1, DS_1; face stage 1     T2 (2) v, g_0..2, the volume term,
//   the x traces; face stage 2
//   T3 fluxes: +-z (lines along 0), +-y (along 1), x (face points)
//   T4 (2) lifts, then the back end along 2    T5 (1) along 1
//   T6 (0) along 0 and, for apply and residual, the store.
// The back end per axis e is S^T on the two other axes and (D S)^T on e:
//   apply / residual: y = S3^T (vacc + sum_e D_e^T acc_e) with the tables
//     S and D S; T6 writes y, or b - y (b read on the same lines); 6
//     barriers;
//   cheb: T3^T A x = (S T)3^T (vacc + sum_e D_e^T acc_e) with the tables
//     S T and D S T, so the step forms T3^T b - T3^T A x and never forms
//     A x in node space: T4 and T5 also sweep b with T^T, T6 scales by
//     inv_diag and applies T_0, T7 (1) T_1, T8 (2) T_2 and the update; 8
//     barriers with x, 4 with x = 0 (the first step, A x skipped).
// Layouts (shared memory a cell):
//   TwoSets<.., 7>  the template's: 7 n^3 volume and 34 n^2 face values, in
//     two sets (even and odd phases), so that a buffer read in one phase is
//     written again only after the next barrier; the volume term held in
//     registers from T2 to T4;
//   TwoSets<.., 4>  dg_cg's: each phase turns its volume lines in place (4
//     n^3), the faces in two sets;
//   InPlace         dg_pencil_high.cu's: 4 n^3 + 22 n^2, lines and faces
//     turned in place, and a lean order (at most a few lines in
//     registers, for two blocks an SM at 128 registers): the volume term
//     formed again in T4 from the gradients in shared memory, T2 storing
//     each array as soon as it is made, face stage 2 loading a column at a
//     time, T3 retiring its lines before the fluxes, T4 sweeping acc_0 and
//     acc_1 before vacc.  The sums are the same in either order, and the
//     volume term's product by w3 meets the lifts' add in another phase in
//     the template's order and is kept unfused (mul_rn) in the lean one,
//     so every layout gives the same bits.
//
// What bounds it on an H100: about 200 flop a dof for A at p = 4
// (utils/perf_model.dg_matvec_ops) against 2 (apply), 3 (residual) or 5
// (cheb) streams of T of necessary traffic, plus the +-y/+-z neighbour
// blocks (mostly L2 hits).  In float the bound is the HBM for every mode
// but apply (the 67 TFLOP/s fp32 rate binds it, barely); in double every
// mode is bound by bytes at the card's 67 TFLOP/s fp64 peak, which only
// its tensor cores reach: these kernels compute with DFMAs, which peak at
// half that, so in double apply sits nearer its reachable time than its
// bound says.  The design's concern is the shared-memory pipe (each
// contraction reads its line once), issue slots and barriers, and, in
// double, the shared memory a block (7 n^3 + 34 n^2 values a cell), which
// sets the blocks an SM: 3 blocks of 4 warps at p = 4 (pencil()).
//
// Degrees 1 to 16 (n = 2..17), one instantiation each; the three kinds via
// the tables (S = I for the Gauss kind, whose flag skips the S products).
// The float step at p = 8, 9 (n = 9, 10) and the double apply and residual
// at p = 8 run dg_pencil_high.cu, these pencils (pencil() below: 3 and 2
// cells, the lengths a sweep of this body chose) over the in-place layout
// with two blocks an SM; the float apply and residual at p = 8, 9 and the
// double ones at p = 9 run the template's layout (PERF.md §6: no
// variant of the other was faster there without spilling).  Every mode
// at p = 10..16 runs the wide pencils (dg_wide_kernel below, built in
// dg_pencil_wide*.cu), the same body over the in-place layout.  At n = 9,
// 10 the double table (573 / 694 values) passes 4 KB; at n = 17 it takes
// 15,016 B, within the 32,764 B of kernel parameters (tab_arg).
// An entry reads the table (ops/dg_kernel.py:dg_tables, in T) from host
// memory, writes the number of kernels it launched (1) to *launched and
// returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_tab.cuh"

// the double apply and residual at n = 9 and the float step at n = 9, 10
// (dg_pencil_high.cu); every mode at n = 11..17 (dg_pencil_wide.cu,
// dg_pencil_wide_f64.cu)
extern "C" {
int dg_high_apply_f64(int mode, const double* x, const double* b,
                      const double* tab, double* out, int C0, int C1, int C2,
                      int n, int colloc, void* stream, int* launched);
int dg_high_cheb_f32(const float* b, const float* x, const float* x_old,
                     const float* inv_diag, const float* tab, float* out,
                     double f1, double f2, int C0, int C1, int C2, int n,
                     int colloc, void* stream, int* launched);
int dg_wide_apply_f32(int mode, const float* x, const float* b,
                      const float* tab, float* out, int C0, int C1, int C2,
                      int n, int colloc, void* stream, int* launched);
int dg_wide_apply_f64(int mode, const double* x, const double* b,
                      const double* tab, double* out, int C0, int C1, int C2,
                      int n, int colloc, void* stream, int* launched);
int dg_wide_cheb_f32(const float* b, const float* x, const float* x_old,
                     const float* inv_diag, const float* tab, float* out,
                     double f1, double f2, int C0, int C1, int C2, int n,
                     int colloc, void* stream, int* launched);
// n = 15..17, which the entries above hand on (dg_pencil_wide_top.cu,
// dg_pencil_wide_top_f64.cu)
int dg_wide_top_apply_f32(int mode, const float* x, const float* b,
                          const float* tab, float* out, int C0, int C1,
                          int C2, int n, int colloc, void* stream,
                          int* launched);
int dg_wide_top_apply_f64(int mode, const double* x, const double* b,
                          const double* tab, double* out, int C0, int C1,
                          int C2, int n, int colloc, void* stream,
                          int* launched);
int dg_wide_top_cheb_f32(const float* b, const float* x, const float* x_old,
                         const float* inv_diag, const float* tab, float* out,
                         double f1, double f2, int C0, int C1, int C2, int n,
                         int colloc, void* stream, int* launched);
int dg_wide_top_tile_f32(int mode, int n, int* out);
int dg_wide_top_tile_f64(int mode, int n, int* out);
}

namespace {

enum Mode { APPLY = 0, RESIDUAL = 1, CHEB = 2 };

template <typename T, int N>
struct TabArg {
  T v[Tab<N>::SIZE];
};

// cells per block (pencil length along x), by degree and mode, the same
// in both value types: measured at p = 4 (n = 5), the path's degree, over
// 2-12 cells (PERF.md §6): 8 for the step, 5 for apply and residual (one
// block of 4 warps); at n = 9, 10 (also dg_pencil_high.cu's) the
// lengths this body won with there (over every pencil that fit
// a block, at p = 8, 9 on 24^3 cells, PR 12 in PERF.md): 3 and 2 in every
// mode and type, kept so that each x face takes the same path.
// DG_PENCIL (apply and residual) and DG_CHEB_PENCIL (cheb) set it for
// every degree of a translation unit when tuning
// (experiments/time_dg_cheb.py --pencil)
template <int N, int MODE>
__host__ __device__ constexpr int pencil() {
#ifdef DG_CHEB_PENCIL
  if (MODE == CHEB) return DG_CHEB_PENCIL;
#endif
#ifdef DG_PENCIL
  if (MODE != CHEB) return DG_PENCIL;
#endif
  if (MODE != CHEB && N == 5) return 5;
  return N == 2 ? 16 : N == 3 ? 14 : N == 4 ? 8 : N == 5 ? 8
         : N <= 8 ? 4 : N == 9 ? 3 : 2;
}

template <int N, int MODE>
__host__ __device__ constexpr int threads() {
  return ((pencil<N, MODE>() * N * N + 31) / 32) * 32;
}

// values a pencil of k cells of n points an axis holds in shared memory
// with vols volume buffers and the face buffers in two sets (TwoSets)
__host__ __device__ constexpr int two_sets_size(int n, int k, int vols) {
  return k * (vols * n * n * n + 34 * n * n);
}

// ---- shared-memory layouts (see the note above); each gives the volume
// buffer a of pencil cell c, and for face f of cell c the buffers the
// neighbour's values arrive in (nb: P, Q, then u+, gn+), those face stage
// 1 and the fluxes write (st: S P, D S P, S Q, then t_val, t_gr) and the x
// traces (xt: u-, gn- at side s).  T1, T5 and T7: the first volume buffer
// those phases write; CB: the step's T3^T b after T5.  LEAN: the lean
// order of dg_pencil_high.cu.
template <typename T, int N, int K, int VOLS>
struct TwoSets {
  static_assert(VOLS == 7 || VOLS == 4, "7 volume buffers, or 4 in place");
  static constexpr bool LEAN = false;
  static constexpr int CELLS = K;
  static constexpr int N2 = N * N, N3 = N2 * N;
  static constexpr int FE = VOLS * K * N3, FO = FE + 16 * K * N2;
  static constexpr int SIZE = two_sets_size(N, K, VOLS);
  static constexpr int T1 = VOLS == 7 ? 4 : 0, T5 = T1, T7 = T1;
  static constexpr int CB = VOLS == 7 ? 6 : 3;
  T* sm;
  __device__ T* vol(int a, int c) const { return sm + (a * K + c) * N3; }
  __device__ T* nb(int a, int c, int f) const {
    return sm + FE + ((a * K + c) * 6 + f) * N2;
  }
  __device__ T* xt(int a, int c, int s) const {
    return sm + FE + 12 * K * N2 + ((a * K + c) * 2 + s) * N2;
  }
  __device__ T* st(int a, int c, int f) const {
    return sm + FO + ((a * K + c) * 6 + f) * N2;
  }
};

// four volume buffers [4][K][n^3]; the face buffers [K][6 faces][3][n^2],
// each stage written over what it read; the x traces [2][K][2][n^2]
template <typename T, int N, int K>
struct InPlace {
  static constexpr bool LEAN = true;
  static constexpr int CELLS = K;
  static constexpr int N2 = N * N, N3 = N2 * N;
  static constexpr int FS = 4 * K * N3, XT = FS + 18 * K * N2;
  static constexpr int SIZE = XT + 4 * K * N2;
  static constexpr int T1 = 0, T5 = 0, T7 = 0, CB = 3;
  T* sm;
  __device__ T* vol(int a, int c) const { return sm + (a * K + c) * N3; }
  __device__ T* st(int a, int c, int f) const {
    return sm + FS + ((c * 6 + f) * 3 + a) * N2;
  }
  __device__ T* nb(int a, int c, int f) const { return st(a, c, f); }
  __device__ T* xt(int a, int c, int s) const {
    return sm + XT + ((a * K + c) * 2 + s) * N2;
  }
};

template <typename T, int N, int MODE>
using TemplateLayout = TwoSets<T, N, pencil<N, MODE>(), 7>;

// bytes of shared memory a block may have
constexpr int kBlockSmemMax = 232448;

template <typename T, int N, int MODE>
constexpr size_t smem_bytes() {
  return (size_t)TemplateLayout<T, N, MODE>::SIZE * sizeof(T);
}

// node m of the line along axis o through face point p = (q1, q2) of the
// other two axes (in order)
template <int N>
__device__ __forceinline__ int node(int o, int p, int m) {
  return o == 0 ? m * N * N + p
                : (o == 1 ? (p / N) * N * N + m * N + p % N : p * N + m);
}

// SIP flux of one face point from the cell's own view (side s, sign =
// +1 at the high face): the lifted value and gradient terms
template <typename T>
__device__ __forceinline__ void flux(T u_m, T gn_m, T u_p, T gn_p, T sigma,
                                     T wf, T sign, T& tv, T& tg) {
  const T jump = u_m - u_p;  // before any scaling
  tv = (sigma * jump - T(0.5) * (gn_m + gn_p)) * wf;
  tg = T(-0.5) * jump * wf * sign;
}

// out[r] = sum_m M[r][m] in[m] (tr: M[m][r])
template <typename T, int N>
__device__ __forceinline__ void mat(const T* M, bool tr, const T* in,
                                    T* out) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    T a = T(0);
#pragma unroll
    for (int m = 0; m < N; ++m) a += M[tr ? m * N + r : r * N + m] * in[m];
    out[r] = a;
  }
}

// out = S in (tr: S^T in), or out = in for the Gauss kind (S = I)
template <typename T, int N>
__device__ __forceinline__ void interp(const T* S, int colloc, const T* in,
                                       T* out, bool tr = false) {
  if (colloc) {
#pragma unroll
    for (int m = 0; m < N; ++m) out[m] = in[m];
  } else {
    mat<T, N>(S, tr, in, out);
  }
}

// v[i] for a thread-dependent i < M, from static indices only
template <int M, typename T>
__device__ __forceinline__ T pick(const T* v, int i) {
  T r = v[0];
#pragma unroll
  for (int m = 1; m < M; ++m)
    if (i == m) r = v[m];
  return r;
}

// A product never fused into an add: the volume term's product by w3 in
// the lean order, formed in T4 just before the lifts are added to it (the
// template's order forms it in T2, a phase apart from that add)
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// A thread's place in a pencil of K cells along x (n^2 threads a cell,
// one line slot each) of row cy in layer cz of a C0 x C1 x C2 grid
template <typename T, int N, int K>
struct Place {
  static constexpr int N2 = N * N;
  // the face stages' work: one row or column (r) of a face (f) of a pencil
  // cell (cc), for the +-z and +-y faces of every cell, then the low x face
  // of the first cell and the high x face of the last (the only x faces
  // with a neighbour block)
  static constexpr int FACE_ITEMS = 4 * K * N + 2 * N;
  int t, nt;               // thread, threads a block
  int c, p, q1, q2;        // cell in the pencil; face point p = (q1, q2)
  int x0, c_last;          // the pencil's first cell; its last one
  int cz, cy, C0, C1, C2;  // the pencil's layer and row; the grid
  bool lane, valid;        // owns a line slot; its cell is in the grid
  T wq1, wq2;              // the quadrature weights at q1, q2
  // does face f of pencil cell cc have a neighbour cell?
  __device__ bool has_nb(int cc, int f) const {
    switch (f) {
      case 0: return cz > 0;
      case 1: return cz < C0 - 1;
      case 2: return cy > 0;
      case 3: return cy < C1 - 1;
      case 4: return cc == 0 && x0 > 0;
      default: return cc == c_last && x0 + cc < C2 - 1;
    }
  }
  __device__ void face_item(int it, int& cc, int& f, int& r) const {
    r = it % N;
    if (it < 4 * K * N) {
      cc = it / (4 * N);
      f = (it / N) % 4;
    } else {
      f = 4 + (it - 4 * K * N) / N;
      cc = f == 4 ? 0 : c_last;
    }
  }
};

// The place of this thread in pencil b of a grid of pencils (x fastest,
// then rows, then layers), nt threads a block
template <typename T, int N, int K>
__device__ __forceinline__ Place<T, N, K> place(const T* ct, unsigned b,
                                                int nt, int C0, int C1,
                                                int C2) {
  constexpr int N2 = N * N;
  Place<T, N, K> pl;
  pl.t = threadIdx.x;
  pl.nt = nt;
  pl.lane = pl.t < K * N2;
  pl.c = pl.lane ? pl.t / N2 : 0;
  pl.p = pl.t % N2;
  pl.q1 = pl.p / N;
  pl.q2 = pl.p % N;
  const int npx = (C2 + K - 1) / K;
  pl.cy = (b / npx) % C1;
  pl.cz = b / (npx * C1);
  pl.x0 = (b % npx) * K;
  pl.c_last = min(K, C2 - pl.x0) - 1;  // last cell of a ragged pencil
  pl.valid = pl.lane && pl.x0 + pl.c < C2;
  pl.C0 = C0;
  pl.C1 = C1;
  pl.C2 = C2;
  pl.wq1 = pick<N>(ct + Tab<N>::W, pl.q1);
  pl.wq2 = pick<N>(ct + Tab<N>::W, pl.q2);
  return pl;
}

// ---- the phases: what a thread does between two barriers

// T0's reduction of a line along a face normal: b = sum_m (f_s S)[m] w(m),
// c = sum_m (f_s D S)[m] w(m), the traces the neighbour across face side
// 1 - s sees
template <typename T, int N, typename W>
__device__ __forceinline__ void reduce_bc(const T* ct, int s, W w, T& b,
                                          T& c) {
  using L = Tab<N>;
  b = T(0);
  c = T(0);
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const T v = w(m);
    b += ct[L::B + s * N + m] * v;
    c += ct[L::C + s * N + m] * v;
  }
}

// T0 (lines along 0): S_0 u, DS_0 u of the thread's line u, into volume
// buffers 0, 1
template <typename T, int N, class LY, class PL>
__device__ __forceinline__ void t0_lines(const T* ct, int colloc,
                                         const LY& ly, const PL& pl,
                                         const T* u) {
  using L = Tab<N>;
  constexpr int N2 = N * N;
  T a[N], a2[N];
  interp<T, N>(ct + L::S, colloc, u, a);
  mat<T, N>(ct + L::DS, false, u, a2);
#pragma unroll
  for (int m = 0; m < N; ++m) {
    ly.vol(0, pl.c)[m * N2 + pl.p] = a[m];
    ly.vol(1, pl.c)[m * N2 + pl.p] = a2[m];
  }
}

// T0 of the pencil kernels: x's lines along 0 and the neighbour
// reductions, from device memory
template <typename T, int N, class LY, class PL>
__device__ __forceinline__ void phase0(const T* ct, int colloc, const LY& ly,
                                       const PL& pl, const T* x,
                                       int64_t cbase) {
  constexpr int N2 = N * N, N3 = N2 * N;
  if (pl.lane) {
    T u[N];
#pragma unroll
    for (int m = 0; m < N; ++m)
      u[m] = pl.valid ? x[cbase + m * N2 + pl.p] : T(0);
    t0_lines<T, N>(ct, colloc, ly, pl, u);
  }
  if (pl.valid) {
    const int64_t nb_off[3] = {(int64_t)pl.C1 * pl.C2 * N3,
                               (int64_t)pl.C2 * N3, (int64_t)N3};
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      // +-z, +-y: read the own block where there is no neighbour (the
      // domain boundary), so that the loads of all four issue together;
      // x: pencil ends only
      const bool nb_f = pl.has_nb(pl.c, f);
      if (f >= 4 && !nb_f) continue;
      const int d = f >> 1, s = f & 1;
      const T* nb = x + cbase + (nb_f ? (s ? nb_off[d] : -nb_off[d]) : 0);
      T P, Q;
      reduce_bc<T, N>(ct, 1 - s, [&](int m) { return nb[node<N>(d, pl.p, m)]; },
                      P, Q);
      if (nb_f) {
        ly.nb(0, pl.c, f)[pl.p] = P;
        ly.nb(1, pl.c, f)[pl.p] = Q;
      }
    }
  }
}

// T1 (lines along 1): S_1 a, DS_1 a, S_1 a' of volume buffers a = 0, a' = 1
// into T1 + 0..2; face stage 1 (rows): S P, D S P, S Q of the neighbour's
// reductions P, Q
template <typename T, int N, class LY, class PL>
__device__ __forceinline__ void phase1(const T* ct, int colloc, const LY& ly,
                                       const PL& pl) {
  using L = Tab<N>;
  if (pl.lane) {
    const int c = pl.c, p = pl.p;
    T la[N], lb[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      la[m] = ly.vol(0, c)[node<N>(1, p, m)];
      lb[m] = ly.vol(1, c)[node<N>(1, p, m)];
    }
    interp<T, N>(ct + L::S, colloc, la, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(LY::T1, c)[node<N>(1, p, m)] = o[m];
    mat<T, N>(ct + L::DS, false, la, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(LY::T1 + 1, c)[node<N>(1, p, m)] = o[m];
    interp<T, N>(ct + L::S, colloc, lb, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(LY::T1 + 2, c)[node<N>(1, p, m)] = o[m];
  }
  for (int it = pl.t; it < PL::FACE_ITEMS; it += pl.nt) {
    int cc, f, r;
    pl.face_item(it, cc, f, r);
    if (pl.x0 + cc >= pl.C2 || !pl.has_nb(cc, f)) continue;
    T P[N], Q[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      P[m] = ly.nb(0, cc, f)[r * N + m];
      Q[m] = ly.nb(1, cc, f)[r * N + m];
    }
    interp<T, N>(ct + L::S, colloc, P, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.st(0, cc, f)[r * N + m] = o[m];
    mat<T, N>(ct + L::DS, false, P, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.st(1, cc, f)[r * N + m] = o[m];
    interp<T, N>(ct + L::S, colloc, Q, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.st(2, cc, f)[r * N + m] = o[m];
  }
}

// out[a] = sum_m f_s[m] w[a][m] for A lines w, the sums side by side
template <typename T, int N, int A>
__device__ __forceinline__ void face_sums(const T* ct, int s,
                                          const T (*w)[N], T* out) {
  using L = Tab<N>;
#pragma unroll
  for (int a = 0; a < A; ++a) out[a] = T(0);
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const T fs = ct[L::F + s * N + m];
#pragma unroll
    for (int a = 0; a < A; ++a) out[a] += fs * w[a][m];
  }
}

// gvec_d . (t0, t1, t2): the normal derivative at a face of direction d
template <typename T, int N>
__device__ __forceinline__ T normal(const T* ct, int d, T t0, T t1, T t2) {
  using L = Tab<N>;
  return ct[L::GVEC + 3 * d] * t0 + ct[L::GVEC + 3 * d + 1] * t1 +
         ct[L::GVEC + 3 * d + 2] * t2;
}

// sum_f Gsym[e][f] g_f at one node: the volume term before its product by
// w3
template <typename T, int N>
__device__ __forceinline__ T vol_term(const T* ct, int e, T g0, T g1, T g2) {
  using L = Tab<N>;
  return ct[L::GSYM + 3 * e] * g0 + ct[L::GSYM + 3 * e + 1] * g1 +
         ct[L::GSYM + 3 * e + 2] * g2;
}

// T2 (lines along 2): v, g_0..2 into volume buffers 0..3, the x traces
// and, in the template's order, the volume term acc (held to T4); face
// stage 2 (columns): the neighbour's u+, gn+
template <typename T, int N, class LY, class PL>
__device__ __forceinline__ void phase2(const T* ct, int colloc, const LY& ly,
                                       const PL& pl, T (&acc)[3][N]) {
  using L = Tab<N>;
  if (pl.lane) {
    const int c = pl.c, p = pl.p;
    auto line = [&](int a, T* l) {
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = ly.vol(a, c)[p * N + m];
    };
    auto store = [&](int a, const T* l) {
#pragma unroll
      for (int m = 0; m < N; ++m) ly.vol(a, c)[p * N + m] = l[m];
    };
    T l[N];
    if constexpr (LY::LEAN) {
      // each array stored, and its share of the traces summed, as soon as
      // it is made: at most three lines in registers
      T v[N], g[3][N], tr[4][2];
      auto traces = [&](const T (&w)[N], int a) {
#pragma unroll
        for (int s = 0; s < 2; ++s) face_sums<T, N, 1>(ct, s, &w, &tr[a][s]);
      };
      line(LY::T1, l);
      interp<T, N>(ct + L::S, colloc, l, v);
      mat<T, N>(ct + L::DS, false, l, g[2]);
      traces(v, 0);
      store(0, v);
      traces(g[2], 3);
      store(3, g[2]);
      line(LY::T1 + 1, l);
      interp<T, N>(ct + L::S, colloc, l, g[1]);
      line(LY::T1 + 2, l);
      interp<T, N>(ct + L::S, colloc, l, g[0]);
      traces(g[0], 1);
      traces(g[1], 2);
      store(1, g[0]);
      store(2, g[1]);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        ly.xt(0, c, s)[p] = tr[0][s];
        ly.xt(1, c, s)[p] = normal<T, N>(ct, 2, tr[1][s], tr[2][s], tr[3][s]);
      }
    } else {
      T vg[4][N];  // v, g_0..2
      line(LY::T1, l);
      interp<T, N>(ct + L::S, colloc, l, vg[0]);
      mat<T, N>(ct + L::DS, false, l, vg[3]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        line(LY::T1 + 2 - e, l);
        interp<T, N>(ct + L::S, colloc, l, vg[1 + e]);
      }
#pragma unroll
      for (int m = 0; m < N; ++m) {
        ly.vol(0, c)[p * N + m] = vg[0][m];
        const T w3 = pl.wq1 * pl.wq2 * ct[L::W + m];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          ly.vol(1 + e, c)[p * N + m] = vg[1 + e][m];
          acc[e][m] = vol_term<T, N>(ct, e, vg[1][m], vg[2][m], vg[3][m]) * w3;
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        T tr[4];  // u-, and the sums of g_0..2
        face_sums<T, N, 4>(ct, s, vg, tr);
        ly.xt(0, c, s)[p] = tr[0];
        ly.xt(1, c, s)[p] = normal<T, N>(ct, 2, tr[1], tr[2], tr[3]);
      }
    }
  }
  for (int it = pl.t; it < PL::FACE_ITEMS; it += pl.nt) {
    int cc, f, r;
    pl.face_item(it, cc, f, r);
    if (pl.x0 + cc >= pl.C2 || !pl.has_nb(cc, f)) continue;
    const int d = f >> 1;
    const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
    const T sign = (f & 1) ? T(1) : T(-1);
    auto column = [&](int a, T* A) {
#pragma unroll
      for (int m = 0; m < N; ++m) A[m] = ly.st(a, cc, f)[m * N + r];
    };
    T uu[N], gq[N], ge1[N], ge2[N];
    if constexpr (LY::LEAN) {
      // each input column loaded just before its sweeps and retired after
      // them: at most five columns in registers
      T A[N];
      column(0, A);
      interp<T, N>(ct + L::S, colloc, A, uu);
      mat<T, N>(ct + L::DS, false, A, ge1);
      column(2, A);
      interp<T, N>(ct + L::S, colloc, A, gq);
      column(1, A);
      interp<T, N>(ct + L::S, colloc, A, ge2);
    } else {
      T A1[N], A2[N], A3[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        A1[m] = ly.st(0, cc, f)[m * N + r];
        A2[m] = ly.st(1, cc, f)[m * N + r];
        A3[m] = ly.st(2, cc, f)[m * N + r];
      }
      interp<T, N>(ct + L::S, colloc, A1, uu);
      interp<T, N>(ct + L::S, colloc, A3, gq);
      interp<T, N>(ct + L::S, colloc, A2, ge2);
      mat<T, N>(ct + L::DS, false, A1, ge1);
    }
    const T gd = pick<9>(ct + L::GVEC, 3 * d + d);
    const T g1 = pick<9>(ct + L::GVEC, 3 * d + e1);
    const T g2 = pick<9>(ct + L::GVEC, 3 * d + e2);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      ly.nb(0, cc, f)[m * N + r] = uu[m];
      ly.nb(1, cc, f)[m * N + r] =
          sign * (gd * gq[m] + g1 * ge1[m] + g2 * ge2[m]);
    }
  }
}

// T3: the fluxes t_val, t_gr of every face of the thread's cell at its face
// point; +-z and +-y from lines through this face point, the x faces from
// the x traces (the face between two cells of the pencil once)
template <typename T, int N, class LY, class PL>
__device__ __forceinline__ void phase3(const T* ct, const LY& ly,
                                       const PL& pl) {
  using L = Tab<N>;
  if (!pl.valid) return;
  const int c = pl.c, p = pl.p;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    T sums[2][4];  // u-, and the sums of g_0..2, at s = 0, 1
    T wf;
    auto lines = [&](T (&vg)[4][N]) {
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const int o = node<N>(d, p, m);
#pragma unroll
        for (int a = 0; a < 4; ++a) vg[a][m] = ly.vol(a, c)[o];
      }
    };
    // the flux of face (d, s) from this cell's side, from its face sums tr
    auto face = [&](int s, const T* tr) {
      const int f = 2 * d + s;
      const T sign = s ? T(1) : T(-1);
      const T u_m = tr[0];
      const T gn_m = sign * normal<T, N>(ct, d, tr[1], tr[2], tr[3]);
      T u_p = -u_m, gn_p = gn_m;  // Dirichlet mirror
      if (pl.has_nb(c, f)) {
        u_p = ly.nb(0, c, f)[p];
        gn_p = ly.nb(1, c, f)[p];
      }
      flux(u_m, gn_m, u_p, gn_p, ct[L::SIGMA + d], wf, sign,
           ly.st(0, c, f)[p], ly.st(1, c, f)[p]);
    };
    if constexpr (LY::LEAN) {
      {  // the lines retire before the fluxes
        T vg[4][N];
        lines(vg);
#pragma unroll
        for (int s = 0; s < 2; ++s) face_sums<T, N, 4>(ct, s, vg, sums[s]);
      }
      wf = ct[L::JXW + d] * pl.wq1 * pl.wq2;
#pragma unroll
      for (int s = 0; s < 2; ++s) face(s, sums[s]);
    } else {
      T vg[4][N];
      lines(vg);
      wf = ct[L::JXW + d] * pl.wq1 * pl.wq2;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        face_sums<T, N, 4>(ct, s, vg, sums[s]);
        face(s, sums[s]);
      }
    }
  }
  // x faces at point (i, j) = p
  const T wf = ct[L::JXW + 2] * pl.wq1 * pl.wq2;
  const T sig = ct[L::SIGMA + 2];
  auto own_view = [&](int s) {
    const int f = 4 + s;
    const T sign = s ? T(1) : T(-1);
    const T u_m = ly.xt(0, c, s)[p], gn_m = sign * ly.xt(1, c, s)[p];
    T u_p = -u_m, gn_p = gn_m;
    if (pl.has_nb(c, f)) {
      u_p = ly.nb(0, c, f)[p];
      gn_p = ly.nb(1, c, f)[p];
    }
    flux(u_m, gn_m, u_p, gn_p, sig, wf, sign, ly.st(0, c, f)[p],
         ly.st(1, c, f)[p]);
  };
  if (c == 0) {
    own_view(0);
  } else {
    // the face between cells c - 1 (minus) and c (plus), once
    T tv, tg;
    flux(ly.xt(0, c - 1, 1)[p], ly.xt(1, c - 1, 1)[p], ly.xt(0, c, 0)[p],
         ly.xt(1, c, 0)[p], sig, wf, T(1), tv, tg);
    ly.st(0, c - 1, 5)[p] = tv;
    ly.st(1, c - 1, 5)[p] = tg;
    ly.st(0, c, 4)[p] = -tv;
    ly.st(1, c, 4)[p] = tg;
  }
  if (c == pl.c_last) own_view(1);
}

// the back end's tables: S and D S for A x, S T and D S T for T3^T A x
// (S T is never the identity, so its column flag is 0)
template <typename T, int N, int MODE>
struct Back {
  const T* S;
  const T* DS;
  int colloc;
  __device__ Back(const T* ct, int colloc_)
      : S(ct + (MODE == CHEB ? Tab<N>::ST : Tab<N>::S)),
        DS(ct + (MODE == CHEB ? Tab<N>::DST : Tab<N>::DS)),
        colloc(MODE == CHEB ? 0 : colloc_) {}
};

// T4 (lines along 2, through (i, j) = p): the lifts, then the back end
// along 2 (with x); for the step also T_2^T b
template <typename T, int N, int MODE, class LY, class PL>
__device__ __forceinline__ void phase4(const T* ct, int colloc, const LY& ly,
                                       const PL& pl, bool hx, T (&acc)[3][N],
                                       const T* __restrict__ bvec,
                                       int64_t cbase) {
  using L = Tab<N>;
  if (!pl.lane) return;
  const int c = pl.c, p = pl.p, q1 = pl.q1, q2 = pl.q2;
  const Back<T, N, MODE> bk(ct, colloc);
  T o[N];
  if (hx) {
    if constexpr (LY::LEAN) {
      // the volume term from the gradients T2 left
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const T w3 = pl.wq1 * pl.wq2 * ct[L::W + m];
        const T g0 = ly.vol(1, c)[p * N + m], g1 = ly.vol(2, c)[p * N + m],
                g2 = ly.vol(3, c)[p * N + m];
#pragma unroll
        for (int e = 0; e < 3; ++e)
          acc[e][m] = mul_rn(vol_term<T, N>(ct, e, g0, g1, g2), w3);
      }
    }
    T vacc[N];
    const T fi[2] = {pick<N>(ct + L::F, q1), pick<N>(ct + L::F + N, q1)};
    const T fj[2] = {pick<N>(ct + L::F, q2), pick<N>(ct + L::F + N, q2)};
#pragma unroll
    for (int m = 0; m < N; ++m) {
      // node (i, j, k = m): z face point (j, k), y face point (i, k)
      T lz = T(0), ly_ = T(0), lx = T(0);
      vacc[m] = T(0);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const T fk = ct[L::F + s * N + m];
        vacc[m] += fi[s] * ly.st(0, c, s)[q2 * N + m] +
                   fj[s] * ly.st(0, c, 2 + s)[q1 * N + m] +
                   fk * ly.st(0, c, 4 + s)[p];
        lz += fi[s] * ly.st(1, c, s)[q2 * N + m];
        ly_ += fj[s] * ly.st(1, c, 2 + s)[q1 * N + m];
        lx += fk * ly.st(1, c, 4 + s)[p];
      }
#pragma unroll
      for (int e = 0; e < 3; ++e)
        acc[e][m] += ct[L::GVEC + e] * lz + ct[L::GVEC + 3 + e] * ly_ +
                     ct[L::GVEC + 6 + e] * lx;
    }
    // BS^T_2 acc_e into volume buffer 2 - e (e = 0, 1)
    auto back = [&](int e) {
      interp<T, N>(bk.S, bk.colloc, acc[e], o, true);
#pragma unroll
      for (int m = 0; m < N; ++m) ly.vol(2 - e, c)[p * N + m] = o[m];
    };
    // BS^T_2 vacc + BDS^T_2 acc_2 into volume buffer 0
    auto back_v = [&]() {
      T y2[N];
      interp<T, N>(bk.S, bk.colloc, vacc, o, true);
      mat<T, N>(bk.DS, true, acc[2], y2);
#pragma unroll
      for (int m = 0; m < N; ++m) ly.vol(0, c)[p * N + m] = o[m] + y2[m];
    };
    if constexpr (LY::LEAN) {
      // acc_0 and acc_1 first, so that each retires before vacc is swept
      back(0);
      back(1);
      back_v();
    } else {
      back_v();
      back(1);
      back(0);
    }
  }
  if constexpr (MODE == CHEB) {
    T bl[N];
#pragma unroll
    for (int m = 0; m < N; ++m)
      bl[m] = pl.valid ? bvec[cbase + p * N + m] : T(0);
    mat<T, N>(ct + L::TT, true, bl, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(3, c)[p * N + m] = o[m];
  }
}

// T5 (lines along 1): the back end along 1 into T5 + 0, 1 (with x); for
// the step also T_1^T of T_2^T b into CB
template <typename T, int N, int MODE, class LY, class PL>
__device__ __forceinline__ void phase5(const T* ct, int colloc, const LY& ly,
                                       const PL& pl, bool hx) {
  using L = Tab<N>;
  if (!pl.lane) return;
  const int c = pl.c, p = pl.p;
  const Back<T, N, MODE> bk(ct, colloc);
  T l[N], o[N];
  if constexpr (MODE == CHEB) {
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = ly.vol(3, c)[node<N>(1, p, m)];
    mat<T, N>(ct + L::TT, true, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(LY::CB, c)[node<N>(1, p, m)] = o[m];
  }
  if (hx) {
    T l2[N], o2[N];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      l[m] = ly.vol(0, c)[node<N>(1, p, m)];
      l2[m] = ly.vol(1, c)[node<N>(1, p, m)];
    }
    interp<T, N>(bk.S, bk.colloc, l, o, true);
    mat<T, N>(bk.DS, true, l2, o2);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      ly.vol(LY::T5, c)[node<N>(1, p, m)] = o[m] + o2[m];
      l[m] = ly.vol(2, c)[node<N>(1, p, m)];
    }
    interp<T, N>(bk.S, bk.colloc, l, o, true);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(LY::T5 + 1, c)[node<N>(1, p, m)] = o[m];
  }
}

// T6's back end along 0 on the thread's line: y_m = BS^T_0 (buffer T5) +
// BDS^T_0 (buffer T5 + 1) at node m (m n^2 along the line), handed to
// y(m, y_m) as each is formed
template <typename T, int N, int MODE, class LY, class PL, class Y>
__device__ __forceinline__ void phase6(const T* ct, int colloc, const LY& ly,
                                       const PL& pl, Y y) {
  constexpr int N2 = N * N;
  const Back<T, N, MODE> bk(ct, colloc);
  T l[N], l2[N], o[N], o2[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    l[m] = ly.vol(LY::T5, pl.c)[m * N2 + pl.p];
    l2[m] = ly.vol(LY::T5 + 1, pl.c)[m * N2 + pl.p];
  }
  interp<T, N>(bk.S, bk.colloc, l, o, true);
  mat<T, N>(bk.DS, true, l2, o2);
#pragma unroll
  for (int m = 0; m < N; ++m) y(m, o[m] + o2[m]);
}

// The pencil of every mode over layout LY (see the note above).  x may be
// null only in the cheb mode (x = 0); x_old, inv_diag, f1, f2 are read
// only there, b by the residual and cheb modes.
template <typename T, int N, int MODE,
          class LY = TemplateLayout<T, N, MODE>>
__device__ __forceinline__ void pencil_body(
    const T* ct, const T* __restrict__ x, T* out, const T* __restrict__ bvec,
    const T* x_old, const T* __restrict__ inv_diag, T f1, T f2, int C0,
    int C1, int C2, int colloc) {
  using L = Tab<N>;
  constexpr int N2 = N * N, N3 = N2 * N, K = LY::CELLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LY ly{reinterpret_cast<T*>(smem_raw)};
  const Place<T, N, K> pl =
      place<T, N, K>(ct, blockIdx.x, blockDim.x, C0, C1, C2);
  const int c = pl.c, p = pl.p;
  const int64_t row = ((int64_t)pl.cz * C1 + pl.cy) * C2;
  const int64_t cbase = (row + (pl.valid ? pl.x0 + c : pl.x0)) * N3;
  const bool hx = MODE != CHEB || x != nullptr;
  T acc[3][N];

  if (hx) {
    phase0<T, N>(ct, colloc, ly, pl, x, cbase);
    __syncthreads();  // 1
    phase1<T, N>(ct, colloc, ly, pl);
    __syncthreads();  // 2
    phase2<T, N>(ct, colloc, ly, pl, acc);
    __syncthreads();  // 3
    phase3<T, N>(ct, ly, pl);
    __syncthreads();  // 4
  }
  phase4<T, N, MODE>(ct, colloc, ly, pl, hx, acc, bvec, cbase);
  __syncthreads();  // 5 (1 without x)
  phase5<T, N, MODE>(ct, colloc, ly, pl, hx);
  __syncthreads();  // 6 (2)

  if constexpr (MODE != CHEB) {
    // ---- T6 (lines along 0): out = y or b - y
    if (pl.valid) {
      phase6<T, N, MODE>(ct, colloc, ly, pl, [&](int m, T y) {
        const int64_t gi = cbase + m * N2 + p;
        out[gi] = MODE == RESIDUAL ? bvec[gi] - y : y;
      });
    }
    return;
  }

  // ---- T6 (lines along 0): T3^T b - T3^T A x, * inv_diag, T_0
  if (pl.lane) {
    T l[N], z[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = ly.vol(LY::CB, c)[m * N2 + p];
    mat<T, N>(ct + L::TT, true, l, z);
    if (hx)
      phase6<T, N, MODE>(ct, colloc, ly, pl,
                         [&](int m, T y) { z[m] -= y; });
#pragma unroll
    for (int m = 0; m < N; ++m)
      z[m] = pl.valid ? z[m] * inv_diag[cbase + m * N2 + p] : T(0);
    mat<T, N>(ct + L::TT, false, z, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(0, c)[m * N2 + p] = o[m];
  }
  __syncthreads();  // 7 (3)

  // ---- T7 (lines along 1): T_1
  if (pl.lane) {
    T l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = ly.vol(0, c)[node<N>(1, p, m)];
    mat<T, N>(ct + L::TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) ly.vol(LY::T7, c)[node<N>(1, p, m)] = o[m];
  }
  __syncthreads();  // 8 (4)

  // ---- T8 (lines along 2): T_2 and the update; out may alias x_old (this
  // thread alone reads and writes each of its elements)
  if (pl.valid) {
    T l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = ly.vol(LY::T7, c)[p * N + m];
    mat<T, N>(ct + L::TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int64_t gi = cbase + p * N + m;
      const T xv = hx ? x[gi] : T(0);
      const T xo = x_old != nullptr ? x_old[gi] : T(0);
      out[gi] = xv + f1 * (xv - xo) + f2 * o[m];
    }
  }
}

// The table argument: kernel parameters hold 32,764 bytes since CUDA 12.1
// (4 KB before), as brick_kron.cuh's taps also rely on; the double table
// takes 4,584 B at n = 9, 5,552 B at n = 10 and 15,016 B at n = 17
template <typename T, int N>
TabArg<T, N> tab_arg(const T* tab) {
  static_assert(sizeof(TabArg<T, N>) + 96 <= 32764,
                "the table and the other arguments exceed 32,764 bytes");
  TabArg<T, N> targ;
  for (int i = 0; i < Tab<N>::SIZE; ++i) targ.v[i] = tab[i];
  return targ;
}

// Grid of pencils (one block each) and, at the first launch of a kernel,
// its dynamic shared-memory limit raised to what it needs
template <typename T, int N, int MODE, typename Kernel>
int pencil_grid(Kernel kernel, bool& configured, int C0, int C1, int C2,
                unsigned& blocks) {
  constexpr int K = pencil<N, MODE>();
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, N, MODE>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long nb = (long long)C0 * C1 * ((C2 + K - 1) / K);
  if (nb >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  blocks = (unsigned)nb;
  return 0;
}

// The launch bound names 1 block an SM explicitly: ptxas then takes the
// registers the body wants (110 in double, 72 in float at p = 4).  With
// the block size alone it capped them lower: the double kernels spilled at
// p = 2 and 6, and float at p = 4 got 64 (PERF.md §6).
template <typename T, int N, bool RESID>
__global__ void __launch_bounds__(threads<N, APPLY>(), 1)
dg_apply_kernel(const __grid_constant__ TabArg<T, N> tab,
                const T* __restrict__ x, T* __restrict__ out,
                const T* __restrict__ b, int C0, int C1, int C2, int colloc) {
  pencil_body<T, N, RESID ? RESIDUAL : APPLY>(tab.v, x, out, b, nullptr,
                                              nullptr, T(0), T(0), C0, C1,
                                              C2, colloc);
}

template <typename T, int N, bool RESID>
int launch_apply(const T* x, const T* b, const T* tab, T* out, int C0,
                 int C1, int C2, int colloc, cudaStream_t stream) {
  static bool configured = false;
  unsigned blocks = 0;
  const int err = pencil_grid<T, N, APPLY>(dg_apply_kernel<T, N, RESID>,
                                           configured, C0, C1, C2, blocks);
  if (err) return err;
  dg_apply_kernel<T, N, RESID>
      <<<blocks, threads<N, APPLY>(), smem_bytes<T, N, APPLY>(),
         stream>>>(tab_arg<T, N>(tab), x, out, b, C0, C1, C2, colloc);
  return (int)cudaGetLastError();
}

template <typename T, int NN>
int apply_mode(int mode, const T* x, const T* b, const T* tab, T* out,
               int C0, int C1, int C2, int colloc, cudaStream_t st) {
  return mode == RESIDUAL
             ? launch_apply<T, NN, true>(x, b, tab, out, C0, C1, C2, colloc, st)
             : launch_apply<T, NN, false>(x, b, tab, out, C0, C1, C2, colloc,
                                          st);
}

// the first n of the wide pencils and the last: p = 10..16; n = 11..14 in
// dg_pencil_wide.cu / dg_pencil_wide_f64.cu, n = 15..17 in
// dg_pencil_wide_top.cu / dg_pencil_wide_top_f64.cu (four translation
// units, so that none builds slower than brick_kron.cu)
constexpr int kWideN = 11;
constexpr int kWideSplitN = 15;
constexpr int kWideTopN = 17;

// y = A x (mode 0) or out = b - A x (mode 1) at n = 2..17 points an axis
// (n = 9 in double: dg_pencil_high.cu; n >= 11: dg_pencil_wide*.cu)
template <typename T>
int dispatch_apply(int mode, const T* x, const T* b, const T* tab, T* out,
                   int C0, int C1, int C2, int n, int colloc, void* stream,
                   int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1 || (mode != APPLY && mode != RESIDUAL))
    return (int)cudaErrorInvalidValue;
  if (n >= kWideN) {
    if constexpr (sizeof(T) == 8)
      return dg_wide_apply_f64(mode, x, b, tab, out, C0, C1, C2, n, colloc,
                               stream, launched);
    else
      return dg_wide_apply_f32(mode, x, b, tab, out, C0, C1, C2, n, colloc,
                               stream, launched);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (n) {
#define APPLY_CASE(NN)                                                     \
  case NN:                                                                 \
    err = apply_mode<T, NN>(mode, x, b, tab, out, C0, C1, C2, colloc, st); \
    break;
    APPLY_CASE(2)
    APPLY_CASE(3)
    APPLY_CASE(4)
    APPLY_CASE(5)
    APPLY_CASE(6)
    APPLY_CASE(7)
    APPLY_CASE(8)
    case 9:
      if constexpr (sizeof(T) == 8)  // dg_pencil_high.cu
        return dg_high_apply_f64(mode, x, b, tab, out, C0, C1, C2, n, colloc,
                                 stream, launched);
      else
        err = apply_mode<T, 9>(mode, x, b, tab, out, C0, C1, C2, colloc, st);
      break;
    APPLY_CASE(10)
#undef APPLY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err == 0) *launched = 1;
  return err;
}

// ---- kernels over the in-place layout (dg_pencil_high.cu at n = 9, 10;
// the wide pencils below at n = 11..17)

// A grid of pencils of K cells (one block each) and, at the first launch
// of a kernel, its dynamic shared-memory limit raised to ``bytes``
template <typename Kernel>
int inplace_grid(Kernel kernel, bool& configured, int bytes, int C0, int C1,
                 int C2, int K, unsigned& blocks) {
  if (bytes > kBlockSmemMax) return (int)cudaErrorInvalidValue;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long nb = (long long)C0 * C1 * ((C2 + K - 1) / K);
  if (nb >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  blocks = (unsigned)nb;
  return 0;
}

// The tile of one kernel, for reports: cells a pencil, dynamic shared
// bytes, threads, blocks an SM (the occupancy calculator, after the
// kernel's shared memory is allowed), registers, local bytes a thread
template <typename Kernel>
int inplace_tile(Kernel kernel, int cells, int bytes, int nthreads,
                 int* out) {
  int per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        nthreads, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int v[6] = {cells, bytes, nthreads, per_sm, attr.numRegs,
                    (int)attr.localSizeBytes};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// ---- the wide pencils: n = 11..17 points an axis (p = 10..16), every
// mode, in float (dg_pencil_wide.cu, dg_pencil_wide_top.cu) and double
// (dg_pencil_wide_f64.cu, dg_pencil_wide_top_f64.cu).
// The template's layout no longer fits there (2 (7 n^3 + 34 n^2) values a
// pencil of two cells: 271,872 B in double at n = 12, 250,200 B in float
// at n = 15); the in-place one (4 n^3 + 22 n^2 a cell) does, with its lean
// order, over the same pencil body, so the outputs are the template's
// bits.  A pencil is the longest whose cells fit a block: two cells in
// float (208,080 B at n = 17) and in double up to n = 13 (200,096 B), one
// cell in double above (122,304 B at n = 14, 208,080 B at n = 17).  Two
// cells stay at float n = 16, 17 and double n = 12, which spill 24-184 B a
// thread: one cell, no spill, measured slower there in every mode but the
// float step at n = 17 (2.50 against 2.60 ms, 16^3 cells, time_dg_cheb
// --pencil wide:1 wide_f64:1, PERF.md).  One block an SM (the launch
// bound), so that ptxas may take 104 registers a thread at 608 threads
// (two cells at n = 17) and up to 255 at one cell.  DG_WIDE_CELLS sets
// the cells a pencil aimed at for every degree and type of a translation
// unit, for tuning builds (cut to what fits).
template <typename T, int N>
__host__ __device__ constexpr int wide_cells() {
#ifdef DG_WIDE_CELLS
  int k = DG_WIDE_CELLS;
#else
  int k = 2;
#endif
  while (k > 1 &&
         k * (4 * N * N * N + 22 * N * N) * (int)sizeof(T) > kBlockSmemMax)
    --k;
  return k;
}

template <typename T, int N>
using WideLayout = InPlace<T, N, wide_cells<T, N>()>;

template <typename T, int N>
__host__ __device__ constexpr int wide_threads() {
  return ((wide_cells<T, N>() * N * N + 31) / 32) * 32;
}

template <typename T, int N>
__host__ __device__ constexpr int wide_smem_bytes() {
  return WideLayout<T, N>::SIZE * (int)sizeof(T);
}

// One kernel a mode: apply and residual (out = y or b - y), and in float
// the step (x may be null, out may alias x_old, never x)
template <typename T, int N, int MODE>
__global__ void __launch_bounds__(wide_threads<T, N>(), 1)
dg_wide_kernel(const __grid_constant__ TabArg<T, N> tab,
               const T* __restrict__ x, T* out, const T* __restrict__ bvec,
               const T* x_old, const T* __restrict__ inv_diag, T f1, T f2,
               int C0, int C1, int C2, int colloc) {
  pencil_body<T, N, MODE, WideLayout<T, N>>(tab.v, x, out, bvec, x_old,
                                            inv_diag, f1, f2, C0, C1, C2,
                                            colloc);
}

template <typename T, int N, int MODE>
int launch_wide(const T* x, const T* b, const T* x_old, const T* inv_diag,
                const T* tab, T* out, double f1, double f2, int C0, int C1,
                int C2, int colloc, cudaStream_t stream) {
  constexpr int bytes = wide_smem_bytes<T, N>();
  static_assert(bytes <= kBlockSmemMax, "a wide pencil exceeds a block's "
                                     "shared memory");
  static bool configured = false;
  unsigned blocks = 0;
  const int err = inplace_grid(dg_wide_kernel<T, N, MODE>, configured, bytes,
                               C0, C1, C2, wide_cells<T, N>(), blocks);
  if (err) return err;
  dg_wide_kernel<T, N, MODE><<<blocks, wide_threads<T, N>(), bytes, stream>>>(
      tab_arg<T, N>(tab), x, out, b, x_old, inv_diag, (T)f1, (T)f2, C0, C1,
      C2, colloc);
  return (int)cudaGetLastError();
}

// mode (APPLY, RESIDUAL or, in float, CHEB) at n = N..HI, else
// cudaErrorInvalidValue; *launched = 1 on a launch
template <typename T, int N, int HI>
int wide_entry(int mode, const T* x, const T* b, const T* x_old,
               const T* inv_diag, const T* tab, T* out, double f1, double f2,
               int C0, int C1, int C2, int n, int colloc, void* stream,
               int* launched) {
  if constexpr (N > HI) {
    *launched = 0;
    return (int)cudaErrorInvalidValue;
  } else {
    if (n != N)
      return wide_entry<T, N + 1, HI>(mode, x, b, x_old, inv_diag, tab, out,
                                      f1, f2, C0, C1, C2, n, colloc, stream,
                                      launched);
    *launched = 0;
    if (C0 < 1 || C1 < 1 || C2 < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    int err;
    if (mode == APPLY)
      err = launch_wide<T, N, APPLY>(x, b, x_old, inv_diag, tab, out, f1, f2,
                                     C0, C1, C2, colloc, st);
    else if (mode == RESIDUAL)
      err = launch_wide<T, N, RESIDUAL>(x, b, x_old, inv_diag, tab, out, f1,
                                        f2, C0, C1, C2, colloc, st);
    else if constexpr (sizeof(T) == 4)
      err = mode == CHEB
                ? launch_wide<T, N, CHEB>(x, b, x_old, inv_diag, tab, out, f1,
                                          f2, C0, C1, C2, colloc, st)
                : (int)cudaErrorInvalidValue;
    else
      err = (int)cudaErrorInvalidValue;
    if (err == 0) *launched = 1;
    return err;
  }
}

// the tile of the wide kernel of mode at n = N..HI (inplace_tile)
template <typename T, int N, int HI>
int wide_tile(int mode, int n, int* out) {
  if constexpr (N > HI) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n != N) return wide_tile<T, N + 1, HI>(mode, n, out);
    constexpr int cells = wide_cells<T, N>(), bytes = wide_smem_bytes<T, N>();
    constexpr int nthreads = wide_threads<T, N>();
    if (mode == APPLY)
      return inplace_tile(dg_wide_kernel<T, N, APPLY>, cells, bytes,
                          nthreads, out);
    if (mode == RESIDUAL)
      return inplace_tile(dg_wide_kernel<T, N, RESIDUAL>, cells, bytes,
                          nthreads, out);
    if constexpr (sizeof(T) == 4)
      if (mode == CHEB)
        return inplace_tile(dg_wide_kernel<T, N, CHEB>, cells, bytes,
                            nthreads, out);
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
