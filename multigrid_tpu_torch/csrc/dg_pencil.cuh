// The SIP-DG pencil kernels for Hopper (sm_90a): one phase body, templated
// on the value type T, the points per axis N and a mode, with three thin
// entries:
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
// solver_dg's fused CG pass, dg_cg<double>, is a kernel of its own on this
// header's helpers (dg_cg_f64.cu: a block marches a column of pencils
// along z, loads each value once and keeps the next layer's loads in
// flight); the phases below hold one pencil's values for one launch.  Its
// phases T1-T6 repeat pencil_body's arithmetic (in place): a fix to one
// goes to the other.
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
//   T1 (1) S_1, DS_1; face stage 1     T2 (2) v, g_0..2, the volume term
//   (kept in registers), the x traces; face stage 2
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
// Shared memory: 7 n^3 volume and 34 n^2 face values a cell, in two sets
// (even and odd phases) so that a buffer read in one phase is written again
// only after the next barrier.
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
// Degrees 1 to 9 (n = 2..10), one instantiation each; the three kinds via
// the tables (S = I for the Gauss kind, whose flag skips the S products).
// The float step at p = 8, 9 (n = 9, 10) and the double apply and residual
// at p = 8 run dg_pencil_high.cu, these pencils (pencil() below: 3 and 2
// cells, the lengths a sweep of this body chose) with in-place phases in
// less shared memory; the float apply and residual at p = 8, 9 and the
// double ones at p = 9 run this body (PERF.md §6, PR 21: no variant of the
// other was faster there without spilling).  At n = 9, 10 the double table
// (573 / 694 values) passes 4 KB.
// An entry reads the table (ops/dg_kernel.py:dg_tables, in T) from host
// memory, writes the number of kernels it launched (1) to *launched and
// returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_tab.cuh"

// the double apply and residual at n = 9 and the float step at n = 9, 10
// (dg_pencil_high.cu)
extern "C" {
int dg_high_apply_f64(int mode, const double* x, const double* b,
                      const double* tab, double* out, int C0, int C1, int C2,
                      int n, int colloc, void* stream, int* launched);
int dg_high_cheb_f32(const float* b, const float* x, const float* x_old,
                     const float* inv_diag, const float* tab, float* out,
                     double f1, double f2, int C0, int C1, int C2, int n,
                     int colloc, void* stream, int* launched);
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

template <typename T, int N, int MODE>
constexpr size_t smem_bytes() {
  return (size_t)pencil<N, MODE>() * (7 * N * N * N + 34 * N * N) *
         sizeof(T);
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

// The phase body of every mode (see the note above).  x may be null only
// in the cheb mode (x = 0); x_old, inv_diag, f1, f2 are read only there,
// b by the residual and cheb modes.
template <typename T, int N, int MODE>
__device__ __forceinline__ void pencil_body(
    const T* ct, const T* __restrict__ x, T* out, const T* __restrict__ bvec,
    const T* x_old, const T* __restrict__ inv_diag, T f1, T f2, int C0,
    int C1, int C2, int colloc) {
  using L = Tab<N>;
  constexpr int N2 = N * N, N3 = N * N * N, K = pencil<N, MODE>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // volume [7][K][N3]: even V0..V3, odd V4..V6; faces, even: FE0, FE1
  // [K][6][N2] (the neighbour's P, Q in T0, its u+, gn+ in T2) and the x
  // traces XT0, XT1 [K][2][N2]; odd: FO0..FO2 [K][6][N2] (face stage 1 in
  // T1, the fluxes t_val, t_gr in T3)
  T* vol = reinterpret_cast<T*>(smem_raw);
  T* fe = vol + 7 * K * N3;
  T* fo = fe + 16 * K * N2;
  auto V = [&](int a, int c) { return vol + (a * K + c) * N3; };
  auto FE = [&](int a, int c, int f) {
    return fe + ((a * K + c) * 6 + f) * N2;
  };
  auto XT = [&](int a, int c, int s) {
    return fe + 12 * K * N2 + ((a * K + c) * 2 + s) * N2;
  };
  auto FO = [&](int a, int c, int f) {
    return fo + ((a * K + c) * 6 + f) * N2;
  };

  const int t = threadIdx.x;
  const bool lane = t < K * N2;            // owns a line slot
  const int c = lane ? t / N2 : 0;         // cell in the pencil
  const int p = t % N2, q1 = p / N, q2 = p % N;
  const int npx = (C2 + K - 1) / K;
  const int px = blockIdx.x % npx;
  const int cy = (blockIdx.x / npx) % C1;
  const int cz = blockIdx.x / (npx * C1);
  const int x0 = px * K;
  const int c_last = min(K, C2 - x0) - 1;  // last cell of a ragged pencil
  const bool valid = lane && x0 + c < C2;
  const int64_t row = ((int64_t)cz * C1 + cy) * C2;
  const int64_t cbase = (row + (valid ? x0 + c : x0)) * N3;
  // does face f of pencil cell cc have a neighbour cell?
  auto has_nb = [&](int cc, int f) {
    switch (f) {
      case 0: return cz > 0;
      case 1: return cz < C0 - 1;
      case 2: return cy > 0;
      case 3: return cy < C1 - 1;
      case 4: return cc == 0 && x0 > 0;
      default: return cc == c_last && x0 + cc < C2 - 1;
    }
  };
  const int64_t nb_off[3] = {(int64_t)C1 * C2 * N3, (int64_t)C2 * N3,
                             (int64_t)N3};
  // the face stages' work: one row or column (r) of a face (f) of a pencil
  // cell (cc), for the +-z and +-y faces of every cell, then the low x face
  // of the first cell and the high x face of the last (the only x faces
  // with a neighbour block)
  constexpr int FACE_ITEMS = 4 * K * N + 2 * N;
  auto face_item = [&](int it, int& cc, int& f, int& r) {
    r = it % N;
    if (it < 4 * K * N) {
      cc = it / (4 * N);
      f = (it / N) % 4;
    } else {
      f = 4 + (it - 4 * K * N) / N;
      cc = f == 4 ? 0 : c_last;
    }
  };
  const T wq1 = pick<N>(ct + L::W, q1), wq2 = pick<N>(ct + L::W, q2);
  const bool hx = MODE != CHEB || x != nullptr;
  // the back end's tables: S and D S for A x, S T and D S T for T3^T A x
  const T* BS = ct + (MODE == CHEB ? L::ST : L::S);
  const T* BDS = ct + (MODE == CHEB ? L::DST : L::DS);
  const int bcol = MODE == CHEB ? 0 : colloc;  // S T is never the identity
  T acc[3][N];

  if (hx) {
    // ---- T0 (lines along 0): S_0 x, DS_0 x; neighbour reductions
    if (lane) {
      T u[N], a[N], a2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) u[m] = valid ? x[cbase + m * N2 + p] : T(0);
      interp<T, N>(ct + L::S, colloc, u, a);
      mat<T, N>(ct + L::DS, false, u, a2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        V(0, c)[m * N2 + p] = a[m];
        V(1, c)[m * N2 + p] = a2[m];
      }
    }
    if (valid) {
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        // +-z, +-y: read the own block where there is no neighbour (the
        // domain boundary), so that the loads of all four issue together;
        // x: pencil ends only
        const bool nb_f = has_nb(c, f);
        if (f >= 4 && !nb_f) continue;
        const int d = f >> 1, s = f & 1;
        const T* nb = x + cbase + (nb_f ? (s ? nb_off[d] : -nb_off[d]) : 0);
        T P = T(0), Q = T(0);
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const T w = nb[node<N>(d, p, m)];
          P += ct[L::B + (1 - s) * N + m] * w;
          Q += ct[L::C + (1 - s) * N + m] * w;
        }
        if (nb_f) {
          FE(0, c, f)[p] = P;
          FE(1, c, f)[p] = Q;
        }
      }
    }
    __syncthreads();  // 1

    // ---- T1 (lines along 1): S_1 a, DS_1 a, S_1 a'; face stage 1 (rows)
    if (lane) {
      T la[N], lb[N], o[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        la[m] = V(0, c)[node<N>(1, p, m)];
        lb[m] = V(1, c)[node<N>(1, p, m)];
      }
      interp<T, N>(ct + L::S, colloc, la, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(4, c)[node<N>(1, p, m)] = o[m];
      mat<T, N>(ct + L::DS, false, la, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(5, c)[node<N>(1, p, m)] = o[m];
      interp<T, N>(ct + L::S, colloc, lb, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(6, c)[node<N>(1, p, m)] = o[m];
    }
    for (int it = t; it < FACE_ITEMS; it += blockDim.x) {
      int cc, f, r;
      face_item(it, cc, f, r);
      if (x0 + cc >= C2 || !has_nb(cc, f)) continue;
      T P[N], Q[N], o[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        P[m] = FE(0, cc, f)[r * N + m];
        Q[m] = FE(1, cc, f)[r * N + m];
      }
      interp<T, N>(ct + L::S, colloc, P, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FO(0, cc, f)[r * N + m] = o[m];
      mat<T, N>(ct + L::DS, false, P, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FO(1, cc, f)[r * N + m] = o[m];
      interp<T, N>(ct + L::S, colloc, Q, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FO(2, cc, f)[r * N + m] = o[m];
    }
    __syncthreads();  // 2

    // ---- T2 (lines along 2): v, g_0..2, the volume term, the x traces;
    // face stage 2 (columns)
    if (lane) {
      T l[N], v[N], g[3][N];
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = V(4, c)[p * N + m];
      interp<T, N>(ct + L::S, colloc, l, v);
      mat<T, N>(ct + L::DS, false, l, g[2]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 0; m < N; ++m) l[m] = V(6 - e, c)[p * N + m];
        interp<T, N>(ct + L::S, colloc, l, g[e]);
      }
#pragma unroll
      for (int m = 0; m < N; ++m) {
        V(0, c)[p * N + m] = v[m];
        const T w3 = wq1 * wq2 * ct[L::W + m];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          V(1 + e, c)[p * N + m] = g[e][m];
          acc[e][m] = (ct[L::GSYM + 3 * e] * g[0][m] +
                       ct[L::GSYM + 3 * e + 1] * g[1][m] +
                       ct[L::GSYM + 3 * e + 2] * g[2][m]) * w3;
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        T tu = T(0), t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const T fs = ct[L::F + s * N + m];
          tu += fs * v[m];
          t0 += fs * g[0][m];
          t1 += fs * g[1][m];
          t2 += fs * g[2][m];
        }
        XT(0, c, s)[p] = tu;
        XT(1, c, s)[p] = ct[L::GVEC + 6] * t0 + ct[L::GVEC + 7] * t1 +
                         ct[L::GVEC + 8] * t2;
      }
    }
    for (int it = t; it < FACE_ITEMS; it += blockDim.x) {
      int cc, f, r;
      face_item(it, cc, f, r);
      if (x0 + cc >= C2 || !has_nb(cc, f)) continue;
      const int d = f >> 1;
      const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
      const T sign = (f & 1) ? T(1) : T(-1);
      T A1[N], A2[N], A3[N], uu[N], gq[N], ge1[N], ge2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        A1[m] = FO(0, cc, f)[m * N + r];
        A2[m] = FO(1, cc, f)[m * N + r];
        A3[m] = FO(2, cc, f)[m * N + r];
      }
      interp<T, N>(ct + L::S, colloc, A1, uu);
      interp<T, N>(ct + L::S, colloc, A3, gq);
      interp<T, N>(ct + L::S, colloc, A2, ge2);
      mat<T, N>(ct + L::DS, false, A1, ge1);
      const T gd = pick<9>(ct + L::GVEC, 3 * d + d);
      const T g1 = pick<9>(ct + L::GVEC, 3 * d + e1);
      const T g2 = pick<9>(ct + L::GVEC, 3 * d + e2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        FE(0, cc, f)[m * N + r] = uu[m];
        FE(1, cc, f)[m * N + r] =
            sign * (gd * gq[m] + g1 * ge1[m] + g2 * ge2[m]);
      }
    }
    __syncthreads();  // 3

    // ---- T3: fluxes; +-z and +-y from lines through this face point
    if (valid) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        T v[N], g[3][N];
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const int o = node<N>(d, p, m);
          v[m] = V(0, c)[o];
#pragma unroll
          for (int e = 0; e < 3; ++e) g[e][m] = V(1 + e, c)[o];
        }
        const T wf = ct[L::JXW + d] * wq1 * wq2;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int f = 2 * d + s;
          const T sign = s ? T(1) : T(-1);
          T u_m = T(0), t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll
          for (int m = 0; m < N; ++m) {
            const T fs = ct[L::F + s * N + m];
            u_m += fs * v[m];
            t0 += fs * g[0][m];
            t1 += fs * g[1][m];
            t2 += fs * g[2][m];
          }
          const T gn_m = sign * (ct[L::GVEC + 3 * d] * t0 +
                                 ct[L::GVEC + 3 * d + 1] * t1 +
                                 ct[L::GVEC + 3 * d + 2] * t2);
          T u_p = -u_m, gn_p = gn_m;  // Dirichlet mirror
          if (has_nb(c, f)) {
            u_p = FE(0, c, f)[p];
            gn_p = FE(1, c, f)[p];
          }
          flux(u_m, gn_m, u_p, gn_p, ct[L::SIGMA + d], wf, sign,
               FO(0, c, f)[p], FO(1, c, f)[p]);
        }
      }
      // x faces at point (i, j) = p
      const T wf = ct[L::JXW + 2] * wq1 * wq2;
      const T sig = ct[L::SIGMA + 2];
      auto own_view = [&](int s) {
        const int f = 4 + s;
        const T sign = s ? T(1) : T(-1);
        const T u_m = XT(0, c, s)[p], gn_m = sign * XT(1, c, s)[p];
        T u_p = -u_m, gn_p = gn_m;
        if (has_nb(c, f)) {
          u_p = FE(0, c, f)[p];
          gn_p = FE(1, c, f)[p];
        }
        flux(u_m, gn_m, u_p, gn_p, sig, wf, sign, FO(0, c, f)[p],
             FO(1, c, f)[p]);
      };
      if (c == 0) {
        own_view(0);
      } else {
        // the face between cells c - 1 (minus) and c (plus), once
        T tv, tg;
        flux(XT(0, c - 1, 1)[p], XT(1, c - 1, 1)[p], XT(0, c, 0)[p],
             XT(1, c, 0)[p], sig, wf, T(1), tv, tg);
        FO(0, c - 1, 5)[p] = tv;
        FO(1, c - 1, 5)[p] = tg;
        FO(0, c, 4)[p] = -tv;
        FO(1, c, 4)[p] = tg;
      }
      if (c == c_last) own_view(1);
    }
    __syncthreads();  // 4
  }

  // ---- T4 (lines along 2, through (i, j) = p): lifts, then BS^T_2 and
  // BDS^T_2; for cheb also b and T_2^T b
  if (lane) {
    T o[N];
    if (hx) {
      T vacc[N];
      const T fi[2] = {pick<N>(ct + L::F, q1), pick<N>(ct + L::F + N, q1)};
      const T fj[2] = {pick<N>(ct + L::F, q2), pick<N>(ct + L::F + N, q2)};
#pragma unroll
      for (int m = 0; m < N; ++m) {
        // node (i, j, k = m): z face point (j, k), y face point (i, k)
        T lz = T(0), ly = T(0), lx = T(0);
        vacc[m] = T(0);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const T fk = ct[L::F + s * N + m];
          vacc[m] += fi[s] * FO(0, c, s)[q2 * N + m] +
                     fj[s] * FO(0, c, 2 + s)[q1 * N + m] +
                     fk * FO(0, c, 4 + s)[p];
          lz += fi[s] * FO(1, c, s)[q2 * N + m];
          ly += fj[s] * FO(1, c, 2 + s)[q1 * N + m];
          lx += fk * FO(1, c, 4 + s)[p];
        }
#pragma unroll
        for (int e = 0; e < 3; ++e)
          acc[e][m] += ct[L::GVEC + e] * lz + ct[L::GVEC + 3 + e] * ly +
                       ct[L::GVEC + 6 + e] * lx;
      }
      T y2[N];
      interp<T, N>(BS, bcol, vacc, o, true);
      mat<T, N>(BDS, true, acc[2], y2);
#pragma unroll
      for (int m = 0; m < N; ++m) V(0, c)[p * N + m] = o[m] + y2[m];
      interp<T, N>(BS, bcol, acc[1], o, true);
#pragma unroll
      for (int m = 0; m < N; ++m) V(1, c)[p * N + m] = o[m];
      interp<T, N>(BS, bcol, acc[0], o, true);
#pragma unroll
      for (int m = 0; m < N; ++m) V(2, c)[p * N + m] = o[m];
    }
    if constexpr (MODE == CHEB) {
      T bl[N];
#pragma unroll
      for (int m = 0; m < N; ++m)
        bl[m] = valid ? bvec[cbase + p * N + m] : T(0);
      mat<T, N>(ct + L::TT, true, bl, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(3, c)[p * N + m] = o[m];
    }
  }
  __syncthreads();  // 5 (1 without x)

  // ---- T5 (lines along 1)
  if (lane) {
    T l[N], o[N];
    if constexpr (MODE == CHEB) {
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = V(3, c)[node<N>(1, p, m)];
      mat<T, N>(ct + L::TT, true, l, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(6, c)[node<N>(1, p, m)] = o[m];
    }
    if (hx) {
      T l2[N], o2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        l[m] = V(0, c)[node<N>(1, p, m)];
        l2[m] = V(1, c)[node<N>(1, p, m)];
      }
      interp<T, N>(BS, bcol, l, o, true);
      mat<T, N>(BDS, true, l2, o2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        V(4, c)[node<N>(1, p, m)] = o[m] + o2[m];
        l[m] = V(2, c)[node<N>(1, p, m)];
      }
      interp<T, N>(BS, bcol, l, o, true);
#pragma unroll
      for (int m = 0; m < N; ++m) V(5, c)[node<N>(1, p, m)] = o[m];
    }
  }
  __syncthreads();  // 6 (2)

  if constexpr (MODE != CHEB) {
    // ---- T6 (lines along 0): y = BS^T_0 V4 + BDS^T_0 V5; out = y or b - y
    if (valid) {
      T l[N], l2[N], o[N], o2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        l[m] = V(4, c)[m * N2 + p];
        l2[m] = V(5, c)[m * N2 + p];
      }
      interp<T, N>(BS, bcol, l, o, true);
      mat<T, N>(BDS, true, l2, o2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const int64_t gi = cbase + m * N2 + p;
        const T y = o[m] + o2[m];
        out[gi] = MODE == RESIDUAL ? bvec[gi] - y : y;
      }
    }
    return;
  }

  // ---- T6 (lines along 0): T3^T b - T3^T A x, * inv_diag, T_0
  if (lane) {
    T l[N], z[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(6, c)[m * N2 + p];
    mat<T, N>(ct + L::TT, true, l, z);
    if (hx) {
      T l2[N], o2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        l[m] = V(4, c)[m * N2 + p];
        l2[m] = V(5, c)[m * N2 + p];
      }
      mat<T, N>(BS, true, l, o);
      mat<T, N>(BDS, true, l2, o2);
#pragma unroll
      for (int m = 0; m < N; ++m) z[m] -= o[m] + o2[m];
    }
#pragma unroll
    for (int m = 0; m < N; ++m)
      z[m] = valid ? z[m] * inv_diag[cbase + m * N2 + p] : T(0);
    mat<T, N>(ct + L::TT, false, z, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V(0, c)[m * N2 + p] = o[m];
  }
  __syncthreads();  // 7 (3)

  // ---- T7 (lines along 1): T_1
  if (lane) {
    T l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(0, c)[node<N>(1, p, m)];
    mat<T, N>(ct + L::TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V(4, c)[node<N>(1, p, m)] = o[m];
  }
  __syncthreads();  // 8 (4)

  // ---- T8 (lines along 2): T_2 and the update; out may alias x_old (this
  // thread alone reads and writes each of its elements)
  if (valid) {
    T l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(4, c)[p * N + m];
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
// takes 4,584 B at n = 9 and 5,552 B at n = 10
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

// y = A x (mode 0) or out = b - A x (mode 1) at n = 2..10 points an axis
// (n = 9 in double: dg_pencil_high.cu)
template <typename T>
int dispatch_apply(int mode, const T* x, const T* b, const T* tab, T* out,
                   int C0, int C1, int C2, int n, int colloc, void* stream,
                   int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1 || (mode != APPLY && mode != RESIDUAL))
    return (int)cudaErrorInvalidValue;
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

}  // namespace
