// The SIP-DG pencil kernels at n = 9, 10 points an axis (p = 8, 9) for
// Hopper (sm_90a): dg_pencil.cuh's pencils with in-place phases, so that a
// cell holds 4 n^3 + 22 n^2 values in shared memory instead of 7 n^3 +
// 34 n^2, and two blocks share an SM in double too.  Three modes:
//   apply     y = A x            dg_high_apply_kernel<9, false> (double)
//   residual  out = b - A x      dg_high_apply_kernel<9, true> (double)
//   cheb      out = x + f1 (x - x_old) + f2 T3 diag^-1 T3^T (b - A x)
//                                dg_high_cheb_kernel<N>, n = 9, 10 (float)
// They replace, at these degrees, the TPU kernels of
// multigrid_tpu/ops/pallas_dg.py that dg_pencil.cuh's template replaces
// below them: K9 PallasDGOzaki._kernel (:639, dg_apply<double>; JAX runs
// XLA there above p = 4) at p = 8 and K8 PallasDGSP.cheb_fused (:490,
// dg_cheb<float>) at p = 8, 9; K7 (:438, dg_apply<float>) and K9 at p = 9
// keep the template, which no variant of this body beat there without
// spilling (PERF.md §6, PR 21).  dg_pencil.cuh's note says what A is, and
// its entries (dg_apply_f64, dg_cheb_f32) call these.
//
// Why a design of their own: at n = 9, 10 the template's 7 n^3 + 34 n^2
// values a cell let a block of 3 / 2 cells fill an SM in double (188,568 /
// 166,400 bytes): one block of 8 / 7 warps, whose barriers nothing else on
// the SM covers.
//
// Design.
//   * The pencils are the template's (K = pencil<N, MODE>() cells along x,
//     n^2 threads a cell, a pencil a block), and every value is formed by
//     the template's expression in the template's order: the outputs are
//     its bits.
//   * Each phase turns its lines in place (a thread reads and writes only
//     its own lines within a phase): 4 volume buffers a cell where the
//     template keeps 7.  The face stages and the fluxes run in place in
//     three buffers a face (the neighbour's P, Q; then S P, D S P, S Q;
//     then u+, gn+; then the fluxes t_val, t_gr): 22 n^2 face values a cell
//     (with the x traces) where the template keeps 34.  A block of 3 cells
//     at n = 9 takes 56,376 bytes in float, 112,752 in double (two blocks
//     an SM in both types); 2 cells at n = 10, 49,600 in float.
//   * The launch bound names those two blocks, which caps the registers
//     at 128 a thread.  The volume term acc_e = w3 sum_f Gsym[e][f] g_f is
//     formed in T4 from the gradients in shared memory, its product by w3
//     unfused as across the template's phase boundary (the template forms
//     it in T2 and holds it in registers through T3), T2 stores each array
//     as soon as it is made, face stage 2 loads each column just before its
//     sweeps, and T4 sweeps acc_0 and acc_1 before vacc.
// Phases (line axis), as the template's, barriers between:
//   T0 (0) load x; S_0 x, DS_0 x; neighbour reductions  T1 (1) S_1, DS_1;
//   face stage 1  T2 (2) v, g_0..2, the volume term, the x traces; face
//   stage 2  T3 fluxes  T4 (2) lifts, the back end along 2 (cheb: and
//   T_2^T b)  T5 (1)  T6 (0) the store (apply, residual) or T3^T b - T3^T
//   A x, diag^-1, T_0 (cheb)  T7 (1) T_1  T8 (2) T_2 and the update.
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

constexpr int kHighSmemBlock = 232448;  // bytes of shared memory a block may have

// The block's shared memory, offsets in values of T: four volume buffers
// [4][K][n^3]; the face buffers [K][6 faces][3][n^2]; the x traces
// [2][K][2][n^2]
template <int N, int K>
struct HighLayout {
  static constexpr int N2 = N * N, N3 = N2 * N;
  static constexpr int FS = 4 * K * N3;
  static constexpr int XT = FS + 18 * K * N2;
  static constexpr int SIZE = XT + 4 * K * N2;
};

template <typename T, int N, int MODE>
__host__ __device__ constexpr int high_smem_bytes() {
  return HighLayout<N, pencil<N, MODE>()>::SIZE * (int)sizeof(T);
}

// blocks an SM the launch bound names (ptxas then caps the registers at
// 128 a thread): 2, which the shared memory holds in both types (233,472
// bytes an SM, 1 KB reserved a block); 1 and 3 were slower (PERF.md §6,
// PR 21)
constexpr int kHighBlocks = 2;

// launches by kernel, in dg_high_tile's order: cheb, apply, residual
int g_launches[3] = {0, 0, 0};

// The volume term's product by w3, never fused into an add: the template
// forms acc = (sum_f Gsym[e][f] g_f) w3 in T2 and adds the lifts to it in
// T4, a phase apart, where no product is fused into the add; these kernels
// form it in T4, just before that add
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The pencil of every mode (see the note above).  x may be null only in
// the cheb mode (x = 0: no A x); x_old, inv_diag, f1, f2 are read only
// there, b by the residual and cheb modes.
template <typename T, int N, int MODE>
__device__ __forceinline__ void high_body(
    const T* ct, const T* __restrict__ x, T* out, const T* __restrict__ bvec,
    const T* x_old, const T* __restrict__ inv_diag, T f1, T f2, int C0,
    int C1, int C2, int colloc) {
  using L = Tab<N>;
  constexpr int N2 = N * N, N3 = N2 * N, K = pencil<N, MODE>();
  using LY = HighLayout<N, K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  auto V = [&](int a, int c) { return sm + (a * K + c) * N3; };
  // face f of cell c, buffer a: the neighbour's P, Q (T0); S P, D S P,
  // S Q (T1); u+, gn+ (T2); the fluxes t_val, t_gr (T3)
  auto FS = [&](int a, int c, int f) {
    return sm + LY::FS + ((c * 6 + f) * 3 + a) * N2;
  };
  auto XT = [&](int a, int c, int s) {
    return sm + LY::XT + ((a * K + c) * 2 + s) * N2;
  };

  const int t = threadIdx.x, nt = blockDim.x;
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
          FS(0, c, f)[p] = P;
          FS(1, c, f)[p] = Q;
        }
      }
    }
    __syncthreads();  // 1

    // ---- T1 (lines along 1, in place): S_1 a, DS_1 a, S_1 a'; face stage
    // 1 (rows, in place)
    if (lane) {
      T la[N], lb[N], o[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        la[m] = V(0, c)[node<N>(1, p, m)];
        lb[m] = V(1, c)[node<N>(1, p, m)];
      }
      interp<T, N>(ct + L::S, colloc, la, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(0, c)[node<N>(1, p, m)] = o[m];
      mat<T, N>(ct + L::DS, false, la, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(1, c)[node<N>(1, p, m)] = o[m];
      interp<T, N>(ct + L::S, colloc, lb, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(2, c)[node<N>(1, p, m)] = o[m];
    }
    for (int it = t; it < FACE_ITEMS; it += nt) {
      int cc, f, r;
      face_item(it, cc, f, r);
      if (x0 + cc >= C2 || !has_nb(cc, f)) continue;
      T P[N], Q[N], o[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        P[m] = FS(0, cc, f)[r * N + m];
        Q[m] = FS(1, cc, f)[r * N + m];
      }
      interp<T, N>(ct + L::S, colloc, P, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FS(0, cc, f)[r * N + m] = o[m];
      mat<T, N>(ct + L::DS, false, P, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FS(1, cc, f)[r * N + m] = o[m];
      interp<T, N>(ct + L::S, colloc, Q, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FS(2, cc, f)[r * N + m] = o[m];
    }
    __syncthreads();  // 2

    // ---- T2 (lines along 2, in place): v, g_0..2 and the x traces, each
    // array stored, and its share of the traces summed, as soon as it is
    // made (the template's sums, term by term: at most three lines in
    // registers); face stage 2 (columns, in place)
    if (lane) {
      T l[N], v[N], g[3][N], tr[4][2];
      auto traces = [&](const T* w, int a) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          tr[a][s] = T(0);
#pragma unroll
          for (int m = 0; m < N; ++m) tr[a][s] += ct[L::F + s * N + m] * w[m];
        }
      };
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = V(0, c)[p * N + m];
      interp<T, N>(ct + L::S, colloc, l, v);
      mat<T, N>(ct + L::DS, false, l, g[2]);
      traces(v, 0);
#pragma unroll
      for (int m = 0; m < N; ++m) V(0, c)[p * N + m] = v[m];
      traces(g[2], 3);
#pragma unroll
      for (int m = 0; m < N; ++m) V(3, c)[p * N + m] = g[2][m];
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = V(1, c)[p * N + m];
      interp<T, N>(ct + L::S, colloc, l, g[1]);
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = V(2, c)[p * N + m];
      interp<T, N>(ct + L::S, colloc, l, g[0]);
      traces(g[0], 1);
      traces(g[1], 2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        V(1, c)[p * N + m] = g[0][m];
        V(2, c)[p * N + m] = g[1][m];
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        XT(0, c, s)[p] = tr[0][s];
        XT(1, c, s)[p] = ct[L::GVEC + 6] * tr[1][s] +
                         ct[L::GVEC + 7] * tr[2][s] +
                         ct[L::GVEC + 8] * tr[3][s];
      }
    }
    for (int it = t; it < FACE_ITEMS; it += nt) {
      int cc, f, r;
      face_item(it, cc, f, r);
      if (x0 + cc >= C2 || !has_nb(cc, f)) continue;
      const int d = f >> 1;
      const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
      const T sign = (f & 1) ? T(1) : T(-1);
      // each input column loaded just before its sweeps and retired after
      // them: at most five columns in registers
      T A[N], uu[N], gq[N], ge1[N], ge2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) A[m] = FS(0, cc, f)[m * N + r];
      interp<T, N>(ct + L::S, colloc, A, uu);
      mat<T, N>(ct + L::DS, false, A, ge1);
#pragma unroll
      for (int m = 0; m < N; ++m) A[m] = FS(2, cc, f)[m * N + r];
      interp<T, N>(ct + L::S, colloc, A, gq);
#pragma unroll
      for (int m = 0; m < N; ++m) A[m] = FS(1, cc, f)[m * N + r];
      interp<T, N>(ct + L::S, colloc, A, ge2);
      const T gd = pick<9>(ct + L::GVEC, 3 * d + d);
      const T g1 = pick<9>(ct + L::GVEC, 3 * d + e1);
      const T g2 = pick<9>(ct + L::GVEC, 3 * d + e2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        FS(0, cc, f)[m * N + r] = uu[m];
        FS(1, cc, f)[m * N + r] =
            sign * (gd * gq[m] + g1 * ge1[m] + g2 * ge2[m]);
      }
    }
    __syncthreads();  // 3

    // ---- T3: fluxes, each written over the u+, gn+ it reads; +-z and +-y
    // from lines through this face point
    if (valid) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        T u[2], tr[3][2];
        {
          T v[N], g[3][N];
#pragma unroll
          for (int m = 0; m < N; ++m) {
            const int o = node<N>(d, p, m);
            v[m] = V(0, c)[o];
#pragma unroll
            for (int e = 0; e < 3; ++e) g[e][m] = V(1 + e, c)[o];
          }
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            T u_m = T(0), t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll
            for (int m = 0; m < N; ++m) {
              const T fs = ct[L::F + s * N + m];
              u_m += fs * v[m];
              t0 += fs * g[0][m];
              t1 += fs * g[1][m];
              t2 += fs * g[2][m];
            }
            u[s] = u_m;
            tr[0][s] = t0;
            tr[1][s] = t1;
            tr[2][s] = t2;
          }
        }
        const T wf = ct[L::JXW + d] * wq1 * wq2;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int f = 2 * d + s;
          const T sign = s ? T(1) : T(-1);
          const T u_m = u[s];
          const T gn_m = sign * (ct[L::GVEC + 3 * d] * tr[0][s] +
                                 ct[L::GVEC + 3 * d + 1] * tr[1][s] +
                                 ct[L::GVEC + 3 * d + 2] * tr[2][s]);
          T u_p = -u_m, gn_p = gn_m;  // Dirichlet mirror
          if (has_nb(c, f)) {
            u_p = FS(0, c, f)[p];
            gn_p = FS(1, c, f)[p];
          }
          flux(u_m, gn_m, u_p, gn_p, ct[L::SIGMA + d], wf, sign,
               FS(0, c, f)[p], FS(1, c, f)[p]);
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
          u_p = FS(0, c, f)[p];
          gn_p = FS(1, c, f)[p];
        }
        flux(u_m, gn_m, u_p, gn_p, sig, wf, sign, FS(0, c, f)[p],
             FS(1, c, f)[p]);
      };
      if (c == 0) {
        own_view(0);
      } else {
        // the face between cells c - 1 (minus) and c (plus), once
        T tv, tg;
        flux(XT(0, c - 1, 1)[p], XT(1, c - 1, 1)[p], XT(0, c, 0)[p],
             XT(1, c, 0)[p], sig, wf, T(1), tv, tg);
        FS(0, c - 1, 5)[p] = tv;
        FS(1, c - 1, 5)[p] = tg;
        FS(0, c, 4)[p] = -tv;
        FS(1, c, 4)[p] = tg;
      }
      if (c == c_last) own_view(1);
    }
    __syncthreads();  // 4
  }

  // ---- T4 (lines along 2, through (i, j) = p, in place): lifts, then
  // BS^T_2 and BDS^T_2; for cheb also T_2^T b
  if (lane) {
    T o[N];
    if (hx) {
      // the volume term w3 sum_f Gsym[e][f] g_f from the gradients T2 left
      T acc[3][N], vacc[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const T w3 = wq1 * wq2 * ct[L::W + m];
        const T g0 = V(1, c)[p * N + m], g1 = V(2, c)[p * N + m],
                g2 = V(3, c)[p * N + m];
#pragma unroll
        for (int e = 0; e < 3; ++e)
          acc[e][m] = mul_rn(ct[L::GSYM + 3 * e] * g0 +
                                 ct[L::GSYM + 3 * e + 1] * g1 +
                                 ct[L::GSYM + 3 * e + 2] * g2,
                             w3);
      }
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
          vacc[m] += fi[s] * FS(0, c, s)[q2 * N + m] +
                     fj[s] * FS(0, c, 2 + s)[q1 * N + m] +
                     fk * FS(0, c, 4 + s)[p];
          lz += fi[s] * FS(1, c, s)[q2 * N + m];
          ly += fj[s] * FS(1, c, 2 + s)[q1 * N + m];
          lx += fk * FS(1, c, 4 + s)[p];
        }
#pragma unroll
        for (int e = 0; e < 3; ++e)
          acc[e][m] += ct[L::GVEC + e] * lz + ct[L::GVEC + 3 + e] * ly +
                       ct[L::GVEC + 6 + e] * lx;
      }
      // acc_0 and acc_1 first, so that each retires before vacc is swept
      interp<T, N>(BS, bcol, acc[0], o, true);
#pragma unroll
      for (int m = 0; m < N; ++m) V(2, c)[p * N + m] = o[m];
      interp<T, N>(BS, bcol, acc[1], o, true);
#pragma unroll
      for (int m = 0; m < N; ++m) V(1, c)[p * N + m] = o[m];
      T y2[N];
      interp<T, N>(BS, bcol, vacc, o, true);
      mat<T, N>(BDS, true, acc[2], y2);
#pragma unroll
      for (int m = 0; m < N; ++m) V(0, c)[p * N + m] = o[m] + y2[m];
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

  // ---- T5 (lines along 1, in place)
  if (lane) {
    T l[N], o[N];
    if constexpr (MODE == CHEB) {
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = V(3, c)[node<N>(1, p, m)];
      mat<T, N>(ct + L::TT, true, l, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(3, c)[node<N>(1, p, m)] = o[m];
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
        V(0, c)[node<N>(1, p, m)] = o[m] + o2[m];
        l[m] = V(2, c)[node<N>(1, p, m)];
      }
      interp<T, N>(BS, bcol, l, o, true);
#pragma unroll
      for (int m = 0; m < N; ++m) V(1, c)[node<N>(1, p, m)] = o[m];
    }
  }
  __syncthreads();  // 6 (2)

  if constexpr (MODE != CHEB) {
    // ---- T6 (lines along 0): y = BS^T_0 V0 + BDS^T_0 V1; out = y or b - y
    if (valid) {
      T l[N], l2[N], o[N], o2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        l[m] = V(0, c)[m * N2 + p];
        l2[m] = V(1, c)[m * N2 + p];
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

  // ---- T6 (lines along 0, in place): T3^T b - T3^T A x, * inv_diag, T_0
  if (lane) {
    T l[N], z[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(3, c)[m * N2 + p];
    mat<T, N>(ct + L::TT, true, l, z);
    if (hx) {
      T l2[N], o2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        l[m] = V(0, c)[m * N2 + p];
        l2[m] = V(1, c)[m * N2 + p];
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

  // ---- T7 (lines along 1, in place): T_1
  if (lane) {
    T l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(0, c)[node<N>(1, p, m)];
    mat<T, N>(ct + L::TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V(0, c)[node<N>(1, p, m)] = o[m];
  }
  __syncthreads();  // 8 (4)

  // ---- T8 (lines along 2): T_2 and the update; out may alias x_old (this
  // thread alone reads and writes each of its elements)
  if (valid) {
    T l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(0, c)[p * N + m];
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

template <int N, bool RESID>
__global__ void __launch_bounds__(threads<N, APPLY>(), kHighBlocks)
dg_high_apply_kernel(const __grid_constant__ TabArg<double, N> tab,
                     const double* __restrict__ x, double* __restrict__ out,
                     const double* __restrict__ b, int C0, int C1, int C2,
                     int colloc) {
  high_body<double, N, RESID ? RESIDUAL : APPLY>(tab.v, x, out, b, nullptr,
                                                 nullptr, 0.0, 0.0, C0, C1,
                                                 C2, colloc);
}

template <int N>
__global__ void __launch_bounds__(threads<N, CHEB>(), kHighBlocks)
dg_high_cheb_kernel(const __grid_constant__ TabArg<float, N> tab,
                    const float* __restrict__ x, float* out,
                    const float* __restrict__ bvec, const float* x_old,
                    const float* __restrict__ inv_diag, float f1, float f2,
                    int C0, int C1, int C2, int colloc) {
  high_body<float, N, CHEB>(tab.v, x, out, bvec, x_old, inv_diag, f1, f2,
                            C0, C1, C2, colloc);
}

// ---- launches

// A grid of pencils (one block each) and, at the first launch of a kernel,
// its dynamic shared-memory limit raised to what it needs
template <typename Kernel>
int high_grid(Kernel kernel, bool& configured, int bytes, int C0, int C1,
              int C2, int K, unsigned& blocks) {
  if (bytes > kHighSmemBlock) return (int)cudaErrorInvalidValue;
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

template <int N, bool RESID>
int launch_high_apply(const double* x, const double* b, const double* tab,
                      double* out, int C0, int C1, int C2, int colloc,
                      cudaStream_t stream) {
  static bool configured = false;
  constexpr int bytes = high_smem_bytes<double, N, APPLY>();
  unsigned blocks = 0;
  const int err = high_grid(dg_high_apply_kernel<N, RESID>, configured,
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
  const int err = high_grid(dg_high_cheb_kernel<N>, configured, bytes, C0,
                            C1, C2, pencil<N, CHEB>(), blocks);
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

// The tile of one kernel: cells a pencil, shared bytes, threads, blocks an
// SM (the occupancy calculator, after the kernel's shared memory is
// allowed), registers, local bytes
template <typename T, int N, int MODE, typename Kernel>
int high_tile(Kernel kernel, int* out) {
  constexpr int bytes = high_smem_bytes<T, N, MODE>();
  constexpr int nthreads = threads<N, MODE>();
  int per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        nthreads, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int v[6] = {pencil<N, MODE>(), bytes, nthreads, per_sm,
                    attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
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
