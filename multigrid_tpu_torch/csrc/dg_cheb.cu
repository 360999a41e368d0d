// The SIP-DG Chebyshev step for Hopper (sm_90a), in float32:
//   out = x + f1 (x - x_old) + f2 T3 diag^-1 T3^T (b - A x)
// dg_cheb<float> replaces the TPU kernel
//   K8  multigrid_tpu/ops/pallas_dg.py  PallasDGSP.cheb_fused -> _kernel_cheb
// on the natural block layout [C0, C1, C2, n, n, n] (x fastest).  A is the
// SIP-DG operator of dg_apply.cu (its header states the algebra); the
// face terms follow ops/dg_face.py, the CPU mirror of this kernel: each face
// inside a block is evaluated once and lifted into both of its cells.
//
// Design.  A block takes a pencil of K cells along x (K n^3 contiguous
// floats; the last pencil of a row may be ragged), n^2 threads a cell.  In
// each phase a thread owns one line of n nodes of its cell in registers,
// along axis 0 (i, stride n^2), 1 (j) or 2 (k), and every 1-D contraction
// runs along the owned line in registers; between phases the lines turn
// through shared memory (one barrier), so each contraction reads each
// value once.  The tables (read on the host, from the table argument) are
// a __grid_constant__ kernel parameter, so they enter the FMAs as constant
// operands with no load and no copy before the launch.
// The back end is folded into the preconditioner:
//   T3^T A x = (S T)3^T (vacc + sum_e D_e^T acc_e),
// so the step forms T3^T b - T3^T A x with the tables S T and D S T and
// never forms A x in node space.  Faces:
//   * +-z, +-y, and x at the pencil's two ends: the neighbour's block is
//     reduced along the normal (b = f S, c = f D S) and swept over the face
//     (two stages, one face row or column a thread), or the Dirichlet
//     mirror u+ = -u-, gn+ = gn- where the face is on the domain boundary
//     (never at a pencil end inside it);
//   * x faces between two cells of the pencil: one thread per face point
//     forms the jump u- - u+ from both cells' own traces (before any
//     scaling: f32 cancels some 1e5-fold on smooth iterates), then one
//     flux_val / flux_grad pair, lifted with + into the lower cell and with
//     -/+ into the upper one.
// Phases (line axis), separated by block barriers, 8 in all with x and 4
// with x = 0, shared by the K cells of the block:
//   T0 (0) load x; S_0 x, DS_0 x; neighbour reductions
//   T1 (1) S_1, DS_1; face stage 1     T2 (2) v, g_0..2, the volume term
//   (kept in registers), the x traces; face stage 2
//   T3 fluxes: +-z (lines along 0), +-y (along 1), x (face points)
//   T4 (2) lifts, (ST)^T_2 / (DST)^T_2; load b, T_2^T b
//   T5 (1) the same along 1    T6 (0) along 0, - , * inv_diag, T_0
//   T7 (1) T_1    T8 (2) T_2, load x and x_old, the update.
// Shared memory: 7 n^3 volume and 34 n^2 face floats a cell, in two sets
// (even and odd phases) so that a buffer read in one phase is written again
// only after the next barrier.
//
// What bounds it: 5 float streams (x, b, x_old, inv_diag in, out) of
// necessary traffic, plus the +-y/+-z neighbour blocks (mostly L2 hits);
// about 200 flop a dof for A and 12 n + 6 for the step.  By that count the
// card's HBM binds; the design's concern is the shared-memory pipe (each
// contraction reads its line once), issue slots and barriers.
//
// Degrees 1 to 7 (n = 2..8), one instantiation each; the three kinds via
// the tables (S = I for the Gauss kind, whose flag skips the S products).
// The entry reads the table (float32, ops/dg_kernel.py:dg_tables) from host
// memory, writes the number of kernels it launched (1) to *launched and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_tab.cuh"

namespace {

template <int N>
struct TabArg {
  float v[Tab<N>::SIZE];
};

// cells per block (pencil length along x); DG_CHEB_PENCIL sets it for
// every degree when tuning (experiments/time_dg_cheb.py --pencil)
template <int N>
__host__ __device__ constexpr int pencil() {
#ifdef DG_CHEB_PENCIL
  return DG_CHEB_PENCIL;
#else
  return N == 2 ? 16 : N == 3 ? 14 : N == 4 ? 8 : N == 5 ? 8 : 4;
#endif
}

template <int N>
__host__ __device__ constexpr int threads() {
  return ((pencil<N>() * N * N + 31) / 32) * 32;
}

template <int N>
__host__ __device__ constexpr int smem_floats() {
  return pencil<N>() * (7 * N * N * N + 34 * N * N);
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
__device__ __forceinline__ void flux(float u_m, float gn_m, float u_p,
                                     float gn_p, float sigma, float wf,
                                     float sign, float& tv, float& tg) {
  const float jump = u_m - u_p;  // before any scaling
  tv = (sigma * jump - 0.5f * (gn_m + gn_p)) * wf;
  tg = -0.5f * jump * wf * sign;
}

// out[r] = sum_m M[r][m] in[m] (tr: M[m][r])
template <int N>
__device__ __forceinline__ void mat(const float* M, bool tr, const float* in,
                                    float* out) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float a = 0.f;
#pragma unroll
    for (int m = 0; m < N; ++m) a += M[tr ? m * N + r : r * N + m] * in[m];
    out[r] = a;
  }
}

// out = S in, or out = in for the Gauss kind (S = I)
template <int N>
__device__ __forceinline__ void interp(const float* S, int colloc,
                                       const float* in, float* out) {
  if (colloc) {
#pragma unroll
    for (int m = 0; m < N; ++m) out[m] = in[m];
  } else {
    mat<N>(S, false, in, out);
  }
}

// v[i] for a thread-dependent i < M, from static indices only
template <int M>
__device__ __forceinline__ float pick(const float* v, int i) {
  float r = v[0];
#pragma unroll
  for (int m = 1; m < M; ++m)
    if (i == m) r = v[m];
  return r;
}

template <int N>
__global__ void __launch_bounds__(threads<N>())
dg_cheb_kernel(const __grid_constant__ TabArg<N> tab,
               const float* __restrict__ x, float* out,
               const float* __restrict__ bvec, const float* x_old,
               const float* __restrict__ inv_diag, float f1, float f2, int C0,
               int C1, int C2, int colloc) {
  using L = Tab<N>;
  constexpr int N2 = N * N, N3 = N * N * N, K = pencil<N>();
  const float* ct = tab.v;
  extern __shared__ __align__(16) float smem[];
  // volume [7][K][N3]: even V0..V3, odd V4..V6; faces, even: FE0, FE1
  // [K][6][N2] (the neighbour's P, Q in T0, its u+, gn+ in T2) and the x
  // traces XT0, XT1 [K][2][N2]; odd: FO0..FO2 [K][6][N2] (face stage 1 in
  // T1, the fluxes t_val, t_gr in T3)
  float* vol = smem;
  float* fe = vol + 7 * K * N3;
  float* fo = fe + 16 * K * N2;
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
  const float wq1 = pick<N>(ct + L::W, q1), wq2 = pick<N>(ct + L::W, q2);
  const bool hx = x != nullptr;
  float acc[3][N];

  if (hx) {
    // ---- T0 (lines along 0): S_0 x, DS_0 x; neighbour reductions
    if (lane) {
      float u[N], a[N], a2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) u[m] = valid ? x[cbase + m * N2 + p] : 0.f;
      interp<N>(ct + L::S, colloc, u, a);
      mat<N>(ct + L::DS, false, u, a2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        V(0, c)[m * N2 + p] = a[m];
        V(1, c)[m * N2 + p] = a2[m];
      }
    }
    if (valid) {
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        if (!has_nb(c, f)) continue;
        const int d = f >> 1, s = f & 1;
        const float* nb = x + cbase + (s ? nb_off[d] : -nb_off[d]);
        float P = 0.f, Q = 0.f;
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const float w = nb[node<N>(d, p, m)];
          P += ct[L::B + (1 - s) * N + m] * w;
          Q += ct[L::C + (1 - s) * N + m] * w;
        }
        FE(0, c, f)[p] = P;
        FE(1, c, f)[p] = Q;
      }
    }
    __syncthreads();  // 1

    // ---- T1 (lines along 1): S_1 a, DS_1 a, S_1 a'; face stage 1 (rows)
    if (lane) {
      float la[N], lb[N], o[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        la[m] = V(0, c)[node<N>(1, p, m)];
        lb[m] = V(1, c)[node<N>(1, p, m)];
      }
      interp<N>(ct + L::S, colloc, la, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(4, c)[node<N>(1, p, m)] = o[m];
      mat<N>(ct + L::DS, false, la, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(5, c)[node<N>(1, p, m)] = o[m];
      interp<N>(ct + L::S, colloc, lb, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(6, c)[node<N>(1, p, m)] = o[m];
    }
    for (int it = t; it < K * 6 * N; it += blockDim.x) {
      const int cc = it / (6 * N), f = (it / N) % 6, r = it % N;
      if (x0 + cc >= C2 || !has_nb(cc, f)) continue;
      float P[N], Q[N], o[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        P[m] = FE(0, cc, f)[r * N + m];
        Q[m] = FE(1, cc, f)[r * N + m];
      }
      interp<N>(ct + L::S, colloc, P, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FO(0, cc, f)[r * N + m] = o[m];
      mat<N>(ct + L::DS, false, P, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FO(1, cc, f)[r * N + m] = o[m];
      interp<N>(ct + L::S, colloc, Q, o);
#pragma unroll
      for (int m = 0; m < N; ++m) FO(2, cc, f)[r * N + m] = o[m];
    }
    __syncthreads();  // 2

    // ---- T2 (lines along 2): v, g_0..2, the volume term, the x traces;
    // face stage 2 (columns)
    if (lane) {
      float l[N], v[N], g[3][N];
#pragma unroll
      for (int m = 0; m < N; ++m) l[m] = V(4, c)[p * N + m];
      interp<N>(ct + L::S, colloc, l, v);
      mat<N>(ct + L::DS, false, l, g[2]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 0; m < N; ++m) l[m] = V(6 - e, c)[p * N + m];
        interp<N>(ct + L::S, colloc, l, g[e]);
      }
#pragma unroll
      for (int m = 0; m < N; ++m) {
        V(0, c)[p * N + m] = v[m];
        const float w3 = wq1 * wq2 * ct[L::W + m];
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
        float tu = 0.f, t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const float fs = ct[L::F + s * N + m];
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
    for (int it = t; it < K * 6 * N; it += blockDim.x) {
      const int cc = it / (6 * N), f = (it / N) % 6, r = it % N;
      if (x0 + cc >= C2 || !has_nb(cc, f)) continue;
      const int d = f >> 1;
      const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
      const float sign = (f & 1) ? 1.f : -1.f;
      float A1[N], A2[N], A3[N], uu[N], gq[N], ge1[N], ge2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        A1[m] = FO(0, cc, f)[m * N + r];
        A2[m] = FO(1, cc, f)[m * N + r];
        A3[m] = FO(2, cc, f)[m * N + r];
      }
      interp<N>(ct + L::S, colloc, A1, uu);
      interp<N>(ct + L::S, colloc, A3, gq);
      interp<N>(ct + L::S, colloc, A2, ge2);
      mat<N>(ct + L::DS, false, A1, ge1);
      const float gd = pick<9>(ct + L::GVEC, 3 * d + d);
      const float g1 = pick<9>(ct + L::GVEC, 3 * d + e1);
      const float g2 = pick<9>(ct + L::GVEC, 3 * d + e2);
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
        float v[N], g[3][N];
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const int o = node<N>(d, p, m);
          v[m] = V(0, c)[o];
#pragma unroll
          for (int e = 0; e < 3; ++e) g[e][m] = V(1 + e, c)[o];
        }
        const float wf = ct[L::JXW + d] * wq1 * wq2;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int f = 2 * d + s;
          const float sign = s ? 1.f : -1.f;
          float u_m = 0.f, t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
          for (int m = 0; m < N; ++m) {
            const float fs = ct[L::F + s * N + m];
            u_m += fs * v[m];
            t0 += fs * g[0][m];
            t1 += fs * g[1][m];
            t2 += fs * g[2][m];
          }
          const float gn_m = sign * (ct[L::GVEC + 3 * d] * t0 +
                                     ct[L::GVEC + 3 * d + 1] * t1 +
                                     ct[L::GVEC + 3 * d + 2] * t2);
          float u_p = -u_m, gn_p = gn_m;  // Dirichlet mirror
          if (has_nb(c, f)) {
            u_p = FE(0, c, f)[p];
            gn_p = FE(1, c, f)[p];
          }
          flux(u_m, gn_m, u_p, gn_p, ct[L::SIGMA + d], wf, sign,
               FO(0, c, f)[p], FO(1, c, f)[p]);
        }
      }
      // x faces at point (i, j) = p
      const float wf = ct[L::JXW + 2] * wq1 * wq2;
      const float sig = ct[L::SIGMA + 2];
      auto own_view = [&](int s) {
        const int f = 4 + s;
        const float sign = s ? 1.f : -1.f;
        const float u_m = XT(0, c, s)[p], gn_m = sign * XT(1, c, s)[p];
        float u_p = -u_m, gn_p = gn_m;
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
        float tv, tg;
        flux(XT(0, c - 1, 1)[p], XT(1, c - 1, 1)[p], XT(0, c, 0)[p],
             XT(1, c, 0)[p], sig, wf, 1.f, tv, tg);
        FO(0, c - 1, 5)[p] = tv;
        FO(1, c - 1, 5)[p] = tg;
        FO(0, c, 4)[p] = -tv;
        FO(1, c, 4)[p] = tg;
      }
      if (c == c_last) own_view(1);
    }
    __syncthreads();  // 4
  }

  // ---- T4 (lines along 2, through (i, j) = p): lifts, then (ST)^T_2 and
  // (DST)^T_2; b and T_2^T b
  if (lane) {
    float o[N];
    if (hx) {
      float vacc[N];
      const float fi[2] = {pick<N>(ct + L::F, q1), pick<N>(ct + L::F + N, q1)};
      const float fj[2] = {pick<N>(ct + L::F, q2), pick<N>(ct + L::F + N, q2)};
#pragma unroll
      for (int m = 0; m < N; ++m) {
        // node (i, j, k = m): z face point (j, k), y face point (i, k)
        float lz = 0.f, ly = 0.f, lx = 0.f;
        vacc[m] = 0.f;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float fk = ct[L::F + s * N + m];
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
      float y2[N];
      mat<N>(ct + L::ST, true, vacc, o);
      mat<N>(ct + L::DST, true, acc[2], y2);
#pragma unroll
      for (int m = 0; m < N; ++m) V(0, c)[p * N + m] = o[m] + y2[m];
      mat<N>(ct + L::ST, true, acc[1], o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(1, c)[p * N + m] = o[m];
      mat<N>(ct + L::ST, true, acc[0], o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(2, c)[p * N + m] = o[m];
    }
    float bl[N];
#pragma unroll
    for (int m = 0; m < N; ++m) bl[m] = valid ? bvec[cbase + p * N + m] : 0.f;
    mat<N>(ct + L::TT, true, bl, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V(3, c)[p * N + m] = o[m];
  }
  __syncthreads();  // 5 (1 without x)

  // ---- T5 (lines along 1)
  if (lane) {
    float l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(3, c)[node<N>(1, p, m)];
    mat<N>(ct + L::TT, true, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V(6, c)[node<N>(1, p, m)] = o[m];
    if (hx) {
      float l2[N], o2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        l[m] = V(0, c)[node<N>(1, p, m)];
        l2[m] = V(1, c)[node<N>(1, p, m)];
      }
      mat<N>(ct + L::ST, true, l, o);
      mat<N>(ct + L::DST, true, l2, o2);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        V(4, c)[node<N>(1, p, m)] = o[m] + o2[m];
        l[m] = V(2, c)[node<N>(1, p, m)];
      }
      mat<N>(ct + L::ST, true, l, o);
#pragma unroll
      for (int m = 0; m < N; ++m) V(5, c)[node<N>(1, p, m)] = o[m];
    }
  }
  __syncthreads();  // 6 (2)

  // ---- T6 (lines along 0): T3^T b - T3^T A x, * inv_diag, T_0
  if (lane) {
    float l[N], z[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(6, c)[m * N2 + p];
    mat<N>(ct + L::TT, true, l, z);
    if (hx) {
      float l2[N], o2[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        l[m] = V(4, c)[m * N2 + p];
        l2[m] = V(5, c)[m * N2 + p];
      }
      mat<N>(ct + L::ST, true, l, o);
      mat<N>(ct + L::DST, true, l2, o2);
#pragma unroll
      for (int m = 0; m < N; ++m) z[m] -= o[m] + o2[m];
    }
#pragma unroll
    for (int m = 0; m < N; ++m)
      z[m] = valid ? z[m] * inv_diag[cbase + m * N2 + p] : 0.f;
    mat<N>(ct + L::TT, false, z, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V(0, c)[m * N2 + p] = o[m];
  }
  __syncthreads();  // 7 (3)

  // ---- T7 (lines along 1): T_1
  if (lane) {
    float l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(0, c)[node<N>(1, p, m)];
    mat<N>(ct + L::TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) V(4, c)[node<N>(1, p, m)] = o[m];
  }
  __syncthreads();  // 8 (4)

  // ---- T8 (lines along 2): T_2 and the update; out may alias x_old (this
  // thread alone reads and writes each of its elements)
  if (valid) {
    float l[N], o[N];
#pragma unroll
    for (int m = 0; m < N; ++m) l[m] = V(4, c)[p * N + m];
    mat<N>(ct + L::TT, false, l, o);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int64_t gi = cbase + p * N + m;
      const float xv = hx ? x[gi] : 0.f;
      const float xo = x_old != nullptr ? x_old[gi] : 0.f;
      out[gi] = xv + f1 * (xv - xo) + f2 * o[m];
    }
  }
}

template <int N>
int launch(const float* x, const float* tab, float* out, const float* b,
           const float* x_old, const float* inv_diag, double f1, double f2,
           int C0, int C1, int C2, int colloc, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats<N>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dg_cheb_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long blocks =
      (long long)C0 * C1 * ((C2 + pencil<N>() - 1) / pencil<N>());
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  TabArg<N> targ;
  for (int i = 0; i < Tab<N>::SIZE; ++i) targ.v[i] = tab[i];
  dg_cheb_kernel<N><<<(unsigned)blocks, threads<N>(), smem, stream>>>(
      targ, x, out, b, x_old, inv_diag, (float)f1, (float)f2, C0, C1, C2,
      colloc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dg_cheb_f32(const float* b, const float* x, const float* x_old,
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
    err = launch<NN>(x, tab, out, b, x_old, inv_diag, f1, f2, C0, C1, C2,  \
                     colloc, st);                                           \
    break;
    CHEB_CASE(2)
    CHEB_CASE(3)
    CHEB_CASE(4)
    CHEB_CASE(5)
    CHEB_CASE(6)
    CHEB_CASE(7)
    CHEB_CASE(8)
#undef CHEB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err == 0) *launched = 1;
  return err;
}
