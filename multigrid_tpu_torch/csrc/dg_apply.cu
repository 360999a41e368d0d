// SIP-DG operator kernel for Hopper (sm_90a): y = A x on the DG block
// layout.  (The Chebyshev step that fuses A x with the transformed-Jacobi
// preconditioner is csrc/dg_cheb.cu.)
//
// dg_apply<T> replaces the TPU kernels
//   K9  multigrid_tpu/ops/pallas_dg.py  PallasDGOzaki._kernel  (f64 A x on
//       f32 hi/lo pairs and 7 x 7-bit bf16 limbs, p <= 4), T = double here;
//   K7  multigrid_tpu/ops/pallas_dg.py  PallasDGSP._kernel     (f32 A x on
//       3 x 8-bit limbs), T = float here.
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
//   jump = u- - u+ (formed before any scaling: on smooth iterates sigma u-
//   and sigma u+ cancel some 1e5-fold, and scaling first loses f32);
//   t_val = sigma_d jump - (gn- + gn+)/2 lifted into v's slot and
//   t_gr = -jump/2 lifted into acc_e with gvec_d[e];
//   y = S^T (vacc + sum_e D_e^T acc_e).
// The neighbour's traces are reduced first along the face normal with the
// end-value and end-derivative rows of its basis (b = f S, c = f D S),
// then swept over the face with S and D S: about as many flops again as
// the own cell's sweeps, and no second pass over memory.
//
// Design: one thread block per cell, one thread per cell node (n^3 rounded
// up to a warp).  The block stages its own values and its six neighbours'
// blocks (each a contiguous n^3 run, so the loads are coalesced) in shared
// memory, together with the 1-D tables; every stage is a 1-D contraction
// of length n out of shared memory.  Each block writes only its own output
// block, so there are no atomics, no parity launches, and the result is
// the same from run to run.  Degrees 1 to 7 (n = 2..8) are compiled, one
// instantiation each.
//
// What bounds it: at p = 4 about 200 flop per dof by the algorithm's count
// (utils/perf_model.dg_matvec_model) against 2 x sizeof(T) bytes per dof
// of necessary traffic, so on an H100 the f64 kernel sits near the ridge of
// the fp64 rate and the bandwidth, the f32 one below the f32 ridge.  The
// design spends its time on block barriers (about a dozen per cell),
// shared-memory traffic of the 1-D contractions and the recomputation of
// neighbour traces; dg_cheb.cu shows the way out (several cells per block,
// register columns, each in-block face once).
//
// Every entry point writes the number of kernels it launched (1) to
// *launched and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_tab.cuh"

namespace {

template <int N>
constexpr int smem_elems() {
  // tables, two n^3 buffers, three gradients, six neighbour blocks, seven
  // face-plane arrays of 6 n^2
  return Tab<N>::SIZE + 2 * N * N * N + 3 * N * N * N + 6 * N * N * N +
         7 * 6 * N * N;
}

__device__ __forceinline__ int axis_stride(int a, int N) {
  return a == 0 ? N * N : (a == 1 ? N : 1);
}

// one point of a 1-D contraction along the axis of stride `stride`:
// sum_m M[idx][m] in[.. m ..] (or M[m][idx] when tr)
template <typename T, int N>
__device__ __forceinline__ T line(const T* M, bool tr, const T* in, int t,
                                  int stride) {
  const int idx = (t / stride) % N;
  const int base = t - idx * stride;
  T acc = T(0);
#pragma unroll
  for (int m = 0; m < N; ++m)
    acc += (tr ? M[m * N + idx] : M[idx * N + m]) * in[base + m * stride];
  return acc;
}

// in-place tensor sweep of M along axes 0, 1, 2: a -> b -> a -> b; the
// result is in b (as the JAX _sweep, axis 0 first)
template <typename T, int N>
__device__ void sweep3(const T* M, bool tr, T* a, T* b, int t) {
  constexpr int N3 = N * N * N;
  if (t < N3) b[t] = line<T, N>(M, tr, a, t, N * N);
  __syncthreads();
  if (t < N3) a[t] = line<T, N>(M, tr, b, t, N);
  __syncthreads();
  if (t < N3) b[t] = line<T, N>(M, tr, a, t, 1);
  __syncthreads();
}

template <int N>
constexpr int block_threads() {
  return ((N * N * N + 31) / 32) * 32;
}

template <typename T, int N>
__global__ void __launch_bounds__(block_threads<N>())
dg_kernel(const T* __restrict__ x, const T* __restrict__ tab_g,
          T* __restrict__ out, int C0, int C1, int C2, int colloc) {
  using L = Tab<N>;
  constexpr int N2 = N * N, N3 = N * N * N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  T* su = tab + L::SIZE;    // own u, later y
  T* sw = su + N3;          // sweep scratch
  T* sg = sw + N3;          // g_0..2, later acc_0..2
  T* snb = sg + 3 * N3;     // neighbour blocks, one per face
  T* tu = snb + 6 * N3;     // own value traces, later t_val * wf
  T* tg = tu + 6 * N2;      // own gn traces, later t_gr * wf * sign
  T* pP = tg + 6 * N2;      // neighbour: f .d u (basis end values)
  T* pQ = pP + 6 * N2;      // neighbour: end derivatives
  T* a1 = pQ + 6 * N2;      // S along the second face axis of pP
  T* a2 = a1 + 6 * N2;      // D S along it
  T* a3 = a2 + 6 * N2;      // S along it of pQ

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t cell = blockIdx.x;
  const int cx = (int)(cell % C2);
  const int cy = (int)((cell / C2) % C1);
  const int cz = (int)(cell / ((int64_t)C2 * C1));
  const int cc[3] = {cz, cy, cx};
  const int CC[3] = {C0, C1, C2};
  const int64_t cstride[3] = {(int64_t)C1 * C2, (int64_t)C2, 1};
  const int64_t base = cell * N3;

  for (int i = t; i < L::SIZE; i += nt) tab[i] = tab_g[i];
  bool has_nb[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const int d = f >> 1;
    has_nb[f] = (f & 1) ? cc[d] < CC[d] - 1 : cc[d] > 0;
  }

  const T* y = su;  // where A x ends up
  if (t < N3) su[t] = x[base + t];
  for (int f = 0; f < 6; ++f) {
    if (!has_nb[f]) continue;
    const int d = f >> 1;
    const int64_t nb = (cell + ((f & 1) ? cstride[d] : -cstride[d])) * N3;
    if (t < N3) snb[f * N3 + t] = x[nb + t];
  }
  __syncthreads();

  // v = S u
  T* v = su;
  if (!colloc) {
    sweep3<T, N>(tab + L::S, false, su, sw, t);
    v = sw;
  }
  // g_e = D_e v
  if (t < N3) {
#pragma unroll
    for (int e = 0; e < 3; ++e)
      sg[e * N3 + t] = line<T, N>(tab + L::D, false, v, t, axis_stride(e, N));
  }
  __syncthreads();

  // own traces; the neighbour's block reduced along the face normal
  for (int it = t; it < 6 * N2; it += nt) {
    const int f = it / N2, p = it % N2, d = f >> 1, s = f & 1;
    const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
    const int q1 = p / N, q2 = p % N;
    const int sd = axis_stride(d, N);
    const int off = q1 * axis_stride(e1, N) + q2 * axis_stride(e2, N);
    const T* fs = tab + L::F + s * N;
    T u_tr = T(0), g0 = T(0), g1 = T(0), g2 = T(0);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int o = off + m * sd;
      u_tr += fs[m] * v[o];
      g0 += fs[m] * sg[o];
      g1 += fs[m] * sg[N3 + o];
      g2 += fs[m] * sg[2 * N3 + o];
    }
    const T* gv = tab + L::GVEC + 3 * d;
    tu[it] = u_tr;
    tg[it] = gv[0] * g0 + gv[1] * g1 + gv[2] * g2;
    if (has_nb[f]) {
      const T* bv = tab + L::B + (1 - s) * N;
      const T* cv = tab + L::C + (1 - s) * N;
      const T* nbv = snb + f * N3;
      T P = T(0), Q = T(0);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const T w = nbv[off + m * sd];
        P += bv[m] * w;
        Q += cv[m] * w;
      }
      pP[it] = P;
      pQ[it] = Q;
    }
  }
  __syncthreads();

  // neighbour traces, stage 1: along the second face axis
  for (int it = t; it < 6 * N2; it += nt) {
    const int f = it / N2;
    if (!has_nb[f]) continue;
    const int p = it % N2, m1 = p / N, q2 = p % N;
    const T* P = pP + f * N2 + m1 * N;
    const T* Q = pQ + f * N2 + m1 * N;
    T ps = T(0), pd = T(0), qs = T(0);
    if (colloc) {
      ps = P[q2];
      qs = Q[q2];
#pragma unroll
      for (int m = 0; m < N; ++m) pd += tab[L::D + q2 * N + m] * P[m];
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const T sv = tab[L::S + q2 * N + m];
        ps += sv * P[m];
        pd += tab[L::DS + q2 * N + m] * P[m];
        qs += sv * Q[m];
      }
    }
    a1[it] = ps;
    a2[it] = pd;
    a3[it] = qs;
  }
  __syncthreads();

  // stage 2 (along the first face axis) and the face flux, in place
  for (int it = t; it < 6 * N2; it += nt) {
    const int f = it / N2, p = it % N2, d = f >> 1, s = f & 1;
    const int q1 = p / N, q2 = p % N;
    const T sign = s ? T(1) : T(-1);
    const T u_m = tu[it];
    const T gn_m = sign * tg[it];
    T u_p, gn_p;
    if (has_nb[f]) {
      const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
      const T* gv = tab + L::GVEC + 3 * d;
      const T* A1 = a1 + f * N2;
      const T* A2 = a2 + f * N2;
      const T* A3 = a3 + f * N2;
      T uu = T(0), gq = T(0), ge1 = T(0), ge2 = T(0);
      if (colloc) {
        uu = A1[p];
        gq = A3[p];
        ge2 = A2[p];
#pragma unroll
        for (int m = 0; m < N; ++m) ge1 += tab[L::D + q1 * N + m] * A1[m * N + q2];
      } else {
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const T sv = tab[L::S + q1 * N + m];
          uu += sv * A1[m * N + q2];
          gq += sv * A3[m * N + q2];
          ge1 += tab[L::DS + q1 * N + m] * A1[m * N + q2];
          ge2 += sv * A2[m * N + q2];
        }
      }
      u_p = uu;
      gn_p = sign * (gv[d] * gq + gv[e1] * ge1 + gv[e2] * ge2);
    } else {  // Dirichlet mirror
      u_p = -u_m;
      gn_p = gn_m;
    }
    const T jump = u_m - u_p;
    const T wf = tab[L::JXW + d] * tab[L::W + q1] * tab[L::W + q2];
    tu[it] = (tab[L::SIGMA + d] * jump - T(0.5) * (gn_m + gn_p)) * wf;
    tg[it] = T(-0.5) * jump * wf * sign;
  }
  __syncthreads();

  // volume term plus the lifted face terms, per node
  T vacc = T(0);
  if (t < N3) {
    const int i = t / N2, j = (t / N) % N, k = t % N;
    const int ii[3] = {i, j, k};
    const int pl[3] = {j * N + k, i * N + k, i * N + j};
    const T w3 = tab[L::W + i] * tab[L::W + j] * tab[L::W + k];
    const T g[3] = {sg[t], sg[N3 + t], sg[2 * N3 + t]};
    T lg[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T tv = T(0), tr = T(0);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const T fv = tab[L::F + s * N + ii[d]];
        tv += fv * tu[(2 * d + s) * N2 + pl[d]];
        tr += fv * tg[(2 * d + s) * N2 + pl[d]];
      }
      vacc += tv;
      lg[d] = tr;
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const T* gs = tab + L::GSYM + 3 * e;
      T a = (gs[0] * g[0] + gs[1] * g[1] + gs[2] * g[2]) * w3;
#pragma unroll
      for (int d = 0; d < 3; ++d) a += tab[L::GVEC + 3 * d + e] * lg[d];
      sg[e * N3 + t] = a;
    }
  }
  __syncthreads();
  // y = vacc + sum_e D_e^T acc_e
  if (t < N3) {
    T acc = vacc;
#pragma unroll
    for (int e = 0; e < 3; ++e)
      acc += line<T, N>(tab + L::D, true, sg + e * N3, t, axis_stride(e, N));
    su[t] = acc;
  }
  __syncthreads();
  if (!colloc) {
    sweep3<T, N>(tab + L::S, true, su, sw, t);
    y = sw;
  }

  if (t < N3) out[base + t] = y[t];
}

template <typename T, int N>
int launch(const T* x, const T* tab, T* out, int C0, int C1, int C2,
           int colloc, cudaStream_t stream) {
  const int threads = block_threads<N>();
  const size_t smem = (size_t)smem_elems<N>() * sizeof(T);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dg_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long cells = (long long)C0 * C1 * C2;
  dg_kernel<T, N><<<(unsigned)cells, threads, smem, stream>>>(
      x, tab, out, C0, C1, C2, colloc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* tab, T* out, int C0, int C1, int C2, int n,
             int colloc, cudaStream_t stream, int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1) return (int)cudaErrorInvalidValue;
  int err;
  switch (n) {
#define DG_CASE(NN)                                                     \
  case NN:                                                              \
    err = launch<T, NN>(x, tab, out, C0, C1, C2, colloc, stream);       \
    break;
    DG_CASE(2)
    DG_CASE(3)
    DG_CASE(4)
    DG_CASE(5)
    DG_CASE(6)
    DG_CASE(7)
    DG_CASE(8)
#undef DG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err == 0) *launched = 1;
  return err;
}

}  // namespace

extern "C" {

int dg_apply_f64(const double* x, const double* tab, double* y, int C0,
                 int C1, int C2, int n, int colloc, void* stream,
                 int* launched) {
  return dispatch<double>(x, tab, y, C0, C1, C2, n, colloc,
                          (cudaStream_t)stream, launched);
}

int dg_apply_f32(const float* x, const float* tab, float* y, int C0, int C1,
                 int C2, int n, int colloc, void* stream, int* launched) {
  return dispatch<float>(x, tab, y, C0, C1, C2, n, colloc,
                         (cudaStream_t)stream, launched);
}

}  // extern "C"
