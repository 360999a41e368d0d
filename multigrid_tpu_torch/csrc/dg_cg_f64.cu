// The fused CG of solver_dg for Hopper (sm_90a), in double: the two passes
// of one iteration, with the scalars kept on the device.
//   dg_cg<double>         dg_cg_kernel<N>: x += alpha_prev p_old,
//                         p = z + beta p_old, q = A p and per-block
//                         partials of p . q, then a one-block finish
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
// What bounds them on an H100: dg_cg must move 6 vectors through HBM (x,
// p_old, z in; x, p, q out: 48 bytes a dof) beside the operator's ~200
// flop a dof at p = 4, which the DFMA pipes (half the card's 67 TFLOP/s
// fp64 peak) would do in less time; the Jacobi pass 5 vectors (r, q,
// inv_diag in; r, z out) and 12 n + 6 flop a dof: both are bound by bytes.
//
// dg_cg's design: a z march.  A block owns a pencil of K cells along x
// (n^2 threads a cell, a thread one line of nodes, as in dg_pencil.cuh)
// and walks a run of L layers of its column along z.  Layer by layer:
//   * the own pencil's p_old, z and x of the next layer are staged into
//     shared memory by cp.async while the current layer runs its phases
//     (a wait and a barrier at the end of a layer), so each own value comes
//     from device memory once and the next layer's loads are in flight
//     during the arithmetic of this one;
//   * p = fma(beta, p_old, z) is formed wherever it is needed (owner,
//     neighbour, trace) with that one rounding, so a face sees one set of
//     bits for p; the owner writes p once and updates x from the p_old it
//     holds;
//   * the +-z faces read nothing: the layer above's low-face trace (b = f0
//     S p, c = f0 D S p along z) comes from its staged values, and this
//     layer's high-face trace is handed to the next layer in two registers
//     a thread; the +-y rows and the pencil's two x-end cells are read
//     from device memory in T0 (mostly L2 hits: their own blocks read them
//     too);
//   * p stays on chip for p . q: the thread's line of p (along z, the line
//     T6 writes q on) in registers, or at n >= 8, where the registers are
//     scarce, in a second buffer of p in shared memory.
// Between the loads and the store of q the kernel calls dg_pencil.cuh's
// phase functions in the apply mode (T1-T5 and T6's back end; T0 reads
// shared memory here and hands its reductions to them), over the layout
// TwoSets<double, N, K, 4>: each phase turns its lines in place (a thread
// reads and writes only its own lines within a phase), so 4 volume buffers
// a cell do, where the template keeps 7, and the faces keep the template's
// two sets. The arithmetic of the operator is there only; what is this
// kernel's own is the march, the staging, p formed where it is needed, the
// -z trace handed up, x += alpha p_old, p kept for p . q and the block
// partials. The warps an SM set the pace: the phases are bound by
// shared-memory traffic and latency, not by the loads, so the +-y rows are
// not staged (staging them too leaves room for 2 blocks of 4 warps an SM at
// n = 5 instead of 3, and measured slower: PERF.md §6). Shared memory a
// block, in doubles: 4 n^3 + 34 n^2 a cell for the phases, p (1 or 2 n^3)
// and the staged layer (3 n^3); at n = 5, 5 cells: 74,032 bytes, 3 blocks
// an SM. K (cg_pencil): 16, 6, 6, 5 cells at n = 2..5, chosen by measuring
// (PERF.md §6); above, as many as 256 threads hold and fit the 232,448
// bytes a block may have: 7, 5, 4, 3, 2 at n = 6..10. A column is cut into
// runs of at least kMinLayers layers so that the grid holds about kWaves
// times the blocks resident on the card; a run's first block reads the
// layer below it once, for its trace.

#include <stdint.h>

#include "dg_pencil.cuh"

namespace {

enum Scalar { ALPHA = 0, BETA = 1, RZ = 2, RR = 3, PQ = 4 };

constexpr int kFinishThreads = 1024;
constexpr int kSmemBlock = 232448;  // bytes of shared memory a block may have
constexpr int kStaticSmem = 256;    // block_sum's warp sums
constexpr int kMinLayers = 8;       // the shortest run of a march
constexpr int kWaves = 4;           // grids of about 4 x the blocks resident

// The sum of v over the block (blockDim.x a multiple of 32), valid in
// thread 0, in an order fixed by the block size: no atomics
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ constexpr int even(int v) { return (v + 1) & ~1; }

// The march's shared memory, offsets in doubles (each 16-byte aligned):
// the phases' buffers (dg_pencil.cuh's TwoSets<double, N, K, 4>: four
// volume buffers, the phases turning each line in place, and the face
// buffers), p (ring segments) and the staged own layer (p_old, z, x)
struct MarchLayout {
  int seg, ring, p, raw, size;
};

__host__ __device__ constexpr MarchLayout march_layout(int n, int k) {
  const int seg = even(k * n * n * n), ring = n >= 8 ? 2 : 1;
  const int p = even(two_sets_size(n, k, 4)), raw = p + ring * seg;
  return MarchLayout{seg, ring, p, raw, raw + 3 * seg};
}

__host__ __device__ constexpr bool march_fits(int n, int k) {
  return march_layout(n, k).size * 8 + kStaticSmem <= kSmemBlock &&
         k * n * n <= 1024;
}

// cells a block (the pencil along x), by points an axis: at n = 2..5 as
// measured (PERF.md §6), above as many as 256 threads hold and a block's
// shared memory fits (one block an SM, the registers not capped);
// DG_CG_PENCIL sets it for every degree when tuning
// (experiments/time_dg_cheb.py --pencil cg:K), cut to what fits
template <int N>
__host__ __device__ constexpr int cg_pencil() {
#ifdef DG_CG_PENCIL
  int k = DG_CG_PENCIL;
#else
  int k = N == 2 ? 16 : N <= 4 ? 6 : N == 5 ? 5 : 256 / (N * N);
#endif
  while (k > 1 && !march_fits(N, k)) --k;
  return k;
}

template <int N>
__host__ __device__ constexpr int cg_threads() {
  return ((cg_pencil<N>() * N * N + 31) / 32) * 32;
}

template <int N>
__host__ __device__ constexpr int cg_smem_bytes() {
  return march_layout(N, cg_pencil<N>()).size * (int)sizeof(double);
}

// blocks an SM by shared memory (233,472 bytes an SM, 1 KB reserved a
// block) and threads, the launch bound's floor, so that ptxas fits the
// registers to them
template <int N>
__host__ __device__ constexpr int cg_blocks() {
  const int b = 233472 / (cg_smem_bytes<N>() + kStaticSmem + 1024);
  const int t = 2048 / cg_threads<N>();
  return b < t ? b : t;
}

// The operator pass (see the note above).  Block b marches layers [z0, z1)
// of pencil px of row cy: px = b % npx, cy = (b / npx) % C1, z0 = L (b /
// (npx C1)).  p and q alias none of p_old, z, x.
template <int N>
__global__ void __launch_bounds__(cg_threads<N>(), cg_blocks<N>())
dg_cg_kernel(const __grid_constant__ TabArg<double, N> tab,
             const double* __restrict__ p_old, const double* __restrict__ zv,
             double* __restrict__ xv, double* __restrict__ pv,
             double* __restrict__ qv, const double* __restrict__ scal,
             double* __restrict__ partial, int C0, int C1, int C2, int L,
             int colloc) {
  constexpr int N2 = N * N, N3 = N2 * N, K = cg_pencil<N>();
  constexpr int T = cg_threads<N>();
  constexpr MarchLayout M = march_layout(N, K);
  const double* ct = tab.v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  const TwoSets<double, N, K, 4> ly{sm};  // the phases' buffers
  double* RAW = sm + M.raw;  // p_old, z, x of the next layer, SEG apart
  // the block's pencil; pl.cz: the layer the march is at
  Place<double, N, K> pl = place<double, N, K>(ct, blockIdx.x, T, C0, C1, C2);
  const int t = pl.t, c = pl.c, pt = pl.p;
  const int z0 = pl.cz * L, z1 = min(C0, z0 + L);
  const int x0 = pl.x0, cy = pl.cy;
  const int cnt = pl.c_last + 1;           // cells of a ragged pencil
  const int len = cnt * N3;                // values of the pencil a layer
  const double alpha = scal[ALPHA], beta = scal[BETA];
  // the pencil's first value in layer k, row cy + dy
  auto at = [&](int k, int dy) {
    return (((int64_t)k * C1 + cy + dy) * C2 + x0) * N3;
  };
  // n values from src to dst (16-byte aligned) by cp.async, in 16-byte
  // copies where src is aligned too
  auto stage = [&](double* dst, const double* src, int n) {
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int i = 2 * t; i < n - 1; i += 2 * T) cp_async16(dst + i, src + i);
      if ((n & 1) && t == T - 1) cp_async8(dst + n - 1, src + n - 1);
    } else {
      for (int i = t; i < n; i += T) cp_async8(dst + i, src + i);
    }
  };
  // the own pencil's p_old, z (and x) of layer k, SEG apart from dst
  auto stage_own = [&](double* dst, int k, bool with_x) {
    const int64_t g = at(k, 0);
    stage(dst, p_old + g, len);
    stage(dst + M.seg, zv + g, len);
    if (with_x) stage(dst + 2 * M.seg, xv + g, len);
  };
  // p of layer k from its staged values (src: p_old, z, x SEG apart) into
  // the p buffer Pk and to device memory, and x += alpha_prev p_old
  auto form = [&](const double* src, int k, double* Pk) {
    const int64_t g = at(k, 0);
    for (int i = t; i < len; i += T) {
      const double po = src[i];
      const double w = fma(beta, po, src[M.seg + i]);
      Pk[i] = w;
      pv[g + i] = w;
      xv[g + i] = fma(alpha, po, src[2 * M.seg + i]);
    }
  };
  // the trace (b, c) = (f_s S p, f_s D S p) along the line of axis d
  // through this thread's face point of a cell whose p_old is at po and z
  // at zz (staged, or a neighbour's in device memory)
  auto trace = [&](const double* po, const double* zz, int d, int s,
                   double& b, double& cc) {
    reduce_bc<double, N>(ct, s, [&](int m) {
      const int o = node<N>(d, pt, m);
      return fma(beta, po[o], zz[o]);
    }, b, cc);
  };

  // ---- prologue: the run's first layer (into the phases' buffers, free
  // until T0), the layer below it (for its trace) and the next layer
  double* first = sm + 2 * M.seg;
  if (z0 > 0) {
    stage(sm, p_old + at(z0 - 1, 0), len);
    stage(sm + M.seg, zv + at(z0 - 1, 0), len);
  }
  stage_own(first, z0, true);
  if (z0 + 1 < C0) stage_own(RAW, z0 + 1, z0 + 1 < z1);
  cp_async_wait_all();
  __syncthreads();
  form(first, z0, sm + M.p + (M.ring == 2 ? (z0 & 1) * M.seg : 0));
  double hz_b = 0.0, hz_c = 0.0;  // the high-face trace of the layer below
  if (pl.valid && z0 > 0)
    trace(sm + c * N3, sm + M.seg + c * N3, 0, 1, hz_b, hz_c);
  __syncthreads();

  double pq = 0.0;
  for (int k = z0; k < z1; ++k) {
    const double* Pk = sm + M.p + (M.ring == 2 ? (k & 1) * M.seg : 0);
    double* Pn = sm + M.p + (M.ring == 2 ? ((k + 1) & 1) * M.seg : 0);
    const bool more = k + 1 < z1;  // this run's next layer
    pl.cz = k;
    double u[N], acc[3][N];

    // ---- T0 (lines along 0): S_0 p, DS_0 p; the neighbours' traces
    if (pl.lane) {
#pragma unroll
      for (int m = 0; m < N; ++m)
        u[m] = pl.valid ? Pk[c * N3 + m * N2 + pt] : 0.0;
      t0_lines<double, N>(ct, colloc, ly, pl, u);
    }
    if (pl.valid) {
      // -z: the trace handed up from the layer below; then this layer's
      // high-face trace for the layer above
      if (k > 0) {
        ly.nb(0, c, 0)[pt] = hz_b;
        ly.nb(1, c, 0)[pt] = hz_c;
      }
      reduce_bc<double, N>(ct, 1, [&](int m) { return u[m]; }, hz_b, hz_c);
      // +z: the low-face trace of the layer above, from its staged values
      double b, cc;
      if (k < C0 - 1) {
        trace(RAW + c * N3, RAW + M.seg + c * N3, 0, 0, b, cc);
        ly.nb(0, c, 1)[pt] = b;
        ly.nb(1, c, 1)[pt] = cc;
      }
      // +-y, and x at the pencil's ends: the neighbours' p_old and z from
      // device memory (mostly L2: their own blocks read them too); at the
      // domain boundary the own block's, so that the loads issue together
#pragma unroll
      for (int f = 2; f < 6; ++f) {
        const bool nb_f = pl.has_nb(c, f);
        if (f >= 4 && !nb_f) continue;
        const int s = f & 1;
        const int64_t nb =
            f < 4 ? at(k, nb_f ? 2 * s - 1 : 0) + c * N3
                  : at(k, 0) + (s ? cnt : -1) * N3;
        trace(p_old + nb, zv + nb, f >> 1, 1 - s, b, cc);
        if (nb_f) {
          ly.nb(0, c, f)[pt] = b;
          ly.nb(1, c, f)[pt] = cc;
        }
      }
    }
    __syncthreads();  // 1

    // ---- T1-T5: dg_pencil.cuh's phases, the apply mode; p and x of the
    // next layer formed after T1 (its staged values were read in T0 too),
    // the layer after next staged before T2
    phase1<double, N>(ct, colloc, ly, pl);
    if (more) form(RAW, k + 1, Pn);
    __syncthreads();  // 2
    if (more && k + 2 < C0) stage_own(RAW, k + 2, k + 2 < z1);
    phase2<double, N>(ct, colloc, ly, pl, acc);
    __syncthreads();  // 3
    phase3<double, N>(ct, ly, pl);
    __syncthreads();  // 4
    phase4<double, N, APPLY>(ct, colloc, ly, pl, true, acc, nullptr, 0);
    __syncthreads();  // 5
    phase5<double, N, APPLY>(ct, colloc, ly, pl, true);
    __syncthreads();  // 6

    // ---- T6 (lines along 0): q = S^T_0 V0 + (DS)^T_0 V1, stored; this
    // thread's share of p . q from the p it holds
    if (pl.valid) {
      const int64_t cbase = at(k, 0) + c * N3;
      phase6<double, N, APPLY>(ct, colloc, ly, pl, [&](int m, double y) {
        qv[cbase + m * N2 + pt] = y;
        pq += (M.ring == 2 ? Pk[c * N3 + m * N2 + pt] : u[m]) * y;
      });
    }
    // the next layer's staged values have arrived, for every thread
    cp_async_wait_all();
    __syncthreads();  // 7
  }
  pq = block_sum(pq);
  if (t == 0) partial[blockIdx.x] = pq;
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

// The march's grid: K-cell pencils of every row, each column cut into runs
// of L >= kMinLayers layers, so that the grid holds about kWaves times the
// blocks the card keeps resident (slots)
inline void march_grid(int C0, int C1, int C2, int K, int slots, int& L,
                       long long& blocks) {
  const long long columns = (long long)C1 * ((C2 + K - 1) / K);
  const long long want = ((long long)kWaves * slots + columns - 1) /
                         columns;
  L = (int)((C0 + want - 1) / want);
  L = L < kMinLayers ? kMinLayers : L;
  L = L > C0 ? C0 : L;
  blocks = columns * ((C0 + L - 1) / L);
}

// The march kernel's blocks an SM (the occupancy calculator, after its
// shared memory is allowed) and the SMs of the current device
template <int N>
int cg_occupancy(int& per_sm, int& sms) {
  int dev = 0;
  cudaError_t err = cudaFuncSetAttribute(
      dg_cg_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cg_smem_bytes<N>());
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dg_cg_kernel<N>, cg_threads<N>(), cg_smem_bytes<N>());
  return (int)err;
}

template <int N>
int launch_cg(const double* tab, const double* p_old, const double* z,
              double* x, double* p, double* q, double* scal, double* partial,
              long long partial_len, int C0, int C1, int C2, int colloc,
              cudaStream_t st, int* launched) {
  static int slots = 0;  // blocks resident on the card, at the first launch
  constexpr size_t bytes = cg_smem_bytes<N>();
  if (slots == 0) {
    int per_sm = 0, sms = 0;
    if (int err = cg_occupancy<N>(per_sm, sms)) return err;
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  int L = 0;
  long long blocks = 0;
  march_grid(C0, C1, C2, cg_pencil<N>(), slots, L, blocks);
  if (blocks >= (1LL << 31) || blocks > partial_len)
    return (int)cudaErrorInvalidValue;
  dg_cg_kernel<N><<<(unsigned)blocks, cg_threads<N>(), bytes, st>>>(
      tab_arg<double, N>(tab), p_old, z, x, p, q, scal, partial, C0, C1, C2,
      L, colloc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  *launched = 1;
  cg_finish_kernel<<<1, kFinishThreads, 0, st>>>(partial, (int)blocks, scal,
                                                 0, 0);
  err = (int)cudaGetLastError();
  if (err == 0) *launched = 2;
  return err;
}

// The march's tile (see dg_cg_f64_tile)
template <int N>
int cg_tile(int* out) {
  int sms = 0;
  out[0] = cg_pencil<N>();
  out[1] = march_layout(N, cg_pencil<N>()).ring;
  out[2] = cg_smem_bytes<N>();
  out[3] = cg_threads<N>();
  return cg_occupancy<N>(out[4], sms);
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
// partial: partial_len doubles of scratch (one a block of the march: at
// most one a cell).  tab: host array of the kernels' table in double
// (ops/dg_kernel.py).
int dg_cg_f64(const double* p_old, const double* z, double* x, double* p,
              double* q, double* scal, const double* tab, double* partial,
              long long partial_len, int C0, int C1, int C2, int n,
              int colloc, void* stream, int* launched) {
  *launched = 0;
  if (C0 < 1 || C1 < 1 || C2 < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
#define CG_CASE(NN)                                                         \
  case NN:                                                                  \
    return launch_cg<NN>(tab, p_old, z, x, p, q, scal, partial, partial_len, \
                         C0, C1, C2, colloc, st, launched);
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

// The march's tile at n points an axis, for reports: out[0..4] = cells a
// pencil K, p buffers (1, or a ring of 2), dynamic shared memory bytes a
// block, threads a block, blocks an SM (the occupancy calculator).
int dg_cg_f64_tile(int n, int* out) {
  switch (n) {
#define TILE_CASE(NN) \
  case NN:              \
    return cg_tile<NN>(out);
    TILE_CASE(2)
    TILE_CASE(3)
    TILE_CASE(4)
    TILE_CASE(5)
    TILE_CASE(6)
    TILE_CASE(7)
    TILE_CASE(8)
    TILE_CASE(9)
    TILE_CASE(10)
#undef TILE_CASE
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
