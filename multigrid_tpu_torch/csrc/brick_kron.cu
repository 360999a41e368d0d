// f32 brick operator for Hopper (sm_90a) as one node-centric pass:
// A x, and in the same pass the residual or the Chebyshev update.
//
// brick_kron replaces the TPU kernel
//   K2  multigrid_tpu/ops/pallas_windowed_sp.py PallasWindowedSP._kernel,
//       _kernel_resid and _kernel_cheb (sp A x with its residual and
//       Chebyshev epilogues, emitted in the z-slab march that computes A x).
//
// What A is: on the affine brick with a constant coefficient every axis has
// uniform cells, so the assembled operator factorises exactly
// (multigrid_tpu/ops/laplace_kron.py):
//   A = c_z G_L (x) G_M (x) G_M + c_y G_M (x) G_L (x) G_M + c_x G_M (x) G_M (x) G_L
// with the assembled 1-D mass / stiffness matrices G_M, G_L of half-bandwidth
// p.  On an interior row i the taps G[i, i + k - p] (k = 0..2p) depend only
// on i mod p: a vertex row (residue 0) has 2p + 1 taps, the other residues
// p + 1.  So the kernel needs p rows of taps per matrix and axis; they are
// kernel parameters (Taps below, built on the host by ops/laplace_kron.py),
// read with static indices.  Seven banded sweeps:
//   v1 = Mx u, v2 = Lx u;  w1 = My v1, w23 = Ly v1 + My v2;
//   y = Lz w1 + Mz w23     (c_d folded into the L taps).
// Every output node is complete inside one block, so the epilogue fuses.
// Dirichlet nodes of x read as 0 (the staging masks them).
//
// Modes (one launch each):
//   apply     y = A x, 0 on Dirichlet rows
//   vmult     y = A x, x on Dirichlet rows
//   residual  b - A x, b - x on Dirichlet rows
//   cheb      x + f1 (x - x_old) + f2 (b - A x) / diag, with the diagonal
//             rebuilt from the taps (1 on Dirichlet rows, where A x := x);
//             x_old = NULL reads as 0; out may alias x_old (or b), never x.
//
// Design: one block of 256 threads owns an x-y tile of output columns (TX
// x TY nodes, whole cells, x a multiple of 32 nodes at p = 4) and marches
// along z through a slab of planes.  Per input plane it stages the tile
// with its halo (p nodes before, 1 after: a cell's outputs read up to the
// next vertex) by cp.async with zero fill (double-buffered, so the next
// plane's load overlaps this plane's sweeps); runs the x sweeps (one thread
// per row and cell: 2p + 1 loads give p outputs of both fields, static
// residues) and the y sweeps (one thread per column and cell) out of shared
// memory; then each thread adds the plane into a register ring of 2p + 1
// z accumulators per owned column (the z sweep in scatter form, using the
// symmetry of G).  A cell layer of outputs is complete once the vertex
// plane after it is in; its outputs leave one per plane, with b, x, x_old
// loaded at the top of the plane so that the loads overlap the sweeps.
// Each output node is written once, by one block: no atomics, no parity
// classes, no zero fill; results repeat bit for bit.  Blocks whose tile
// holds no interior node only write the Dirichlet formula.
//
// What bounds it: HBM moves 2 floats a node (apply) or 4 (cheb: x, x_old,
// b in, out), 0.04 / 0.08 ms at 257^3.  The sweeps read about 2.5 shared
// values per output and field (register-blocked over a cell) and the flops
// (~100 a node) are far below the fp32 peak; the limit is instruction issue
// and the three block barriers per plane, hidden by two or three blocks per
// SM.  So the per-plane index work is kept small: each thread's column
// offsets and interior bits are computed once, and so is a table of each
// staged node's offset in a plane, so that staging a plane is one load of
// the table and one 4-byte cp.async per node (a warp-per-row staging with
// more, partly idle, cp.async instructions measured slower).  No tensor
// cores: f32 A x has to hold 2e-6 of max|y|, and TF32 keeps about three
// digits (a 3xTF32 split would be needed, for flops that do not bind).
//
// The slab depth sets the number of blocks: the launch takes the largest
// count that fits the card's block slots at once, unless that leaves more
// than one slot an SM idle, and then the smallest count beyond them.  The
// block scheduler filled an SM's slots before it moved to the next in
// tuning runs on the H100, so a launch well short of the slots left whole
// SMs idle.
//
// The entry point writes the number of kernels it launched (1) to
// *launched.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
enum { kApply = 0, kVmult = 1, kResidual = 2, kCheb = 3 };

// taps[r][k] = G[i, i + k - P] for an interior row i = r (mod P)
template <int P>
struct Taps {
  float m[P][2 * P + 1];     // mass (the same on every axis)
  float l[3][P][2 * P + 1];  // c_d * stiffness, d = 0 (z), 1 (y), 2 (x)
};

template <int P>
struct Tile {
  static constexpr int K = 2 * P + 1;
  static constexpr int TXC = (32 + P - 1) / P;  // cells per tile in x
  static constexpr int TX = TXC * P;
  static constexpr int CPT_AIM = P <= 4 ? 4 : 2;  // z columns per thread
  static constexpr int TYC0 = CPT_AIM * kThreads / TX / P;
  static constexpr int TYC = TYC0 < 1 ? 1 : TYC0;
  static constexpr int TY = TYC * P;
  static constexpr int RY = TY + P + 1;   // staged rows (halo P before, 1 after)
  static constexpr int WX = TX + P + 1;   // staged row length
  static constexpr int SU = WX;           // odd for p >= 2: rows on distinct banks
  static constexpr int SV = TX | 1;
  static constexpr int NCOL = TX * TY;
  static constexpr int CPT = (NCOL + kThreads - 1) / kThreads;
};

// is taps[r][k] inside the band of a row of residue r?
template <int P>
__host__ __device__ constexpr bool in_band(int r, int k) {
  return r == 0 ? k < 2 * P + 1 : (k >= P - r && k <= 2 * P - r);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the centre tap of residue r (a dynamic r, static indices)
template <int P>
__device__ __forceinline__ float centre(const float (&t)[P][2 * P + 1],
                                        int r) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i == r) v = t[i][P];
  return v;
}

// the value of a Dirichlet row, where A x plays no part
template <int MODE>
__device__ __forceinline__ float dirichlet(float xv, float bv, float xo,
                                           float f1, float f2) {
  if (MODE == kApply) return 0.f;
  if (MODE == kVmult) return xv;
  if (MODE == kResidual) return bv - xv;
  return xv + f1 * (xv - xo) + f2 * (bv - xv);
}

template <int P, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    brick_kron_kernel(const float* __restrict__ x, const float* b,
                      const float* x_old, float* out,
                      const __grid_constant__ Taps<P> tp, float f1, float f2,
                      int Z, int Y, int X, int S) {
  using T = Tile<P>;
  constexpr int K = T::K;
  __shared__ float su[2][T::RY * T::SU];
  __shared__ float sv1[T::RY * T::SV];
  __shared__ float sv2[T::RY * T::SV];
  __shared__ float sw1[T::NCOL];
  __shared__ float sw23[T::NCOL];
  __shared__ int soff[T::RY * T::WX];  // staged node -> offset in a plane

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * T::TX, y0 = blockIdx.y * T::TY;
  const int zs = blockIdx.z * S;
  const int ze = blockIdx.z + 1 == gridDim.z ? Z : zs + S;
  const bool need_x = MODE != kApply;
  const bool need_b = MODE == kResidual || MODE == kCheb;
  const bool need_xo = MODE == kCheb && x_old != nullptr;

  if (x0 > X - 2 || y0 > Y - 2) {
    // every node of this block lies on the Dirichlet boundary
    const int nx = min(T::TX, X - x0), ny = min(T::TY, Y - y0);
    const int count = nx * ny * (ze - zs);
    for (int i = tid; i < count; i += kThreads) {
      const int ix = i % nx, rest = i / nx;
      const int64_t g =
          ((int64_t)(zs + rest / ny) * Y + (y0 + rest % ny)) * X + x0 + ix;
      out[g] = dirichlet<MODE>(need_x ? x[g] : 0.f, need_b ? b[g] : 0.f,
                               need_xo ? x_old[g] : 0.f, f1, f2);
    }
    return;
  }

  // owned columns: offset in a plane (-1 outside the grid), interior bits,
  // diagonal factors (diag = Lz_ii dg1 + Mz_ii dg23)
  int coff[T::CPT];
  unsigned cin = 0;
  float dg1[T::CPT], dg23[T::CPT];
#pragma unroll
  for (int q = 0; q < T::CPT; ++q) {
    const int col = tid + q * kThreads;
    const int gx = x0 + col % T::TX, gy = y0 + col / T::TX;
    coff[q] = col < T::NCOL && gx < X && gy < Y ? gy * X + gx : -1;
    if (gx >= 1 && gx <= X - 2 && gy >= 1 && gy <= Y - 2) cin |= 1u << q;
    const int rx = (col % T::TX) % P, ry = (col / T::TX) % P;
    const float mx = centre<P>(tp.m, rx), lx = centre<P>(tp.l[2], rx);
    const float my = centre<P>(tp.m, ry), ly = centre<P>(tp.l[1], ry);
    dg1[q] = my * mx;
    dg23[q] = ly * mx + my * lx;
  }

  // where each staged node comes from in a plane (-1: Dirichlet or
  // outside, staged as 0)
  for (int i = tid; i < T::RY * T::WX; i += kThreads) {
    const int row = i / T::WX, c = i - row * T::WX;
    const int gy = y0 - P + row, gx = x0 - P + c;
    soff[i] = gy >= 1 && gy <= Y - 2 && gx >= 1 && gx <= X - 2 ? gy * X + gx
                                                               : -1;
  }
  __syncthreads();

  // stage plane jz of x into dst
  auto stage = [&](int jz, float* dst) {
    const float* plane = x + (int64_t)jz * Y * X;
    for (int i = tid; i < T::RY * T::WX; i += kThreads) {
      const int o = soff[i];
      cp_async4(dst + i, o >= 0 ? plane + o : x, o >= 0 ? 4 : 0);
    }
    cp_async_commit();
  };

  // acc[q][k]: output plane (c - 1) P + k of column q while the march is in
  // cell layer c (planes c P .. c P + P - 1)
  float acc[T::CPT][K];
#pragma unroll
  for (int q = 0; q < T::CPT; ++q)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[q][k] = 0.f;

  // planes that carry data for outputs [zs, ze): interior planes only
  const int jlo = max(zs - P, 1), jhi = min(ze, Z - 2);
  if (jlo <= jhi) stage(jlo, su[0]);
  int buf = 0;

  for (int j0 = zs - P; j0 - P < ze; j0 += P) {
#pragma unroll
    for (int rho = 0; rho < P; ++rho) {
      const int jz = j0 + rho, iz = jz - P;
      const bool emit = iz >= zs && iz < ze;
      const bool zin = iz >= 1 && iz <= Z - 2;

      // epilogue inputs of output plane iz, loaded ahead of the sweeps
      const int64_t zoff = (int64_t)iz * Y * X;
      float ex[T::CPT], eb[T::CPT], eo[T::CPT];
#pragma unroll
      for (int q = 0; q < T::CPT; ++q) {
        ex[q] = eb[q] = eo[q] = 0.f;
        if (emit && coff[q] >= 0) {
          const int64_t g = zoff + coff[q];
          const bool in = zin && (cin >> q & 1u);
          if (MODE == kCheb || (need_x && !in)) ex[q] = x[g];
          if (need_b) eb[q] = b[g];
          if (need_xo) eo[q] = x_old[g];
        }
      }

      if (jz >= jlo && jz <= jhi) {  // the same for every thread
        if (jz + 1 <= jhi)
          stage(jz + 1, su[buf ^ 1]);
        else
          cp_async_commit();
        cp_async_wait1();
        __syncthreads();

        // x sweeps: rows of the staged plane, one cell per item
        const float* s_in = su[buf];
        for (int it = tid; it < T::RY * T::TXC; it += kThreads) {
          const int row = it % T::RY, c = it / T::RY;
          const float* s = s_in + row * T::SU + c * P;
          float u[K];
#pragma unroll
          for (int m = 0; m < K; ++m) u[m] = s[m];
          float* o1 = sv1 + row * T::SV + c * P;
          float* o2 = sv2 + row * T::SV + c * P;
#pragma unroll
          for (int r = 0; r < P; ++r) {
            float a1 = 0.f, a2 = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (in_band<P>(r, k) && r + k < K) {
                a1 = fmaf(tp.m[r][k], u[r + k], a1);
                a2 = fmaf(tp.l[2][r][k], u[r + k], a2);
              }
            o1[r] = a1;
            o2[r] = a2;
          }
        }
        __syncthreads();

        // y sweeps: columns of the tile, one cell per item
        for (int it = tid; it < T::TX * T::TYC; it += kThreads) {
          const int xx = it % T::TX, c = it / T::TX;
          const float* s1 = sv1 + c * P * T::SV + xx;
          const float* s2 = sv2 + c * P * T::SV + xx;
          float a[K], v[K];
#pragma unroll
          for (int m = 0; m < K; ++m) {
            a[m] = s1[m * T::SV];
            v[m] = s2[m * T::SV];
          }
#pragma unroll
          for (int r = 0; r < P; ++r) {
            float w1 = 0.f, w23 = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (in_band<P>(r, k) && r + k < K) {
                w1 = fmaf(tp.m[r][k], a[r + k], w1);
                w23 = fmaf(tp.l[1][r][k], a[r + k], w23);
                w23 = fmaf(tp.m[r][k], v[r + k], w23);
              }
            sw1[(c * P + r) * T::TX + xx] = w1;
            sw23[(c * P + r) * T::TX + xx] = w23;
          }
        }
        __syncthreads();

        // z sweep in scatter form: plane jz (residue rho) adds G[jz, iz] w
        // to output iz = (c - 1) P + k, i.e. tap k - rho of row jz
#pragma unroll
        for (int q = 0; q < T::CPT; ++q) {
          const int col = tid + q * kThreads;
          if (col < T::NCOL) {
            const float w1 = sw1[col], w23 = sw23[col];
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (k >= rho && in_band<P>(rho, k - rho)) {
                acc[q][k] = fmaf(tp.l[0][rho][k - rho], w1, acc[q][k]);
                acc[q][k] = fmaf(tp.m[rho][k - rho], w23, acc[q][k]);
              }
          }
        }
        buf ^= 1;
      }

      // output plane iz = (c - 1) P + rho is complete: all its planes
      // (up to the vertex c P) are in
      if (emit) {
#pragma unroll
        for (int q = 0; q < T::CPT; ++q) {
          if (coff[q] >= 0) {
            const int64_t g = zoff + coff[q];
            const bool in = zin && (cin >> q & 1u);
            const float a = acc[q][rho];
            float val;
            if (!in) {
              val = dirichlet<MODE>(ex[q], eb[q], eo[q], f1, f2);
            } else if (MODE == kApply || MODE == kVmult) {
              val = a;
            } else if (MODE == kResidual) {
              val = eb[q] - a;
            } else {
              const float d =
                  tp.l[0][rho][P] * dg1[q] + tp.m[rho][P] * dg23[q];
              val = ex[q] + f1 * (ex[q] - eo[q]) + f2 * (eb[q] - a) / d;
            }
            out[g] = val;
          }
        }
      }
    }
    // next cell layer: outputs c P .. (c + 1) P move to slots 0 .. P
#pragma unroll
    for (int q = 0; q < T::CPT; ++q)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[q][k] = k + P < K ? acc[q][k + P] : 0.f;
  }
}

template <int P, int MODE>
int launch_mode(const float* x, const float* b, const float* x_old,
                float* out, const float* taps, float f1, float f2, int Z,
                int Y, int X, cudaStream_t stream) {
  using T = Tile<P>;
  Taps<P> tp;
  memcpy(&tp, taps, sizeof(tp));
  // slab depth S = sc cells, from the card's block slots (occupancy x SMs):
  // the largest launch that fits the card at once, unless it leaves more
  // than one slot an SM idle (the block scheduler fills an SM before the
  // next, so whole SMs would idle); then the smallest launch beyond it
  static int sms = 0, slots = 0;
  if (slots == 0) {
    int dev = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, brick_kron_kernel<P, MODE>, kThreads, 0);
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = ((X - 2) / T::TX + 1) * ((Y - 2) / T::TY + 1);
  const int cells_z = (Z - 1) / P;
  // candidate slab counts n with balanced slabs of sc = ceil(cz / n) cells
  int fit = cells_z, fit_blocks = tiles, over = 0;
  for (int n = 1; n <= cells_z; ++n) {
    const int sc = (cells_z + n - 1) / n;
    if ((cells_z + sc - 1) / sc != n) continue;
    if (tiles * n > slots) {
      over = sc;
      break;
    }
    fit = sc;
    fit_blocks = tiles * n;
  }
  const int S = P * (over > 0 && fit_blocks < slots - sms ? over : fit);
  const dim3 grid((X + T::TX - 1) / T::TX, (Y + T::TY - 1) / T::TY,
                  (Z - 1 + S - 1) / S);
  brick_kron_kernel<P, MODE><<<grid, kThreads, 0, stream>>>(
      x, b, x_old, out, tp, f1, f2, Z, Y, X, S);
  return (int)cudaGetLastError();
}

template <int P>
int launch_degree(int mode, const float* x, const float* b,
                  const float* x_old, float* out, const float* taps, float f1,
                  float f2, int Z, int Y, int X, cudaStream_t stream) {
  switch (mode) {
    case kApply:
      return launch_mode<P, kApply>(x, b, x_old, out, taps, f1, f2, Z, Y, X,
                                    stream);
    case kVmult:
      return launch_mode<P, kVmult>(x, b, x_old, out, taps, f1, f2, Z, Y, X,
                                    stream);
    case kResidual:
      return launch_mode<P, kResidual>(x, b, x_old, out, taps, f1, f2, Z, Y,
                                       X, stream);
    case kCheb:
      return launch_mode<P, kCheb>(x, b, x_old, out, taps, f1, f2, Z, Y, X,
                                   stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// mode: 0 apply, 1 vmult, 2 residual, 3 cheb.  taps: host array of
// 4 * p * (2p + 1) floats (M, c_z L_z, c_y L_y, c_x L_x; each [p][2p + 1]).
int brick_kron_f32(int mode, const float* x, const float* b,
                   const float* x_old, float* out, const float* taps,
                   double f1, double f2, int Z, int Y, int X, int p,
                   void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float g1 = (float)f1, g2 = (float)f2;
  int err;
  switch (p) {
#define MGT_KRON_CASE(P)                                                    \
  case P:                                                                   \
    err = launch_degree<P>(mode, x, b, x_old, out, taps, g1, g2, Z, Y, X,   \
                           s);                                              \
    break;
    MGT_KRON_CASE(1)
    MGT_KRON_CASE(2)
    MGT_KRON_CASE(3)
    MGT_KRON_CASE(4)
    MGT_KRON_CASE(5)
    MGT_KRON_CASE(6)
    MGT_KRON_CASE(7)
#undef MGT_KRON_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) *launched = 1;
  return err;
}

}  // extern "C"
