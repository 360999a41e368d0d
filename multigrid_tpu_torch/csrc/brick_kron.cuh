// The brick operator for Hopper (sm_90a) as one node-centric pass: A x,
// and in the same pass its vmult, residual or Chebyshev epilogue.  One
// template on the value type T; brick_kron.cu instantiates it in float,
// brick_kron_f64.cu in double (two translation units, built in parallel).
//
// brick_kron<float> replaces the TPU kernel
//   K2  multigrid_tpu/ops/pallas_windowed_sp.py PallasWindowedSP._kernel,
//       _kernel_resid and _kernel_cheb (sp A x with its residual and
//       Chebyshev epilogues, emitted in the z-slab march that computes A x);
// brick_kron<double> replaces
//   K1  multigrid_tpu/ops/pallas_windowed.py PallasWindowedOzaki._fused
//       (_kernel, vmult, vmult_residual: dp A x on f32 hi/lo pairs with
//       Ozaki bf16 limbs).  The H100 has native fp64: no limbs, no pairs.
//
// What A is: on the affine brick with a constant coefficient every axis has
// uniform cells, so the assembled operator factorises exactly
// (multigrid_tpu/ops/laplace_kron.py):
//   A = c_z G_L (x) G_M (x) G_M + c_y G_M (x) G_L (x) G_M + c_x G_M (x) G_M (x) G_L
// with the assembled 1-D mass / stiffness matrices G_M, G_L of half-bandwidth
// p.  On an interior row i the taps G[i, i + k - p] (k = 0..2p) depend only
// on i mod p: a vertex row (residue 0) has 2p + 1 taps, the other residues
// p + 1.  So the kernel needs p rows of taps per matrix and axis; they are
// kernel parameters (Taps below, built on the host by ops/laplace_kron.py;
// 5,472 bytes in double at p = 9 and 16,896 at p = 16, above the 4 KB that
// parameters had before CUDA 12.1 and within its 32,764), read with static
// indices (at p >= 10 the z sweep's with the residue known at run time).  Seven banded
// sweeps:
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
// holds no interior node only write the Dirichlet formula.  Shared memory
// is dynamic (one struct, Smem below).
//
// What bounds it: HBM moves 2 values a node (apply, vmult), 3 (residual)
// or 4 (cheb: x, x_old, b in, out): at 257^3 0.04 / 0.08 ms in float and
// 0.08 / 0.16 ms in double.  The sweeps do about 42 FMAs a node (p = 4),
// far below the fp32 peak and 0.05 ms of the fp64 pipe (64 FMAs a clock an
// SM) at 257^3; they read about 2.5 shared values per output and field
// (register-blocked over a cell).  The float kernel is bound by
// instruction issue and the three block barriers per plane, hidden by two
// or three blocks per SM.  So the per-plane index work is kept small: each
// thread's column offsets and interior bits are computed once, and so is a
// table of each staged node's offset in a plane, so that staging a plane
// is one load of the table and one cp.async per node (a warp-per-row
// staging with more, partly idle, cp.async instructions measured slower).
// In double the ring of z accumulators and the shared tiles take twice the
// room.  The tile keeps 3 columns a thread at p <= 4 (32 x 24 nodes at
// p = 4, 48 KB of shared memory) and the launch bound asks for one block
// an SM, so ptxas does not spill; the apply, vmult and residual modes come
// out at 111-124 registers, so two blocks fit an SM all the same.
// Measured at 257^3 (H100, experiments/time_brick.py --f64-variant):
// 2 columns (32 x 16, two blocks) apply 0.205 / residual 0.251 ms, 3
// columns 0.171 / 0.200, 4 (the float tile, 63 KB; 146 registers in the
// residual, one block an SM) 0.162 / 0.276; a cap of 128 registers makes 3
// and 4 spill.  Above p = 4 the sweeps' lines of 2p + 1 values take the
// room: double keeps one column a thread at p = 5-7 (p = 7 needs more
// than 128 registers even so).  Degrees 5-9 are off the main path.  At
// p = 8 and 9 one or two columns leave a tile of one or two cell rows in
// y, so a plane's y sweep has 32-64 items for 256 threads and the x
// sweep 68-100.  The tiles there are the fastest without a spill of
// experiments/time_brick.py's sweep (--high-variant; H100 700 W, 257^3 /
// 253^3 nodes, PERF.md): float 1 column at p = 8 (Chebyshev step 0.456
// against 0.523 ms with 2) and 3 at p = 9 (0.686 against 1.081), two
// blocks an SM; the best double tiles took 1.26 ms (p = 8) and 2.93 ms
// (p = 9, slower than the dense plain version) for the apply.  No grid
// takes the march at p = 8, 9 now: the cell form and the layer march
// (below) run there; it stays the form both are held to bit for bit.
// BRICK_KRON_F64_CPT and BRICK_KRON_F64_MIN_BLOCKS override both for
// tuning builds; BRICK_KRON_HIGH_CPT (the columns a thread aimed at
// above p = 4, in the type a source builds) and
// BRICK_KRON_F32_MIN_BLOCKS do the same for the float tile and the higher
// degrees (time_brick --high-variant).  No tensor cores: f32 A x has to
// hold 2e-6 of max|y| (TF32 keeps about three digits), and the double
// pipe's flops do not bind.
//
// The slab depth sets the number of blocks: the launch takes the largest
// count that fits the card's block slots at once, unless that leaves more
// than one slot an SM idle, and then the smallest count beyond them.  The
// block scheduler filled an SM's slots before it moved to the next in
// tuning runs on the H100, so a launch well short of the slots left whole
// SMs idle.  The slots are read per instantiation (occupancy x SMs), so
// the double tile, which fits fewer blocks, gets its own slab depth.
//
// p = 8 and 9: the cell form.  These degrees stand for K1 and K2 where
// the JAX package runs them through KronLaplaceF32 / XLA: the FE_Q(8) /
// FE_Q(9) V-cycles of poisson_cube and of poisson_dg's FE_Q hierarchy,
// and their outer double residual and CG vmult.  What bounds them: HBM
// bytes on the large grids (0.04-0.12 ms at 253^3 / 257^3); on the small
// ones, the launch.  A V-cycle takes most of its launches on its coarse
// grid (the coarse Chebyshev has degree 236 at 64^3 nodes in the p = 9
// cube CG, 95 at 28^3 in poisson_dg p = 9): the p = 9 cube CG launched
// 2585 float steps at 64^3 and 132 above, and spent 0.193 of its 0.271 s
// of brick time there (torch.profiler by grid, profile_solve --levels).
// An empty launch takes 1.0 us of device time on the card and a brick
// call 20-40 us of host time; the march took 65-75 us of device time at
// 28^3-64^3 (p = 9), because a slab cannot be shorter than one cell plus
// its p-plane halo: 6-56 blocks for 132 SMs, each marching 2p + 1 planes
// with three barriers a plane.  The cell form (brick_cell_kernel) gives
// each cell a block of 256 threads that stages the (2p + 1)^3 input
// neighbourhood at once (27 KB in float at p = 9) and runs the x sweep
// (an item a row and field), the y sweep (an item a plane and column) and
// the z sweep with the epilogue (an item a column and group of output
// planes), one barrier apart: 343 blocks at 64^3.  Each node adds the
// same taps in the same order as in the march, so the two forms give the
// same bits.  Measured (H100 700 W, device time, time_brick --levels
// --form, PERF.md): the float step at p = 9 takes 17.6 us at 64^3 against
// the march's 74.8, 9.0 against 65.1 at 28^3, 0.104 against 0.123 ms at
// 127^3; the double apply 1.00 against 2.91 ms at 253^3 and 1.02 against
// 1.27 at 257^3 (p = 8).  On the large float grids the cell form loses:
// the step at p = 9, 253^3, 0.80 against 0.68 ms, at p = 8, 257^3, 0.68
// against 0.47 (a block stages and sweeps 9.4x (p = 9) its owned nodes
// in x and y, where the march's slab shares its halo).  The cell form's
// registers: float 53-76, double 114-128 (the launch bound asks for three
// blocks an SM in float, two in double), no spill.  Rows of P outputs in
// shared memory are P | 1 apart, so that p = 8's x-sweep stores and
// y-sweep loads fall on distinct banks; staging a row a warp (19 of 32
// lanes) measured slower than a node a thread.
//
// p = 8 and 9 in float on the large grids: the layer march
// (brick_layer_kernel, built in brick_kron_layer.cu).  The march's ring
// of 2p + 1 z accumulators a column in registers capped its tile; the
// layer march keeps w1, w23 of p + 1 planes in a ring in shared memory
// and goes by cell layers.  A block of 384 threads owns a tile of 4 x 3
// cells at p = 8, 4 x 4 at p = 9 (32 x 24 / 36 x 36 nodes); per group of
// G = 4 / 3 input planes it stages the planes with their halo (cp.async,
// double-buffered: the next group loads under this group's sweeps) and
// runs the x sweep (an item a row, cell and plane: 528 / 552 items) and
// the y sweep (a column, cell and plane: 384 / 432) over the group; at a
// layer's top vertex plane the z sweep gathers each column's p outputs
// (an item a column: 768 / 1296), planes ascending, L then M, the vertex
// output's lower planes carried in one register a column from the layer
// before: the march's order, so the same bits.  Staged nodes a plane per
// owned node 1.76 / 1.63 (the march 2.7 / 2.0); three barriers a group,
// one more a layer.  Shared memory 138,852 / 204,880 bytes, one block an
// SM, 119-156 / 136-159 registers, no spill.  The launch is one wave:
// the (tile, cell layer) units split evenly over the card's block slots,
// so a block's run may end in one tile and go on in the next; a few
// blocks in front write the node planes x = X - 1, y = Y - 1 that the
// tiles end one node short of.  Measured (H100 700 W, device time,
// time_brick --levels, PERF.md): the step 0.289 ms at 257^3 (p = 8;
// march 0.455) and 0.382 at 253^3 (p = 9; march 0.689), the apply 0.192
// / 0.224 (march 0.458 / 0.542); tiles of 4 x 4 cells at 512 threads
// spilled at p = 8 in the step (128 registers); an L2 prefetch of the
// epilogue inputs a layer ahead made the step slower (0.343 against
// 0.282 ms).  What bounds it now: the z sweep's loads of b, x, x_old
// (the step takes 0.29 ms where the apply takes 0.19), then the
// instruction rate.
// The wrapper (laplace_kernel.brick_form) chooses per grid from those
// measurements: the cell form in double on every grid and in float up to
// 3000 cells at p = 8 (97^3, 1728 cells: step 0.0424 against the layer
// march's 0.0430 ms) and 1000 at p = 9 (109^3, 1728 cells: 0.0668
// against 0.0469), the layer march on the larger float grids.
//
// p = 10..16: the z-slab march again, in both types (brick_kron_wide.cu,
// brick_kron_wide_f64.cu, which brick_kron_f32 / brick_kron_f64 hand these
// degrees to).  The cell form's (2p + 1)^3 neighbourhood outgrows a block
// there (190,440 B in double at p = 11, 234,484 B in float at p = 15);
// the march's slab does not (at most 35 KB).  A tile keeps one column a
// thread (one cell, two in x at p = 10, 11; Tile), so that the ring of 2p
// + 1 accumulators and the sweeps' lines of 2p + 1 values fit 255
// registers at one block an SM, and the planes of a cell layer run one a
// trip (Tile::RHO_UNROLL), the residue read at run time: one copy of the x
// and y sweeps where p <= 9 unrolls p of them.  Each node adds the same
// taps in the same order, so the bits are the march's.  The double
// residual and step spill 8-176 B a thread at p = 15, 16 (PERF.md).  What
// bounds it: a plane's x and y sweeps have 2p + 1 and p items for 256
// threads, so the march runs at 1.4-8.2 ms (float apply, p = 10 / 16 at
// 241^3 / 257^3 nodes, H100 700 W) against a bound of 0.04-0.06 ms.
//
// The entry points (brick_kron_f32, brick_kron_f64) take the form (0 the
// march, 1 the cell form, p = 8, 9 only), brick_kron_layer_f32 the layer
// march (form 2, p = 8, 9); each writes the number of kernels it
// launched (1) to *launched.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// the entries of p = 10..16 (brick_kron_wide.cu, brick_kron_wide_f64.cu),
// which brick_kron_f32 / brick_kron_f64 hand those degrees to
extern "C" {
int brick_kron_wide_f32(int mode, int form, const float* x, const float* b,
                        const float* x_old, float* out, const float* taps,
                        double f1, double f2, int Z, int Y, int X, int p,
                        void* stream, int* launched);
int brick_kron_wide_f64(int mode, int form, const double* x, const double* b,
                        const double* x_old, double* out, const double* taps,
                        double f1, double f2, int Z, int Y, int X, int p,
                        void* stream, int* launched);
}

#ifndef BRICK_KRON_F64_CPT
#define BRICK_KRON_F64_CPT 3
#endif
#ifndef BRICK_KRON_F64_MIN_BLOCKS
#define BRICK_KRON_F64_MIN_BLOCKS 1
#endif
#ifndef BRICK_KRON_F32_MIN_BLOCKS
#define BRICK_KRON_F32_MIN_BLOCKS 2
#endif

namespace {

constexpr int kThreads = 256;
enum { kApply = 0, kVmult = 1, kResidual = 2, kCheb = 3 };
// the first degree of brick_kron_wide.cu / brick_kron_wide_f64.cu (the
// z-slab march at p = 10..16, in both types)
constexpr int kWideDegree = 10;
constexpr int kWideTop = 16;

// taps[r][k] = G[i, i + k - P] for an interior row i = r (mod P)
template <typename T, int P>
struct Taps {
  T m[P][2 * P + 1];     // mass (the same on every axis)
  T l[3][P][2 * P + 1];  // c_d * stiffness, d = 0 (z), 1 (y), 2 (x)
};

template <typename T, int P>
struct Tile {
  static constexpr int K = 2 * P + 1;
  // cells per tile in x: 32 nodes' worth up to p = 9; above, as many as
  // leave one column a thread (kThreads / P^2, at least one cell)
  static constexpr int TXC =
      P < kWideDegree ? (32 + P - 1) / P
                      : (kThreads / (P * P) > 1 ? kThreads / (P * P) : 1);
  static constexpr int TX = TXC * P;
  // z columns per thread aimed at: float 4 at p <= 4, 2 at p = 5-7, 1 at
  // p = 8, 3 at p = 9 (the fastest tiles without a spill in time_brick's
  // sweep, PERF.md); double BRICK_KRON_F64_CPT at p <= 4, 1 at p = 5-7;
  // 1 in both types at p >= 10, where the ring of 2p + 1 accumulators a
  // column and the sweeps' lines of 2p + 1 values fill the registers
#ifdef BRICK_KRON_HIGH_CPT
  static constexpr int CPT_HIGH = BRICK_KRON_HIGH_CPT;
#else
  static constexpr int CPT_HIGH =
      sizeof(T) == 4 && P < kWideDegree ? (P == 8 ? 1 : P == 9 ? 3 : 2) : 1;
#endif
  static constexpr int CPT_AIM = P > 4            ? CPT_HIGH
                                 : sizeof(T) == 4 ? 4
                                                  : BRICK_KRON_F64_CPT;
  static constexpr int TYC0 = CPT_AIM * kThreads / TX / P;
  static constexpr int TYC = TYC0 < 1 ? 1 : TYC0;
  static constexpr int TY = TYC * P;
  static constexpr int RY = TY + P + 1;   // staged rows (halo P before, 1 after)
  static constexpr int WX = TX + P + 1;   // staged row length
  static constexpr int SU = WX;           // odd for p >= 2: rows on distinct banks
  static constexpr int SV = TX | 1;
  static constexpr int NCOL = TX * TY;
  static constexpr int CPT = (NCOL + kThreads - 1) / kThreads;
  // blocks an SM must hold (the launch bound, which caps the registers;
  // one at p >= 10, so that ptxas may take up to 255 a thread)
  static constexpr int MIN_BLOCKS =
      P >= kWideDegree ? 1
      : sizeof(T) == 4 ? BRICK_KRON_F32_MIN_BLOCKS
                       : BRICK_KRON_F64_MIN_BLOCKS;
  // the march's planes of a cell layer unrolled (static residues) up to
  // p = 9; above, one plane a trip, the residue read at run time, so that
  // the code holds one copy of the x and y sweeps instead of p
  static constexpr int RHO_UNROLL = P < kWideDegree ? P : 1;
};

template <typename T, int P>
struct Smem {
  using L = Tile<T, P>;
  T su[2][L::RY * L::SU];   // staged planes of x (double-buffered)
  T sv1[L::RY * L::SV];     // Mx u
  T sv2[L::RY * L::SV];     // Lx u
  T sw1[L::NCOL];           // My v1
  T sw23[L::NCOL];          // Ly v1 + My v2
  int soff[L::RY * L::WX];  // staged node -> offset in a plane
};

// is taps[r][k] inside the band of a row of residue r?
template <int P>
__host__ __device__ constexpr bool in_band(int r, int k) {
  return r == 0 ? k < 2 * P + 1 : (k >= P - r && k <= 2 * P - r);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// one element global -> shared; bytes = 0 fills it with zero
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the centre tap of residue r (a dynamic r, static indices)
template <typename T, int P>
__device__ __forceinline__ T centre(const T (&t)[P][2 * P + 1], int r) {
  T v = T(0);
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i == r) v = t[i][P];
  return v;
}

// r[i] for a residue i known only at run time, from static indices (the
// ring stays in registers)
template <typename T, int K>
__device__ __forceinline__ T ring_at(const T (&r)[K], int i) {
  T v = r[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (k == i) v = r[k];
  return v;
}

// the value of a Dirichlet row, where A x plays no part
template <int MODE, typename T>
__device__ __forceinline__ T dirichlet(T xv, T bv, T xo, T f1, T f2) {
  if (MODE == kApply) return T(0);
  if (MODE == kVmult) return xv;
  if (MODE == kResidual) return bv - xv;
  return xv + f1 * (xv - xo) + f2 * (bv - xv);
}

template <typename T, int P, int MODE>
__global__ void __launch_bounds__(kThreads, Tile<T, P>::MIN_BLOCKS)
    brick_kron_kernel(const T* __restrict__ x, const T* b, const T* x_old,
                      T* out, const __grid_constant__ Taps<T, P> tp, T f1,
                      T f2, int Z, int Y, int X, int S) {
  using L = Tile<T, P>;
  constexpr int K = L::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, P>& sm = *reinterpret_cast<Smem<T, P>*>(smem_raw);

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * L::TX, y0 = blockIdx.y * L::TY;
  const int zs = blockIdx.z * S;
  const int ze = blockIdx.z + 1 == gridDim.z ? Z : zs + S;
  const bool need_x = MODE != kApply;
  const bool need_b = MODE == kResidual || MODE == kCheb;
  const bool need_xo = MODE == kCheb && x_old != nullptr;
  const T zero = T(0);

  if (x0 > X - 2 || y0 > Y - 2) {
    // every node of this block lies on the Dirichlet boundary
    const int nx = min(L::TX, X - x0), ny = min(L::TY, Y - y0);
    const int count = nx * ny * (ze - zs);
    for (int i = tid; i < count; i += kThreads) {
      const int ix = i % nx, rest = i / nx;
      const int64_t g =
          ((int64_t)(zs + rest / ny) * Y + (y0 + rest % ny)) * X + x0 + ix;
      out[g] = dirichlet<MODE>(need_x ? x[g] : zero, need_b ? b[g] : zero,
                               need_xo ? x_old[g] : zero, f1, f2);
    }
    return;
  }

  // owned columns: offset in a plane (-1 outside the grid), interior bits,
  // diagonal factors (diag = Lz_ii dg1 + Mz_ii dg23)
  int coff[L::CPT];
  unsigned cin = 0;
  T dg1[L::CPT], dg23[L::CPT];
#pragma unroll
  for (int q = 0; q < L::CPT; ++q) {
    const int col = tid + q * kThreads;
    const int gx = x0 + col % L::TX, gy = y0 + col / L::TX;
    coff[q] = col < L::NCOL && gx < X && gy < Y ? gy * X + gx : -1;
    if (gx >= 1 && gx <= X - 2 && gy >= 1 && gy <= Y - 2) cin |= 1u << q;
    const int rx = (col % L::TX) % P, ry = (col / L::TX) % P;
    const T mx = centre<T, P>(tp.m, rx), lx = centre<T, P>(tp.l[2], rx);
    const T my = centre<T, P>(tp.m, ry), ly = centre<T, P>(tp.l[1], ry);
    dg1[q] = my * mx;
    dg23[q] = ly * mx + my * lx;
  }

  // where each staged node comes from in a plane (-1: Dirichlet or
  // outside, staged as 0)
  for (int i = tid; i < L::RY * L::WX; i += kThreads) {
    const int row = i / L::WX, c = i - row * L::WX;
    const int gy = y0 - P + row, gx = x0 - P + c;
    sm.soff[i] = gy >= 1 && gy <= Y - 2 && gx >= 1 && gx <= X - 2
                     ? gy * X + gx
                     : -1;
  }
  __syncthreads();

  // stage plane jz of x into dst
  auto stage = [&](int jz, T* dst) {
    const T* plane = x + (int64_t)jz * Y * X;
    for (int i = tid; i < L::RY * L::WX; i += kThreads) {
      const int o = sm.soff[i];
      cp_async(dst + i, o >= 0 ? plane + o : x, o >= 0 ? (int)sizeof(T) : 0);
    }
    cp_async_commit();
  };

  // acc[q][k]: output plane (c - 1) P + k of column q while the march is in
  // cell layer c (planes c P .. c P + P - 1)
  T acc[L::CPT][K];
#pragma unroll
  for (int q = 0; q < L::CPT; ++q)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[q][k] = zero;

  // planes that carry data for outputs [zs, ze): interior planes only
  const int jlo = max(zs - P, 1), jhi = min(ze, Z - 2);
  if (jlo <= jhi) stage(jlo, sm.su[0]);
  int buf = 0;

  for (int j0 = zs - P; j0 - P < ze; j0 += P) {
#pragma unroll (L::RHO_UNROLL)
    for (int rho = 0; rho < P; ++rho) {
      const int jz = j0 + rho, iz = jz - P;
      const bool emit = iz >= zs && iz < ze;
      const bool zin = iz >= 1 && iz <= Z - 2;

      // epilogue inputs of output plane iz, loaded ahead of the sweeps
      const int64_t zoff = (int64_t)iz * Y * X;
      T ex[L::CPT], eb[L::CPT], eo[L::CPT];
#pragma unroll
      for (int q = 0; q < L::CPT; ++q) {
        ex[q] = eb[q] = eo[q] = zero;
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
          stage(jz + 1, sm.su[buf ^ 1]);
        else
          cp_async_commit();
        cp_async_wait1();
        __syncthreads();

        // x sweeps: rows of the staged plane, one cell per item
        const T* s_in = sm.su[buf];
        for (int it = tid; it < L::RY * L::TXC; it += kThreads) {
          const int row = it % L::RY, c = it / L::RY;
          const T* s = s_in + row * L::SU + c * P;
          T u[K];
#pragma unroll
          for (int m = 0; m < K; ++m) u[m] = s[m];
          T* o1 = sm.sv1 + row * L::SV + c * P;
          T* o2 = sm.sv2 + row * L::SV + c * P;
#pragma unroll
          for (int r = 0; r < P; ++r) {
            T a1 = zero, a2 = zero;
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (in_band<P>(r, k) && r + k < K) {
                a1 = fma_t(tp.m[r][k], u[r + k], a1);
                a2 = fma_t(tp.l[2][r][k], u[r + k], a2);
              }
            o1[r] = a1;
            o2[r] = a2;
          }
        }
        __syncthreads();

        // y sweeps: columns of the tile, one cell per item
        for (int it = tid; it < L::TX * L::TYC; it += kThreads) {
          const int xx = it % L::TX, c = it / L::TX;
          const T* s1 = sm.sv1 + c * P * L::SV + xx;
          const T* s2 = sm.sv2 + c * P * L::SV + xx;
          T a[K], v[K];
#pragma unroll
          for (int m = 0; m < K; ++m) {
            a[m] = s1[m * L::SV];
            v[m] = s2[m * L::SV];
          }
#pragma unroll
          for (int r = 0; r < P; ++r) {
            T w1 = zero, w23 = zero;
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (in_band<P>(r, k) && r + k < K) {
                w1 = fma_t(tp.m[r][k], a[r + k], w1);
                w23 = fma_t(tp.l[1][r][k], a[r + k], w23);
                w23 = fma_t(tp.m[r][k], v[r + k], w23);
              }
            sm.sw1[(c * P + r) * L::TX + xx] = w1;
            sm.sw23[(c * P + r) * L::TX + xx] = w23;
          }
        }
        __syncthreads();

        // z sweep in scatter form: plane jz (residue rho) adds G[jz, iz] w
        // to output iz = (c - 1) P + k, i.e. tap k - rho of row jz
#pragma unroll
        for (int q = 0; q < L::CPT; ++q) {
          const int col = tid + q * kThreads;
          if (col < L::NCOL) {
            const T w1 = sm.sw1[col], w23 = sm.sw23[col];
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (k >= rho && in_band<P>(rho, k - rho)) {
                acc[q][k] = fma_t(tp.l[0][rho][k - rho], w1, acc[q][k]);
                acc[q][k] = fma_t(tp.m[rho][k - rho], w23, acc[q][k]);
              }
          }
        }
        buf ^= 1;
      }

      // output plane iz = (c - 1) P + rho is complete: all its planes
      // (up to the vertex c P) are in
      if (emit) {
#pragma unroll
        for (int q = 0; q < L::CPT; ++q) {
          if (coff[q] >= 0) {
            const int64_t g = zoff + coff[q];
            const bool in = zin && (cin >> q & 1u);
            T a;
            if constexpr (L::RHO_UNROLL == P)
              a = acc[q][rho];
            else
              a = ring_at<T, K>(acc[q], rho);
            T val;
            if (!in) {
              val = dirichlet<MODE>(ex[q], eb[q], eo[q], f1, f2);
            } else if (MODE == kApply || MODE == kVmult) {
              val = a;
            } else if (MODE == kResidual) {
              val = eb[q] - a;
            } else {
              const T d = tp.l[0][rho][P] * dg1[q] + tp.m[rho][P] * dg23[q];
              val = ex[q] + f1 * (ex[q] - eo[q]) + f2 * (eb[q] - a) / d;
            }
            out[g] = val;
          }
        }
      }
    }
    // next cell layer: outputs c P .. (c + 1) P move to slots 0 .. P
#pragma unroll
    for (int q = 0; q < L::CPT; ++q)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[q][k] = k + P < K ? acc[q][k + P] : zero;
  }
}

template <typename T, int P, int MODE>
int launch_mode(const T* x, const T* b, const T* x_old, T* out,
                const T* taps, T f1, T f2, int Z, int Y, int X,
                cudaStream_t stream) {
  using L = Tile<T, P>;
  constexpr int kSmem = (int)sizeof(Smem<T, P>);
  const auto kernel = brick_kron_kernel<T, P, MODE>;
  Taps<T, P> tp;
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
    if (kSmem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  kSmem);
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = ((X - 2) / L::TX + 1) * ((Y - 2) / L::TY + 1);
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
  const dim3 grid((X + L::TX - 1) / L::TX, (Y + L::TY - 1) / L::TY,
                  (Z - 1 + S - 1) / S);
  brick_kron_kernel<T, P, MODE><<<grid, kThreads, kSmem, stream>>>(
      x, b, x_old, out, tp, f1, f2, Z, Y, X, S);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- p >= 8
// The cell form (the note at the top says when it runs and why): one
// block of kThreads owns the P^3 output nodes of one cell, [o, o + P) on
// each axis (the last cell of an axis also the boundary node o + P),
// stages the input neighbourhood [o - P, o + P]^3 at once and runs the
// x, y and z sweeps over it with one barrier between sweeps.  Each node
// sums the taps of brick_kron_kernel in the same order (x: the taps of
// its row; y: the same; z: the input planes in ascending order, L then
// M), so the outputs are the march's bit for bit; Dirichlet and outside
// nodes stage as 0 and add +0 where the march skips them.
constexpr int kCellDegree = 8;

template <typename T, int P>
struct Cell {
  static constexpr int K = 2 * P + 1;
  static constexpr int K2 = K * K;
  static constexpr int K3 = K2 * K;
  // x sweep: one item a row and field, a field's rows padded to whole
  // warps, so the field (and its tap table) is uniform across a warp
  static constexpr int ROWS = (K2 + 31) / 32 * 32;
  // z sweep: one item a column and group of output planes, the groups
  // (NG of them, as many as fit the block with columns padded to whole
  // warps) of about equal FMA counts
  static constexpr int COLS = (P * P + 31) / 32 * 32;
  static constexpr int NG0 = kThreads / COLS;
  static constexpr int NG = NG0 < 1 ? 1 : NG0 > P ? P : NG0;
  // rows of P outputs stored SP apart (odd: the x sweep's stores and the
  // y sweep's loads fall on distinct banks)
  static constexpr int SP = P | 1;
  static constexpr int NV = K2 * SP;     // v1 or v2: [K z][K y][P x]
  static constexpr int NW = K * P * SP;  // w1 or w23: [K z][P y][P x]
  static_assert(2 * NW <= K3, "w1, w23 overlay the staged neighbourhood");
  // blocks an SM must hold (the launch bound, which caps the registers)
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 3 : 2;
};

template <typename T, int P>
struct CellSmem {
  using C = Cell<T, P>;
  T su[C::K3];  // the staged neighbourhood; then w1 (NW) and w23 (NW)
  T sv1[C::NV];
  T sv2[C::NV];
};

// out[r] = sum_k t[r][k] u[r + k] over the band of residue r, in the
// order of brick_kron_kernel's x sweep
template <typename T, int P>
__device__ __forceinline__ void cell_x_row(const T (&t)[P][2 * P + 1],
                                           const T* u, T* out) {
  constexpr int K = 2 * P + 1;
  T v[K];
#pragma unroll
  for (int m = 0; m < K; ++m) v[m] = u[m];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    T a = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (in_band<P>(r, k) && r + k < K) a = fma_t(t[r][k], v[r + k], a);
    out[r] = a;
  }
}

template <typename T, int P, int MODE>
__global__ void __launch_bounds__(kThreads, Cell<T, P>::MIN_BLOCKS)
    brick_cell_kernel(const T* __restrict__ x, const T* b, const T* x_old,
                      T* out, const __grid_constant__ Taps<T, P> tp, T f1,
                      T f2, int Z, int Y, int X) {
  using C = Cell<T, P>;
  constexpr int K = C::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CellSmem<T, P>& sm = *reinterpret_cast<CellSmem<T, P>*>(smem_raw);
  T* const sw1 = sm.su;
  T* const sw23 = sm.su + C::NW;

  const int tid = threadIdx.x;
  const int ox = blockIdx.x * P, oy = blockIdx.y * P, oz = blockIdx.z * P;
  const bool need_x = MODE != kApply;
  const bool need_b = MODE == kResidual || MODE == kCheb;
  const bool need_xo = MODE == kCheb && x_old != nullptr;
  const T zero = T(0);

  // stage [o - P, o + P]^3 of x (Dirichlet and outside nodes as 0), a
  // node a thread (a warp a row, 19 of 32 lanes busy, measured slower)
  for (int i = tid; i < C::K3; i += kThreads) {
    const int sz = i / C::K2, rest = i - sz * C::K2;
    const int sy = rest / K, sx = rest - sy * K;
    const int gz = oz - P + sz, gy = oy - P + sy, gx = ox - P + sx;
    const bool in = gz >= 1 && gz <= Z - 2 && gy >= 1 && gy <= Y - 2 &&
                    gx >= 1 && gx <= X - 2;
    cp_async(sm.su + i, in ? x + ((int64_t)gz * Y + gy) * X + gx : x,
             in ? (int)sizeof(T) : 0);
  }
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();

  // x sweeps: v1 = Mx u, v2 = Lx u at the P owned x of every staged row
  for (int it = tid; it < 2 * C::ROWS; it += kThreads) {
    const int field = it / C::ROWS, row = it - field * C::ROWS;
    if (row < C::K2) {
      if (field == 0)
        cell_x_row<T, P>(tp.m, sm.su + row * K, sm.sv1 + row * C::SP);
      else
        cell_x_row<T, P>(tp.l[2], sm.su + row * K, sm.sv2 + row * C::SP);
    }
  }
  __syncthreads();

  // y sweeps: w1 = My v1, w23 = Ly v1 + My v2 at the P x P owned (y, x)
  // of every staged plane (into the staged neighbourhood's room)
  for (int it = tid; it < K * P; it += kThreads) {
    const int sz = it / P, kx = it - sz * P;
    const T* s1 = sm.sv1 + sz * K * C::SP + kx;
    const T* s2 = sm.sv2 + sz * K * C::SP + kx;
    T a[K], v[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      a[m] = s1[m * C::SP];
      v[m] = s2[m * C::SP];
    }
#pragma unroll
    for (int r = 0; r < P; ++r) {
      T w1 = zero, w23 = zero;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (in_band<P>(r, k) && r + k < K) {
          w1 = fma_t(tp.m[r][k], a[r + k], w1);
          w23 = fma_t(tp.l[1][r][k], a[r + k], w23);
          w23 = fma_t(tp.m[r][k], v[r + k], w23);
        }
      sw1[(sz * P + r) * C::SP + kx] = w1;
      sw23[(sz * P + r) * C::SP + kx] = w23;
    }
  }
  __syncthreads();

  // z sweep in gather form, and the epilogue: output plane kz of column
  // (ky, kx) adds the staged planes s = kz .. 2P in ascending order (tap
  // kz + 2P - s of row s mod P), L z w1 then M z w23 -- the march's order
  for (int it = tid; it < C::NG * C::COLS; it += kThreads) {
    const int g = it / C::COLS, col = it - g * C::COLS;
    if (col >= P * P) continue;
    const int ky = col / P, kx = col - ky * P, cw = ky * C::SP + kx;
    const int gy = oy + ky, gx = ox + kx;
    const bool in_yx = gy >= 1 && gy <= Y - 2 && gx >= 1 && gx <= X - 2;
    const T mx = centre<T, P>(tp.m, kx), lx = centre<T, P>(tp.l[2], kx);
    const T my = centre<T, P>(tp.m, ky), ly = centre<T, P>(tp.l[1], ky);
    const T dg1 = my * mx;
    const T dg23 = ly * mx + my * lx;
#pragma unroll
    for (int gg = 0; gg < C::NG; ++gg) {
      if (gg != g) continue;  // the same for a whole warp
#pragma unroll
      for (int kz = gg * P / C::NG; kz < (gg + 1) * P / C::NG; ++kz) {
        const int gz = oz + kz;
        const int64_t gi = ((int64_t)gz * Y + gy) * X + gx;
        const bool in = in_yx && gz >= 1 && gz <= Z - 2;
        T ex = zero, eb = zero, eo = zero;
        if (MODE == kCheb || (need_x && !in)) ex = x[gi];
        if (need_b) eb = b[gi];
        if (need_xo) eo = x_old[gi];
        T acc = zero;
#pragma unroll
        for (int s = kz; s < K; ++s) {
          const int rho = s % P, t = kz + 2 * P - s;
          if (in_band<P>(rho, t)) {
            acc = fma_t(tp.l[0][rho][t], sw1[s * P * C::SP + cw], acc);
            acc = fma_t(tp.m[rho][t], sw23[s * P * C::SP + cw], acc);
          }
        }
        T val;
        if (!in) {
          val = dirichlet<MODE>(ex, eb, eo, f1, f2);
        } else if (MODE == kApply || MODE == kVmult) {
          val = acc;
        } else if (MODE == kResidual) {
          val = eb - acc;
        } else {
          const T d = tp.l[0][kz][P] * dg1 + tp.m[kz][P] * dg23;
          val = ex + f1 * (ex - eo) + f2 * (eb - acc) / d;
        }
        out[gi] = val;
      }
    }
  }

  // the boundary nodes o + P of the last cell of an axis
  const bool last_z = oz + P == Z - 1, last_y = oy + P == Y - 1,
             last_x = ox + P == X - 1;
  if (last_z || last_y || last_x) {
    for (int i = tid; i < (P + 1) * (P + 1) * (P + 1); i += kThreads) {
      const int kz = i / ((P + 1) * (P + 1)), rest = i - kz * (P + 1) * (P + 1);
      const int ky = rest / (P + 1), kx = rest - ky * (P + 1);
      if ((kz < P && ky < P && kx < P) || (kz == P && !last_z) ||
          (ky == P && !last_y) || (kx == P && !last_x))
        continue;
      const int64_t gi = ((int64_t)(oz + kz) * Y + oy + ky) * X + ox + kx;
      out[gi] = dirichlet<MODE>(need_x ? x[gi] : zero, need_b ? b[gi] : zero,
                                need_xo ? x_old[gi] : zero, f1, f2);
    }
  }
}

template <typename T, int P, int MODE>
int launch_cell(const T* x, const T* b, const T* x_old, T* out,
                const T* taps, T f1, T f2, int Z, int Y, int X,
                cudaStream_t stream) {
  constexpr int kSmem = (int)sizeof(CellSmem<T, P>);
  static bool ready = false;
  if (!ready) {
    if (kSmem > 48 * 1024)
      cudaFuncSetAttribute(brick_cell_kernel<T, P, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    ready = true;
  }
  Taps<T, P> tp;
  memcpy(&tp, taps, sizeof(tp));
  const dim3 grid((X - 1) / P, (Y - 1) / P, (Z - 1) / P);
  brick_cell_kernel<T, P, MODE><<<grid, kThreads, kSmem, stream>>>(
      x, b, x_old, out, tp, f1, f2, Z, Y, X);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- p >= 8
// The layer march (the note at the top says when it runs and why): a
// block owns an x-y tile of TXC x TYC cells and marches along z by cell
// layers through a run of them.  Per group of G input planes it stages
// the planes with their x-y halo, runs the x sweeps and the y sweeps over
// the whole group (one item a row, or column, cell and plane) and keeps
// w1, w23 in a ring of P + 1 planes in shared memory; once a layer's top
// vertex plane is in, the z sweep gathers each column's P outputs of that
// layer from the ring.  Each node adds the taps of brick_kron_kernel in
// its order: the input planes in ascending order, L then M; a vertex
// output's planes below its layer are carried in a register (one a
// column) from the layer before.  Launched in one wave: block i of the
// work blocks takes the i-th equal run of the (tile, cell layer) units,
// tile-major, so a run may end in one tile and go on in the next; a few
// blocks in front write the Dirichlet nodes that no tile holds.

// the tile: cells in x and y, input planes a group, threads, the launch
// bound's blocks an SM (BRICK_LAYER_VARIANT = P with BRICK_LAYER_TXC,
// _TYC, _G, _THREADS, _MIN_BLOCKS overrides them at that degree, for
// tuning builds: time_brick --layer-variant)
template <int P>
struct LayerShape {
  static constexpr int TXC = 4, TYC = P == 9 ? 4 : 3;
  static constexpr int G = P == 9 ? 3 : 4;
  static constexpr int THREADS = 384;
  static constexpr int MIN_BLOCKS = 1;
};
#ifdef BRICK_LAYER_VARIANT
template <>
struct LayerShape<BRICK_LAYER_VARIANT> {
  static constexpr int TXC = BRICK_LAYER_TXC, TYC = BRICK_LAYER_TYC;
  static constexpr int G = BRICK_LAYER_G;
  static constexpr int THREADS = BRICK_LAYER_THREADS;
  static constexpr int MIN_BLOCKS = BRICK_LAYER_MIN_BLOCKS;
};
#endif

template <typename T, int P>
struct Layer {
  using S = LayerShape<P>;
  static constexpr int K = 2 * P + 1;
  static constexpr int R = P + 1;  // ring planes: a layer, both vertices
  static constexpr int TXC = S::TXC, TYC = S::TYC, G = S::G;
  static constexpr int THREADS = S::THREADS, MIN_BLOCKS = S::MIN_BLOCKS;
  static constexpr int TX = TXC * P, TY = TYC * P;
  static constexpr int RY = TY + P + 1;  // staged rows (halo P before, 1 after)
  static constexpr int WX = TX + P + 1;  // staged row length
  static constexpr int SU = WX | 1;      // odd: rows on distinct banks
  static constexpr int SV = TX | 1;
  static constexpr int NCOL = TX * TY;
  static constexpr int CPT = (NCOL + THREADS - 1) / THREADS;
  static constexpr int GU = G * RY * SU;  // a staged group
  static constexpr int GV = G * RY * SV;  // a group's v1 (or v2)
  static_assert(P % G == 0, "a cell layer is whole groups of planes");
};

template <typename T, int P>
struct LayerSmem {
  using L = Layer<T, P>;
  T ring[L::R][2][L::NCOL];  // w1, w23 of plane j in slot j mod (P + 1)
  T su[2][L::GU];            // staged groups of x (double-buffered)
  T sv[2][L::GV];            // Mx u, Lx u of a group
  int soff[L::RY * L::WX];   // staged node -> offset in a plane
};

// the outputs [c0 P, c1 P) of the tile at (x0, y0) (and the Dirichlet
// plane Z - 1 if c1 is the last cell): the groups of input planes from
// the halo below c0 up to plane c1 P, a z sweep at every layer's top
template <typename T, int P, int MODE>
__device__ __forceinline__ void layer_run(LayerSmem<T, P>& sm,
                                          const T* __restrict__ x,
                                          const T* b, const T* x_old, T* out,
                                          const Taps<T, P>& tp, T f1, T f2,
                                          int Z, int Y, int X, int x0, int y0,
                                          int c0, int c1) {
  using L = Layer<T, P>;
  constexpr int K = L::K, R = L::R, G = L::G;
  const int tid = threadIdx.x;
  const bool need_x = MODE != kApply;
  const bool need_b = MODE == kResidual || MODE == kCheb;
  const bool need_xo = MODE == kCheb && x_old != nullptr;
  const T zero = T(0);
  const int64_t plane = (int64_t)Y * X;

  __syncthreads();  // the previous run's reads of soff and the ring are done

  // owned columns: offset in a plane (-1 outside the grid), interior bits,
  // diagonal factors, the carried partial sum of the next vertex output
  int coff[L::CPT];
  unsigned cin = 0;
  T dg1[L::CPT], dg23[L::CPT], carry[L::CPT];
#pragma unroll
  for (int q = 0; q < L::CPT; ++q) {
    const int col = tid + q * L::THREADS;
    const int gx = x0 + col % L::TX, gy = y0 + col / L::TX;
    coff[q] = col < L::NCOL && gx < X && gy < Y ? gy * X + gx : -1;
    if (gx >= 1 && gx <= X - 2 && gy >= 1 && gy <= Y - 2) cin |= 1u << q;
    const int rx = (col % L::TX) % P, ry = (col / L::TX) % P;
    const T mx = centre<T, P>(tp.m, rx), lx = centre<T, P>(tp.l[2], rx);
    const T my = centre<T, P>(tp.m, ry), ly = centre<T, P>(tp.l[1], ry);
    dg1[q] = my * mx;
    dg23[q] = ly * mx + my * lx;
    carry[q] = zero;
  }
  for (int i = tid; i < L::RY * L::WX; i += L::THREADS) {
    const int row = i / L::WX, c = i - row * L::WX;
    const int gy = y0 - P + row, gx = x0 - P + c;
    sm.soff[i] = gy >= 1 && gy <= Y - 2 && gx >= 1 && gx <= X - 2
                     ? gy * X + gx
                     : -1;
  }
  __syncthreads();

  // groups of G planes from jstart up to c1 P; the first z sweep is at
  // layer c0 - 1 (no outputs: it starts the carry of output c0 P), or at
  // layer 0 when c0 = 0 (plane 0 is Dirichlet: nothing to carry)
  const int o = c0 * P;
  const int jstart = c0 == 0 ? 1 - G : o - P - G + 1;
  const int ngroups = (c1 * P - jstart + 1) / G;
  const int zfirst = c0 == 0 ? 0 : o - P;

  // stage group gi (planes jstart + gi G ..) of x into dst; Dirichlet and
  // outside nodes (planes outside [1, Z - 2] too) as 0
  auto stage = [&](int gi, T* dst) {
    const int jg = jstart + gi * G;
    for (int i = tid; i < G * L::RY * L::WX; i += L::THREADS) {
      const int g = i / (L::RY * L::WX), rest = i - g * (L::RY * L::WX);
      const int row = rest / L::WX, c = rest - row * L::WX;
      const int jz = jg + g, off = sm.soff[rest];
      const bool ok = off >= 0 && jz >= 1 && jz <= Z - 2;
      cp_async(dst + (g * L::RY + row) * L::SU + c,
               ok ? x + jz * plane + off : x, ok ? (int)sizeof(T) : 0);
    }
    cp_async_commit();
  };
  stage(0, sm.su[0]);
  if (ngroups > 1)
    stage(1, sm.su[1]);
  else
    cp_async_commit();

  for (int gi = 0; gi < ngroups; ++gi) {
    const int jg = jstart + gi * G;
    cp_async_wait1();
    __syncthreads();

    // x sweeps: rows of the group's staged planes, one cell per item
    const T* s_in = sm.su[gi & 1];
    for (int it = tid; it < G * L::RY * L::TXC; it += L::THREADS) {
      const int row = it % L::RY, rest = it / L::RY;
      const int c = rest % L::TXC, g = rest / L::TXC;
      const T* s = s_in + (g * L::RY + row) * L::SU + c * P;
      T u[K];
#pragma unroll
      for (int m = 0; m < K; ++m) u[m] = s[m];
      T* o1 = sm.sv[0] + (g * L::RY + row) * L::SV + c * P;
      T* o2 = sm.sv[1] + (g * L::RY + row) * L::SV + c * P;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        T a1 = zero, a2 = zero;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (in_band<P>(r, k) && r + k < K) {
            a1 = fma_t(tp.m[r][k], u[r + k], a1);
            a2 = fma_t(tp.l[2][r][k], u[r + k], a2);
          }
        o1[r] = a1;
        o2[r] = a2;
      }
    }
    __syncthreads();
    if (gi + 2 < ngroups)
      stage(gi + 2, sm.su[gi & 1]);
    else
      cp_async_commit();

    // y sweeps: columns of the group's planes, one cell per item, into the
    // ring slots of the planes
    for (int it = tid; it < G * L::TX * L::TYC; it += L::THREADS) {
      const int xx = it % L::TX, rest = it / L::TX;
      const int c = rest % L::TYC, g = rest / L::TYC;
      const T* s1 = sm.sv[0] + (g * L::RY + c * P) * L::SV + xx;
      const T* s2 = sm.sv[1] + (g * L::RY + c * P) * L::SV + xx;
      T a[K], v[K];
#pragma unroll
      for (int m = 0; m < K; ++m) {
        a[m] = s1[m * L::SV];
        v[m] = s2[m * L::SV];
      }
      T* w = sm.ring[(jg + g + 2 * R) % R][0] + c * P * L::TX + xx;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        T w1 = zero, w23 = zero;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (in_band<P>(r, k) && r + k < K) {
            w1 = fma_t(tp.m[r][k], a[r + k], w1);
            w23 = fma_t(tp.l[1][r][k], a[r + k], w23);
            w23 = fma_t(tp.m[r][k], v[r + k], w23);
          }
        w[r * L::TX] = w1;
        w[L::NCOL + r * L::TX] = w23;
      }
    }

    // a layer's top vertex plane is in: the z sweep of layer [bz, bz + P]
    const int bz = jg + G - 1 - P;
    if (gi % (P / G) != 0 || bz < zfirst) continue;  // the same for all
    __syncthreads();
    const bool emit = bz >= o;
    const int slot0 = (bz + 2 * R) % R;
#pragma unroll
    for (int q = 0; q < L::CPT; ++q) {
      const int col = tid + q * L::THREADS;
      if (col >= L::NCOL) continue;
      // epilogue inputs of the output planes bz .. bz + P - 1, loaded
      // ahead of the gather
      T ex[P], eb[P], eo[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        ex[k] = eb[k] = eo[k] = zero;
        if (emit && coff[q] >= 0) {
          const int iz = bz + k;
          const int64_t g = iz * plane + coff[q];
          const bool in = iz >= 1 && iz <= Z - 2 && (cin >> q & 1u);
          if (MODE == kCheb || (need_x && !in)) ex[k] = x[g];
          if (need_b) eb[k] = b[g];
          if (need_xo) eo[k] = x_old[g];
        }
      }
      // gather: output bz + k adds plane bz + s (residue s mod P) with tap
      // k - s + P, planes ascending; output bz has planes up to bz in its
      // carry, output bz + P starts the next carry
      T acc[R];
      acc[0] = carry[q];
#pragma unroll
      for (int k = 1; k < R; ++k) acc[k] = zero;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int sl = slot0 + s < R ? slot0 + s : slot0 + s - R;
        const T w1 = sm.ring[sl][0][col], w23 = sm.ring[sl][1][col];
        const int rho = s % P;
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (s > 0 || k > 0) {
            acc[k] = fma_t(tp.l[0][rho][k - s + P], w1, acc[k]);
            acc[k] = fma_t(tp.m[rho][k - s + P], w23, acc[k]);
          }
      }
      carry[q] = acc[P];
      if (!emit || coff[q] < 0) continue;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int iz = bz + k;
        const int64_t g = iz * plane + coff[q];
        const bool in = iz >= 1 && iz <= Z - 2 && (cin >> q & 1u);
        const T a = acc[k];
        T val;
        if (!in) {
          val = dirichlet<MODE>(ex[k], eb[k], eo[k], f1, f2);
        } else if (MODE == kApply || MODE == kVmult) {
          val = a;
        } else if (MODE == kResidual) {
          val = eb[k] - a;
        } else {
          const T d = tp.l[0][k][P] * dg1[q] + tp.m[k][P] * dg23[q];
          val = ex[k] + f1 * (ex[k] - eo[k]) + f2 * (eb[k] - a) / d;
        }
        out[g] = val;
      }
    }
  }
  cp_async_wait0();

  // the last node plane, Dirichlet
  if (c1 == (Z - 1) / P) {
#pragma unroll
    for (int q = 0; q < L::CPT; ++q) {
      if (coff[q] < 0) continue;
      const int64_t g = (Z - 1) * plane + coff[q];
      out[g] = dirichlet<MODE>(need_x ? x[g] : zero, need_b ? b[g] : zero,
                               need_xo ? x_old[g] : zero, f1, f2);
    }
  }
}

template <typename T, int P, int MODE>
__global__ void __launch_bounds__(Layer<T, P>::THREADS,
                                  Layer<T, P>::MIN_BLOCKS)
    brick_layer_kernel(const T* __restrict__ x, const T* b, const T* x_old,
                       T* out, const __grid_constant__ Taps<T, P> tp, T f1,
                       T f2, int Z, int Y, int X, int tiles_x, int units,
                       int ndir) {
  using L = Layer<T, P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LayerSmem<T, P>& sm = *reinterpret_cast<LayerSmem<T, P>*>(smem_raw);
  const int cells_z = (Z - 1) / P;

  if ((int)blockIdx.x < ndir) {
    // the Dirichlet nodes that no tile holds: the node plane x = X - 1 if
    // the tiles end one node short of it, and y = Y - 1 likewise
    const bool need_x = MODE != kApply;
    const bool need_b = MODE == kResidual || MODE == kCheb;
    const bool need_xo = MODE == kCheb && x_old != nullptr;
    const T zero = T(0);
    const bool xrem = tiles_x * L::TX == X - 1;
    const bool yrem = ((Y - 2) / L::TY + 1) * L::TY == Y - 1;
    const int wx = xrem ? X - 1 : X;
    const int64_t nx = xrem ? (int64_t)Z * Y : 0;
    const int64_t n = nx + (yrem ? (int64_t)Z * wx : 0);
    for (int64_t i = (int64_t)blockIdx.x * L::THREADS + threadIdx.x; i < n;
         i += (int64_t)ndir * L::THREADS) {
      int64_t g;
      if (i < nx) {
        g = i * X + X - 1;
      } else {
        const int64_t j = i - nx;
        g = (j / wx * Y + Y - 1) * X + j % wx;
      }
      out[g] = dirichlet<MODE>(need_x ? x[g] : zero, need_b ? b[g] : zero,
                               need_xo ? x_old[g] : zero, f1, f2);
    }
    return;
  }
  // this block's run of units (tile-major: unit = tile * cells_z + cell)
  const int nwork = gridDim.x - ndir, bid = blockIdx.x - ndir;
  const int u_end = (int)((int64_t)(bid + 1) * units / nwork);
  for (int u = (int)((int64_t)bid * units / nwork); u < u_end;) {
    const int tile = u / cells_z, c0 = u - tile * cells_z;
    const int c1 = min(cells_z, c0 + (u_end - u));
    u += c1 - c0;
    layer_run<T, P, MODE>(sm, x, b, x_old, out, tp, f1, f2, Z, Y, X,
                          tile % tiles_x * L::TX, tile / tiles_x * L::TY, c0,
                          c1);
  }
}

template <typename T, int P, int MODE>
int launch_layer(const T* x, const T* b, const T* x_old, T* out,
                 const T* taps, T f1, T f2, int Z, int Y, int X,
                 cudaStream_t stream) {
  using L = Layer<T, P>;
  constexpr int kSmem = (int)sizeof(LayerSmem<T, P>);
  static_assert(kSmem <= 232448, "the layer tile exceeds a block's shared "
                                 "memory");
  const auto kernel = brick_layer_kernel<T, P, MODE>;
  // one wave: as many work blocks as the card holds at once
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::THREADS,
                                                  kSmem);
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  Taps<T, P> tp;
  memcpy(&tp, taps, sizeof(tp));
  const int tiles_x = (X - 2) / L::TX + 1, tiles_y = (Y - 2) / L::TY + 1;
  const int units = tiles_x * tiles_y * ((Z - 1) / P);
  const int nwork = min(units, slots);
  const bool xrem = tiles_x * L::TX == X - 1, yrem = tiles_y * L::TY == Y - 1;
  const int64_t nd = (xrem ? (int64_t)Z * Y : 0) +
                     (yrem ? (int64_t)Z * (xrem ? X - 1 : X) : 0);
  const int ndir = (int)((nd + 16 * L::THREADS - 1) / (16 * L::THREADS));
  kernel<<<ndir + nwork, L::THREADS, kSmem, stream>>>(
      x, b, x_old, out, tp, f1, f2, Z, Y, X, tiles_x, units, ndir);
  return (int)cudaGetLastError();
}

// the layer march's tile at P (cells in x, y, planes a group, threads,
// shared bytes, blocks an SM from the occupancy calculator) and the
// z-slab march's shared bytes, into out[0..6]
template <typename T, int P>
int layer_tile(int* out) {
  using L = Layer<T, P>;
  constexpr int kSmem = (int)sizeof(LayerSmem<T, P>);
  const auto kernel = brick_layer_kernel<T, P, kCheb>;
  out[0] = L::TXC;
  out[1] = L::TYC;
  out[2] = L::G;
  out[3] = L::THREADS;
  out[4] = kSmem;
  out[6] = (int)sizeof(Smem<T, P>);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], kernel, L::THREADS,
                                                kSmem);
  return (int)cudaGetLastError();
}

// the layer march's entry (float, p = 8, 9; brick_kron_layer.cu): the
// arguments of brick_kron_entry, form 2
template <typename T>
int brick_layer_entry(int mode, int form, const T* x, const T* b,
                      const T* x_old, T* out, const T* taps, double f1,
                      double f2, int Z, int Y, int X, int p, void* stream,
                      int* launched) {
  *launched = 0;
  if (form != 2 || (p != 8 && p != 9) || mode < kApply || mode > kCheb)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const T g1 = (T)f1, g2 = (T)f2;
  using Fn = int (*)(const T*, const T*, const T*, T*, const T*, T, T, int,
                     int, int, cudaStream_t);
  static const Fn fns[2][4] = {
      {launch_layer<T, 8, kApply>, launch_layer<T, 8, kVmult>,
       launch_layer<T, 8, kResidual>, launch_layer<T, 8, kCheb>},
      {launch_layer<T, 9, kApply>, launch_layer<T, 9, kVmult>,
       launch_layer<T, 9, kResidual>, launch_layer<T, 9, kCheb>}};
  const int err = fns[p - 8][mode](x, b, x_old, out, taps, g1, g2, Z, Y, X, s);
  if (err == cudaSuccess) *launched = 1;
  return err;
}

// form 0: the z-slab march (p <= 7, float at p = 8, 9, and both types at
// p >= 10, where the cell form's (2p + 1)^3 neighbourhood outgrows a
// block's shared memory); form 1: the cell form (p = 8, 9; in double the
// only one there, faster on every grid)
template <typename T, int P, int MODE>
int launch_form(int form, const T* x, const T* b, const T* x_old, T* out,
                const T* taps, T f1, T f2, int Z, int Y, int X,
                cudaStream_t stream) {
  if constexpr (P >= kCellDegree && P < kWideDegree) {
    if (form == 1)
      return launch_cell<T, P, MODE>(x, b, x_old, out, taps, f1, f2, Z, Y, X,
                                     stream);
  }
  if constexpr (P < kCellDegree || sizeof(T) == 4 || P >= kWideDegree) {
    if (form == 0)
      return launch_mode<T, P, MODE>(x, b, x_old, out, taps, f1, f2, Z, Y,
                                     X, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int P>
int launch_degree(int mode, int form, const T* x, const T* b, const T* x_old,
                  T* out, const T* taps, T f1, T f2, int Z, int Y, int X,
                  cudaStream_t stream) {
  switch (mode) {
    case kApply:
      return launch_form<T, P, kApply>(form, x, b, x_old, out, taps, f1, f2,
                                       Z, Y, X, stream);
    case kVmult:
      return launch_form<T, P, kVmult>(form, x, b, x_old, out, taps, f1, f2,
                                       Z, Y, X, stream);
    case kResidual:
      return launch_form<T, P, kResidual>(form, x, b, x_old, out, taps, f1,
                                          f2, Z, Y, X, stream);
    case kCheb:
      return launch_form<T, P, kCheb>(form, x, b, x_old, out, taps, f1, f2,
                                      Z, Y, X, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// degrees LO..HI: launch_degree at p, else cudaErrorInvalidValue
template <typename T, int LO, int HI>
int launch_degrees(int p, int mode, int form, const T* x, const T* b,
                   const T* x_old, T* out, const T* taps, T f1, T f2, int Z,
                   int Y, int X, cudaStream_t stream) {
  if constexpr (LO > HI) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p == LO)
      return launch_degree<T, LO>(mode, form, x, b, x_old, out, taps, f1, f2,
                                  Z, Y, X, stream);
    return launch_degrees<T, LO + 1, HI>(p, mode, form, x, b, x_old, out,
                                         taps, f1, f2, Z, Y, X, stream);
  }
}

// The entry of the degrees LO..HI.  mode: 0 apply, 1 vmult, 2 residual, 3
// cheb.  form: 0 the z-slab march, 1 the cell form (p = 8, 9 only).
// taps: host array of 4 * p * (2p + 1) values of T (M, c_z L_z, c_y L_y,
// c_x L_x; each [p][2p + 1]).
template <typename T, int LO, int HI>
int brick_kron_range(int mode, int form, const T* x, const T* b,
                     const T* x_old, T* out, const T* taps, double f1,
                     double f2, int Z, int Y, int X, int p, void* stream,
                     int* launched) {
  *launched = 0;
  const int err = launch_degrees<T, LO, HI>(
      p, mode, form, x, b, x_old, out, taps, (T)f1, (T)f2, Z, Y, X,
      (cudaStream_t)stream);
  if (err == cudaSuccess) *launched = 1;
  return err;
}

// brick_kron_f32 / brick_kron_f64: p = 1..9 here, p = 10..16 in
// brick_kron_wide.cu / brick_kron_wide_f64.cu (their own translation
// units, built in parallel)
template <typename T>
int brick_kron_entry(int mode, int form, const T* x, const T* b,
                     const T* x_old, T* out, const T* taps, double f1,
                     double f2, int Z, int Y, int X, int p, void* stream,
                     int* launched) {
  if (p >= kWideDegree) {
    if constexpr (sizeof(T) == 4)
      return brick_kron_wide_f32(mode, form, x, b, x_old, out, taps, f1, f2,
                                 Z, Y, X, p, stream, launched);
    else
      return brick_kron_wide_f64(mode, form, x, b, x_old, out, taps, f1, f2,
                                 Z, Y, X, p, stream, launched);
  }
  return brick_kron_range<T, 1, kWideDegree - 1>(
      mode, form, x, b, x_old, out, taps, f1, f2, Z, Y, X, p, stream,
      launched);
}

}  // namespace
