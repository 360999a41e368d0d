// CG vector kernels for Hopper (sm_90a), all in native fp64.
//
// cg_update replaces K3  multigrid_tpu/ops/pallas_pairvec.py _axpy_kernel
//   (pair_axpy_kernel: y + a x in df64 on [Z, 2, Yp, G] f32 pairs).  One
//   pass does x += alpha p and r -= alpha q and writes per-block partial
//   sums of |r|^2; the reference's merged CG update
//   (SURVEY: laplace_operator.h:638-719).
// cg_xpay is the other use of K3 in CG: p = z + beta p in place, with
//   16-byte double2 accesses, one a thread over a grid that covers the
//   vector (about 33,000 blocks at 17M doubles); a scalar head and tail take
//   a start off a 16-byte boundary and an odd n, and p and z of different
//   16-byte phase take one element a thread.  On the H100 this one-shot
//   grid came out faster than grid-stride loops over one wave of blocks
//   with 2-4 vectors in flight per thread, which lost to torch.add: the
//   block scheduler keeps the SMs full and the addresses advance in order.
// cg_dot replaces K3' multigrid_tpu/ops/pallas_pairvec.py _dot_kernel
//   (pair_dot_kernel: sum w a b with 0/1 duplicate-slot weights,
//   compensated): a . b.  On the node grid every dof appears once, so the
//   duplicate weights vanish.  The xpay cannot share the dot's pass in CG:
//   its beta is the ratio of the dot just taken.
//
// Reductions: a fixed grid of at most kMaxBlocks blocks walks the vector
// with a grid stride; each block reduces in registers and shared memory
// and writes one partial; a second launch of one block sums the partials.
// No atomics: the order of the sums depends only on n, so a result is the
// same from run to run.
//
// Every entry point writes the number of kernels it launched to *launched
// (2 for a reduction, 1 for cg_xpay).
//
// What bounds them: device memory bandwidth (cg_update moves 6 doubles a
// dof, cg_dot 2, cg_xpay 3); no cache reuse exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // == _build.REDUCTION_BLOCKS

__device__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // valid in thread 0
}

__global__ void cg_update_kernel(double* __restrict__ x, double* __restrict__ r,
                                 const double* __restrict__ p,
                                 const double* __restrict__ q, double alpha,
                                 int64_t n, double* __restrict__ partial) {
  double acc = 0.0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    x[i] += alpha * p[i];
    const double rn = r[i] - alpha * q[i];
    r[i] = rn;
    acc += rn * rn;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void dot_kernel(const double* __restrict__ a,
                           const double* __restrict__ b, int64_t n,
                           double* __restrict__ partial) {
  double acc = 0.0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    acc += a[i] * b[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// p = z + beta p on n elements.  VEC: p + head and z + head are 16-byte
// aligned, and thread t updates double2 t of the body; thread 0 also takes
// the scalar head and the odd tail element.  Otherwise one element a thread.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    xpay_kernel(double* __restrict__ p, const double* __restrict__ z,
                double beta, int64_t n, int head) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (!VEC) {
    if (t < n) p[t] = z[t] + beta * p[t];
    return;
  }
  const int64_t nv = (n - head) / 2;
  if (t < nv) {
    double2* pv = reinterpret_cast<double2*>(p + head);
    const double2 a = reinterpret_cast<const double2*>(z + head)[t];
    const double2 c = pv[t];
    pv[t] = make_double2(a.x + beta * c.x, a.y + beta * c.y);
  }
  if (t == 0) {
    if (head) p[0] = z[0] + beta * p[0];
    const int64_t tail = head + 2 * nv;
    if (tail < n) p[tail] = z[tail] + beta * p[tail];
  }
}

__global__ void finish_sum_kernel(const double* __restrict__ partial, int nb,
                                  double* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

int num_blocks(int64_t n) {
  int64_t nb = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (nb < 1) nb = 1;
  if (nb > kMaxBlocks) nb = kMaxBlocks;
  return (int)nb;
}

}  // namespace

extern "C" {

int cg_update(double* x, double* r, const double* p, const double* q,
              double alpha, long long n, double* partial, double* out,
              void* stream, int* launched) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = num_blocks(n);
  *launched = 1;
  cg_update_kernel<<<nb, kThreads, 0, s>>>(x, r, p, q, alpha, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 2;
  finish_sum_kernel<<<1, kThreads, 0, s>>>(partial, nb, out);
  return (int)cudaGetLastError();
}

int cg_dot(const double* a, const double* b, long long n, double* partial,
           double* out, void* stream, int* launched) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = num_blocks(n);
  *launched = 1;
  dot_kernel<<<nb, kThreads, 0, s>>>(a, b, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 2;
  finish_sum_kernel<<<1, kThreads, 0, s>>>(partial, nb, out);
  return (int)cudaGetLastError();
}

int cg_xpay(double* p, const double* z, double beta, long long n,
            void* stream, int* launched) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
  const uintptr_t za = reinterpret_cast<uintptr_t>(z);
  const int head = (pa % 16) ? 1 : 0;  // doubles are 8-byte aligned
  const bool vec = (pa % 16) == (za % 16) && n > head;
  const int64_t work = vec ? (n - head) / 2 : n;
  const int64_t nb = work > 0 ? (work + kThreads - 1) / kThreads : 1;
  const cudaStream_t s = (cudaStream_t)stream;
  *launched = 1;
  if (vec)
    xpay_kernel<true><<<(unsigned)nb, kThreads, 0, s>>>(p, z, beta, n, head);
  else
    xpay_kernel<false><<<(unsigned)nb, kThreads, 0, s>>>(p, z, beta, n, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
