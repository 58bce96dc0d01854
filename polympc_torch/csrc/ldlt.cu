// Batched dense unpivoted LDL^T factor, factor+solve and solve, and the
// explicit inverse, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   polympc_tpu/ops/ldlt.py : ldlt_factor       (_factor_body)
//   polympc_tpu/ops/ldlt.py : ldlt_factor_solve (_factor_solve_body)
//   polympc_tpu/ops/ldlt.py : ldlt_solve        (_solve_body)
//   polympc_tpu/ops/ldlt.py : ldlt_inverse      (_factor_inverse_body)
// and computes what they compute: for each (K, K) matrix of a batch, the
// unpivoted packed LDL^T (F holds L^T in its strict upper triangle,
// F[i][c] = L[c][i]; d the pivots), alone or with one
// forward/diagonal/backward solve; or the solve alone against a given
// packed factor; or the explicit inverse.  The factor stays unpivoted on
// purpose: the certify pass feeds it indefinite Newton-KKT
// matrices and its iterative-refinement sweeps are tuned to this factor's
// growth (nlp/refine.py).
//
// What bounds it on an H100: latency, not bytes or FLOPs.  The factor is K
// dependent rank-1 updates and each solve 2K dependent pivot steps, each
// ending in a barrier (one __syncthreads per pivot); per matrix the card
// moves ~2*K*K*4 bytes (140 KB at K = 132, 218 KB at the race car's
// K = 165) and does ~K^3/3 flops (the symmetric factor), so at B = 512 the
// bound is some 0.02-0.03 ms (bytes) against the kernels' measured tenths
// of a millisecond.
//
// What the design does about it: one thread block per matrix keeps the
// whole matrix in dynamic shared memory (row stride K+1, so the column walks
// of the backward sweep hit distinct banks), every pivot step is a
// shared-memory update plus one barrier, and three matrices share an SM at
// K = 132 to hide each other's barriers.  The factor's updates round each
// product and difference alone (ptk::sub_product), so the factor equals
// the plain PyTorch version's bit for bit.  The solves substitute in
// double against that float factor (the right-hand side in double in
// shared memory, the result rounded to float once).  On the certify's
// indefinite Newton matrices the factor grows, and the growth amplifies a
// float sweep's rounding: on some lanes a float solve's residual was
// several times an exact solve's against the same factor, whichever order
// it summed in.  In double the solve adds next to nothing to the factor's
// own error.
//
// The inverse (the per-segment Schur elimination of the distributed SQP,
// parallel/horizon.py, one call per ADMM epoch on B*S matrices of K = 72)
// needs ~K^3 flops (the symmetric factor, then the symmetric inverse from
// it) against 2*K*K*4 bytes moved: at 1024 matrices the bytes bound it,
// ~0.013 ms.  It is not computed through the factor: one thread block per
// matrix inverts it by an unpivoted Gauss-Jordan sweep (ptk::sweep_inverse,
// whose pivots are the unpivoted LDL^T's d): K barrier steps and K^3
// multiply-adds, the matrix held in registers for the whole sweep (one
// tile per thread, K up to 192 at 256 threads) and only the pivot vectors
// in shared memory.  The block stages the matrix through shared memory
// (row stride K+1; K(K+1) + 4 + 4 * 32 * ceil(K/32) floats, 22 KB at
// K = 72) to load and store it coalesced.  What bounds it then is the
// chain of K pivot steps, each a barrier and a few dependent loads.
//
// Layouts (batch-major, contiguous, float): M, F, Minv (B, K, K); b, x, d
// (B, K).
#include <cuda_runtime.h>

#include "ldlt_device.cuh"

namespace {

template <typename T>
__device__ void load_matrix(T* S, const T* G, int K, int ldk) {
  for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x)
    S[(idx / K) * ldk + idx % K] = G[idx];
}

template <typename T>
__device__ void store_factor(T* F, T* d, const T* Fs, const T* ds, int K,
                             int ldk, size_t off) {
  for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x)
    F[off * K + idx] = Fs[(idx / K) * ldk + idx % K];
  for (int r = threadIdx.x; r < K; r += blockDim.x) d[off + r] = ds[r];
}

template <typename T>
__global__ void ldlt_factor_kernel(const T* __restrict__ M,
                                   T* __restrict__ F, T* __restrict__ d,
                                   int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Fs = reinterpret_cast<T*>(smem_raw);
  const int ldk = K + 1;
  T* ds = Fs + size_t(K) * ldk;
  const size_t off = size_t(blockIdx.x) * K;
  load_matrix(Fs, M + off * K, K, ldk);
  ptk::factor_block(Fs, ds, K, ldk);
  store_factor(F, d, Fs, ds, K, ldk, off);
}

// The solve kernels' shared memory: the factor (row stride K+1) and d in
// float, then the right-hand side in double, 8-byte aligned.
__host__ __device__ inline size_t solve_rhs_offset(int K) {
  return (size_t(K) * (K + 1) + K + 1) / 2 * 2;
}

template <typename T>
__global__ void ldlt_factor_solve_kernel(const T* __restrict__ M,
                                         const T* __restrict__ b,
                                         T* __restrict__ x, T* __restrict__ F,
                                         T* __restrict__ d, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Fs = reinterpret_cast<T*>(smem_raw);
  const int ldk = K + 1;
  T* ds = Fs + size_t(K) * ldk;
  double* y = reinterpret_cast<double*>(Fs + solve_rhs_offset(K));
  const size_t off = size_t(blockIdx.x) * K;
  load_matrix(Fs, M + off * K, K, ldk);
  for (int r = threadIdx.x; r < K; r += blockDim.x) y[r] = b[off + r];
  ptk::factor_block(Fs, ds, K, ldk);
  store_factor(F, d, Fs, ds, K, ldk, off);
  ptk::solve_block(Fs, ds, K, ldk, y, K, 1);
  for (int r = threadIdx.x; r < K; r += blockDim.x) x[off + r] = T(y[r]);
}

template <typename T>
__global__ void ldlt_solve_kernel(const T* __restrict__ F,
                                  const T* __restrict__ d,
                                  const T* __restrict__ b, T* __restrict__ x,
                                  int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Fs = reinterpret_cast<T*>(smem_raw);
  const int ldk = K + 1;
  T* ds = Fs + size_t(K) * ldk;
  double* y = reinterpret_cast<double*>(Fs + solve_rhs_offset(K));
  const size_t off = size_t(blockIdx.x) * K;
  load_matrix(Fs, F + off * K, K, ldk);
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    ds[r] = d[off + r];
    y[r] = b[off + r];
  }
  ptk::solve_block(Fs, ds, K, ldk, y, K, 1);
  for (int r = threadIdx.x; r < K; r += blockDim.x) x[off + r] = T(y[r]);
}

// Explicit inverse by the in-place Gauss-Jordan sweep.
template <typename T, int RA, int NW>
__global__ void __launch_bounds__(NW * 32)
    ldlt_inverse_kernel(const T* __restrict__ M, T* __restrict__ Minv, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  const int ldk = K + 1;
  const size_t off = size_t(blockIdx.x) * K;
  ptk::load_rows(A, ldk, M + off * K, K, K);
  // the pivot vectors 16-byte aligned after the matrix
  ptk::sweep_inverse<RA, NW>(A, K, ldk, A + (size_t(K) * ldk + 3) / 4 * 4);
  for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x)
    Minv[off * K + idx] = A[(idx / K) * ldk + idx % K];
}

template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace

extern "C" {

size_t pt_ldlt_smem_bytes(int K) {
  return solve_rhs_offset(K) * sizeof(float) + size_t(K) * sizeof(double);
}

int pt_ldlt_factor_f32(const float* M, float* F, float* d, int B, int K,
                       int threads, void* stream) {
  const size_t smem = pt_ldlt_smem_bytes(K);
  if (int rc = allow_smem(ldlt_factor_kernel<float>, smem)) return rc;
  ldlt_factor_kernel<float><<<B, threads, smem, (cudaStream_t)stream>>>(
      M, F, d, K);
  return int(cudaGetLastError());
}

int pt_ldlt_factor_solve_f32(const float* M, const float* b, float* x,
                             float* F, float* d, int B, int K, int threads,
                             void* stream) {
  const size_t smem = pt_ldlt_smem_bytes(K);
  if (int rc = allow_smem(ldlt_factor_solve_kernel<float>, smem)) return rc;
  ldlt_factor_solve_kernel<float><<<B, threads, smem, (cudaStream_t)stream>>>(
      M, b, x, F, d, K);
  return int(cudaGetLastError());
}

int pt_ldlt_solve_f32(const float* F, const float* d, const float* b,
                      float* x, int B, int K, int threads, void* stream) {
  const size_t smem = pt_ldlt_smem_bytes(K);
  if (int rc = allow_smem(ldlt_solve_kernel<float>, smem)) return rc;
  ldlt_solve_kernel<float><<<B, threads, smem, (cudaStream_t)stream>>>(
      F, d, b, x, K);
  return int(cudaGetLastError());
}

size_t pt_ldlt_inverse_smem_bytes(int K) {
  return (size_t(K) * (K + 1) + 4 + 4 * size_t((K + 31) / 32 * 32)) *
         sizeof(float);
}

// 1 if the inverse kernel, built at 256 threads per block, holds K (the
// register tile of the sweep; ldlt_device.cuh).
int pt_ldlt_inverse_fits(int K) {
  return ptk::with_tile<8>(K, [](auto, auto) { return 0; }) == 0;
}

// threads must be 256: the argument keeps the C interface of the other
// pt_ldlt_* entry points.
int pt_ldlt_inverse_f32(const float* M, float* Minv, int B, int K,
                        int threads, void* stream) {
  const size_t smem = pt_ldlt_inverse_smem_bytes(K);
  if (threads != 256) return int(cudaErrorInvalidValue);
  return ptk::with_tile<8>(K, [&](auto ra, auto nw) {
    constexpr int RA = decltype(ra)::value, NW = decltype(nw)::value;
    auto kernel = ldlt_inverse_kernel<float, RA, NW>;
    if (int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<B, NW * 32, smem, (cudaStream_t)stream>>>(M, Minv, K);
    return int(cudaGetLastError());
  });
}

}  // extern "C"
