// Batched dense unpivoted LDL^T factor, factor+solve and solve, for NVIDIA
// Hopper (sm_90a).
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
// packed factor; or the factor followed by the identity solved as a block
// of K right-hand sides, written out as the explicit inverse.  The factor
// stays
// unpivoted on purpose: the certify pass feeds it indefinite Newton-KKT
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
// K = 132 to hide each other's barriers.
//
// The inverse (the per-segment Schur elimination of the distributed SQP,
// parallel/horizon.py, one call per ADMM epoch on B*S matrices of K = 72)
// needs ~K^3 flops (the symmetric factor, then the symmetric inverse from
// it) against 2*K*K*4 bytes moved: at 1024 matrices the bytes bound it,
// ~0.013 ms.  The kernel does more than that: it updates the whole
// trailing block at each pivot and sweeps all K columns forward and
// backward in full (~2K^3/3 + 2K^3 flops).  The same one block per matrix
// holds the factor and the K x K right-hand-side block in shared memory
// ((2K^2 + 3K) * 4 bytes: 42 KB at K = 72, K up to 169 fits in 227 KB);
// each sweep step updates K columns at once between two barriers.
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

template <typename T>
__global__ void ldlt_factor_solve_kernel(const T* __restrict__ M,
                                         const T* __restrict__ b,
                                         T* __restrict__ x, T* __restrict__ F,
                                         T* __restrict__ d, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Fs = reinterpret_cast<T*>(smem_raw);
  const int ldk = K + 1;
  T* ds = Fs + size_t(K) * ldk;
  T* y = ds + K;
  const size_t off = size_t(blockIdx.x) * K;
  load_matrix(Fs, M + off * K, K, ldk);
  for (int r = threadIdx.x; r < K; r += blockDim.x) y[r] = b[off + r];
  ptk::factor_block(Fs, ds, K, ldk);
  store_factor(F, d, Fs, ds, K, ldk, off);
  ptk::solve_block(Fs, ds, K, ldk, y, K, 1);
  for (int r = threadIdx.x; r < K; r += blockDim.x) x[off + r] = y[r];
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
  T* y = ds + K;
  const size_t off = size_t(blockIdx.x) * K;
  load_matrix(Fs, F + off * K, K, ldk);
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    ds[r] = d[off + r];
    y[r] = b[off + r];
  }
  ptk::solve_block(Fs, ds, K, ldk, y, K, 1);
  for (int r = threadIdx.x; r < K; r += blockDim.x) x[off + r] = y[r];
}

// Explicit inverse: the factor (row stride K+1), then the identity as K
// right-hand sides (Y[c][r], column c of the inverse, row stride K+1) swept
// forward, divided by d and swept backward; Minv[r][c] = Y[c][r].
template <typename T>
__global__ void ldlt_inverse_kernel(const T* __restrict__ M,
                                    T* __restrict__ Minv, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Fs = reinterpret_cast<T*>(smem_raw);
  const int ldk = K + 1;
  T* ds = Fs + size_t(K) * ldk;
  T* Y = ds + K;
  const size_t off = size_t(blockIdx.x) * K;
  load_matrix(Fs, M + off * K, K, ldk);
  for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x) {
    const int c = idx / K, r = idx % K;
    Y[c * ldk + r] = T(r == c);
  }
  ptk::factor_block(Fs, ds, K, ldk);
  ptk::solve_block(Fs, ds, K, ldk, Y, ldk, K);
  for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x) {
    const int r = idx / K, c = idx % K;
    Minv[off * K + idx] = Y[c * ldk + r];
  }
}

template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace

extern "C" {

size_t pt_ldlt_smem_bytes(int K) {
  return (size_t(K) * (K + 1) + 2 * size_t(K)) * sizeof(float);
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
  return (2 * size_t(K) * (K + 1) + size_t(K)) * sizeof(float);
}

int pt_ldlt_inverse_f32(const float* M, float* Minv, int B, int K,
                        int threads, void* stream) {
  const size_t smem = pt_ldlt_inverse_smem_bytes(K);
  if (int rc = allow_smem(ldlt_inverse_kernel<float>, smem)) return rc;
  ldlt_inverse_kernel<float><<<B, threads, smem, (cudaStream_t)stream>>>(
      M, Minv, K);
  return int(cudaGetLastError());
}

}  // extern "C"
