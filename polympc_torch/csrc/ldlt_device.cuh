// Block-cooperative unpivoted LDL^T primitives on shared memory, shared by
// the BBT epoch kernels (bbt_epoch.cu) and the dense LDL^T kernels (ldlt.cu).
//
// Packed storage, as in the JAX package (polympc_tpu/ops/ldlt.py): a (k, k)
// block with row stride ldk holds L^T in its strict upper triangle
// (F[i][c] = L[c][i] for c > i), the pivots d separately, and in its lower
// triangle the Schur-complement values the recurrence left there (never
// read).  ldk = k + 1 keeps column walks free of shared-memory bank
// conflicts.
//
// Every function is called by all threads of the block and returns after a
// __syncthreads(): its results are visible to the whole block.
#pragma once

#include <cuda_runtime.h>

namespace ptk {

// In-place LDL^T of the (k, k) block F: pivot i reads row i (its
// trailing part is column i by symmetry), applies the rank-1 update
// F[j][c] -= F[i][j] * (F[i][c] / d_i) to every j, c > i, and scales row i
// into L^T one pivot later, when no thread reads it any more.  One barrier
// per pivot.
template <typename T>
__device__ void factor_block(T* F, T* d, int k, int ldk) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  __syncthreads();
  for (int i = 0; i < k; ++i) {
    const T* rowi = F + i * ldk;
    const T di = rowi[i];
    const T dinv = T(1) / di;
    const int nt = k - i - 1;
    for (int idx = tid; idx < nt * nt; idx += nthr) {
      const int j = i + 1 + idx / nt;
      const int c = i + 1 + idx % nt;
      F[j * ldk + c] -= rowi[j] * (rowi[c] * dinv);
    }
    if (i > 0) {
      const T dprev = T(1) / d[i - 1];
      T* rowp = F + (i - 1) * ldk;
      for (int c = i + tid; c < k; c += nthr) rowp[c] *= dprev;
    }
    if (tid == 0) d[i] = di;
    __syncthreads();
  }
}

// Solve (L D L^T) Y = Y in place for nrhs right-hand sides stored as rows
// of Y (Y[c * ldy + r]), against a block factored by factor_block.
// Forward and backward sweeps are both column-oriented (axpy per pivot,
// one barrier per pivot).
template <typename T>
__device__ void solve_block(const T* F, const T* d, int k, int ldk, T* Y,
                            int ldy, int nrhs) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  __syncthreads();
  for (int j = 0; j < k - 1; ++j) {
    const int nt = k - j - 1;
    const T* rowj = F + j * ldk;
    for (int idx = tid; idx < nrhs * nt; idx += nthr) {
      const int c = idx / nt;
      const int r = j + 1 + idx % nt;
      Y[c * ldy + r] -= rowj[r] * Y[c * ldy + j];
    }
    __syncthreads();
  }
  for (int idx = tid; idx < nrhs * k; idx += nthr) {
    const int c = idx / k, r = idx % k;
    Y[c * ldy + r] /= d[r];
  }
  __syncthreads();
  for (int i = k - 1; i > 0; --i) {
    for (int idx = tid; idx < nrhs * i; idx += nthr) {
      const int c = idx / i, r = idx % i;
      Y[c * ldy + r] -= F[r * ldk + i] * Y[c * ldy + i];
    }
    __syncthreads();
  }
}

}  // namespace ptk
