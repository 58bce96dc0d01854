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
// F[i][c] = L[c][i]; d the pivots, also on F's diagonal), alone or with one
// forward/diagonal/backward solve; or the solve alone against a given
// packed factor; or the explicit inverse.  The factor stays unpivoted on
// purpose: the certify pass feeds it indefinite Newton-KKT
// matrices and its iterative-refinement sweeps are tuned to this factor's
// growth (nlp/refine.py).
//
// What bounds it on an H100: neither bytes nor the card's flops.  Per
// matrix the card moves ~2*K*K*4 bytes (140 KB at K = 132, 218 KB at the
// race car's K = 165) and the symmetric factor does ~K^3/3 flops, so at
// B = 512 the bound is some 0.02-0.03 ms (bytes).  The factor is K
// dependent rank-1 updates whose element updates run through shared
// memory at a few instructions each, and the solve 2K dependent pivot
// steps: instructions and latency bound it.
//
// What the design does about it: one thread block of 256 threads per
// matrix holds only its upper triangle, packed by rows (ldlt_device.cuh),
// with d in float and the right-hand side in double: K(K+1)/2 + K floats
// and K doubles, 36.7 KB at K = 132 and 56.8 KB at K = 165.  So six
// blocks share an SM at K = 132 and four at K = 165, and each main path's
// 512 matrices run in one wave (792 and 528 slots on 132 SMs); a block
// holds K up to 337.  The launch bounds keep registers from lowering that
// count (40 a thread at six blocks).  The factor (ptk::factor_packed) goes two pivots per barrier:
// every lane keeps both pivots' scaled rows at its columns in registers,
// and each trailing element is loaded, updated twice and stored once, the
// upper triangle only (half the square's updates); each product and
// difference rounds alone (ptk::sub_product), so the factor equals the
// plain PyTorch version's bit for bit.  The returned F carries that upper
// triangle (d on its diagonal) and zeros below.  The solves substitute in
// double against that float factor (ptk::solve_panels): panels of 32
// pivots, a warp solving each panel's unit triangle with shuffles while
// the other warps apply the panel before to the rows beyond, 2 ceil(K/32)
// + 1 barriers (13 at K = 165) against 2K for pivot-by-pivot sweeps; every
// element receives its terms in the column sweeps' order, so x does not
// depend on the panels.  On the certify's indefinite Newton matrices the factor grows,
// and the growth amplifies a float sweep's rounding: on some lanes a float
// solve's residual was several times an exact solve's against the same
// factor, whichever order it summed in.  In double the solve adds next to
// nothing to the factor's own error.
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

constexpr int THREADS = 256;

// Blocks per SM the factor kernels are built for: shared memory holds six
// at K <= 134 and four at the race car's K = 165; at 256 threads, six
// leave 40 registers a thread.
constexpr int min_blocks(int tc) { return tc <= 5 ? 6 : tc == 6 ? 4 : 2; }

// The kernels' shared memory: the packed upper triangle and d in float,
// then the right-hand side in double, 8-byte aligned (offset in floats).
__host__ __device__ inline size_t rhs_offset(int K) {
  return (ptk::packed_size(K) + K + 1) / 2 * 2;
}

// F (K, K) from the packed factor: the upper triangle and the diagonal (d)
// as the plain version leaves them, zeros below; and d.  One warp a row.
__device__ void store_factor(float* __restrict__ F, float* __restrict__ d,
                             const float* P, int K) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < K; r += nw) {
    const float* row = P + ptk::packed_base(r, K);
    for (int c = lane; c < K; c += 32)
      F[size_t(r) * K + c] = c >= r ? row[c] : 0.f;
  }
  for (int r = threadIdx.x; r < K; r += blockDim.x)
    d[r] = P[ptk::packed_base(r, K) + r];
}

template <int TC>
__global__ void __launch_bounds__(THREADS, min_blocks(TC))
    ldlt_factor_kernel(const float* __restrict__ M, float* __restrict__ F,
                       float* __restrict__ d, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* P = reinterpret_cast<float*>(smem_raw);
  const size_t off = size_t(blockIdx.x) * K;
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  ptk::load_upper(P, M + off * K, K, w, nw);
  ptk::factor_packed<TC>(P, K, w, nw, [] { __syncthreads(); });
  store_factor(F + off * K, d + off, P, K);
}

template <int TC>
__global__ void __launch_bounds__(THREADS, min_blocks(TC))
    ldlt_factor_solve_kernel(const float* __restrict__ M,
                             const float* __restrict__ b,
                             float* __restrict__ x, float* __restrict__ F,
                             float* __restrict__ d, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* P = reinterpret_cast<float*>(smem_raw);
  float* ds = P + ptk::packed_size(K);
  double* y = reinterpret_cast<double*>(P + rhs_offset(K));
  const size_t off = size_t(blockIdx.x) * K;
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  ptk::load_upper(P, M + off * K, K, w, nw);
  for (int r = threadIdx.x; r < K; r += blockDim.x) y[r] = b[off + r];
  ptk::factor_packed<TC>(P, K, w, nw, [] { __syncthreads(); });
  for (int r = threadIdx.x; r < K; r += blockDim.x)
    ds[r] = P[ptk::packed_base(r, K) + r];
  store_factor(F + off * K, d + off, P, K);
  ptk::solve_panels(P, ds, K, y);
  for (int r = threadIdx.x; r < K; r += blockDim.x) x[off + r] = float(y[r]);
}

__global__ void __launch_bounds__(THREADS, min_blocks(1))
    ldlt_solve_kernel(const float* __restrict__ F,
                      const float* __restrict__ d,
                      const float* __restrict__ b, float* __restrict__ x,
                      int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* P = reinterpret_cast<float*>(smem_raw);
  float* ds = P + ptk::packed_size(K);
  double* y = reinterpret_cast<double*>(P + rhs_offset(K));
  const size_t off = size_t(blockIdx.x) * K;
  ptk::load_upper(P, F + off * K, K, threadIdx.x >> 5, blockDim.x >> 5);
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    ds[r] = d[off + r];
    y[r] = b[off + r];
  }
  ptk::solve_panels(P, ds, K, y);
  for (int r = threadIdx.x; r < K; r += blockDim.x) x[off + r] = float(y[r]);
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

size_t smem_bytes(int K) {
  return rhs_offset(K) * sizeof(float) + size_t(K) * sizeof(double);
}

// One of the three LDL^T kernels at this K (WHICH = 0 the factor, 1 factor
// + solve, 2 the solve): f(kernel) launches it or asks about it.  Returns
// f's result, or cudaErrorInvalidValue for a K beyond the factor's
// register chunks (ldlt_device.cuh) or a block size other than THREADS.
template <int WHICH, typename F>
int with_ldlt_kernel(int K, int threads, F&& f) {
  if (threads != THREADS) return int(cudaErrorInvalidValue);
  if constexpr (WHICH == 2) {
    return f(ldlt_solve_kernel);
  } else {
    return ptk::with_chunks(K, [&](auto tc) {
      constexpr int TC = decltype(tc)::value;
      if constexpr (WHICH == 0)
        return f(ldlt_factor_kernel<TC>);
      else
        return f(ldlt_factor_solve_kernel<TC>);
    });
  }
}

template <int WHICH>
int blocks_per_sm(int K) {
  int blocks = 0;
  const size_t smem = smem_bytes(K);
  const int rc = with_ldlt_kernel<WHICH>(K, THREADS, [&](auto kernel) {
    if (int rc = allow_smem(kernel, smem)) return rc;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, THREADS, smem));
  });
  return rc == 0 ? blocks : 0;
}

}  // namespace

extern "C" {

size_t pt_ldlt_smem_bytes(int K) { return smem_bytes(K); }

// Blocks of one SM the kernel `which` (0 the factor, 1 factor + solve, 2
// the solve) holds at this K, by the occupancy API (shared memory,
// registers and threads together); 0 if it holds none.
int pt_ldlt_blocks_per_sm(int which, int K) {
  return which == 0 ? blocks_per_sm<0>(K)
         : which == 1 ? blocks_per_sm<1>(K)
                      : blocks_per_sm<2>(K);
}

int pt_ldlt_factor_f32(const float* M, float* F, float* d, int B, int K,
                       int threads, void* stream) {
  const size_t smem = pt_ldlt_smem_bytes(K);
  return with_ldlt_kernel<0>(K, threads, [&](auto kernel) {
    if (int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(M, F, d, K);
    return int(cudaGetLastError());
  });
}

int pt_ldlt_factor_solve_f32(const float* M, const float* b, float* x,
                             float* F, float* d, int B, int K, int threads,
                             void* stream) {
  const size_t smem = pt_ldlt_smem_bytes(K);
  return with_ldlt_kernel<1>(K, threads, [&](auto kernel) {
    if (int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(M, b, x, F, d, K);
    return int(cudaGetLastError());
  });
}

int pt_ldlt_solve_f32(const float* F, const float* d, const float* b,
                      float* x, int B, int K, int threads, void* stream) {
  const size_t smem = pt_ldlt_smem_bytes(K);
  return with_ldlt_kernel<2>(K, threads, [&](auto kernel) {
    if (int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(F, d, b, x, K);
    return int(cudaGetLastError());
  });
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
