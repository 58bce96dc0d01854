// Fused dense boxADMM epoch (KKT LDL^T factor + `iters` iterations), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   polympc_tpu/ops/admm_epoch.py : admm_epoch_batched
//     (_epoch_body_with_m, _epoch_body_no_m)
// and computes what it computes: for each instance of a batch, the
// unpivoted LDL^T of its (K, K) boxADMM KKT, K = n + m,
//   [ H + sigma I + diag(rb)   A'          ]
//   [ A                        -diag(1/rho) ]
// then `iters` over-relaxed iterations: rhs = [sigma x + rb q - yb - h ;
// z - y/rho], one forward/diagonal/backward solve, and the box and row
// projections with their dual updates (admm_epoch.py:63-78).  m = 0 (a
// box-only QP) is the same kernel with an empty dual block.
//
// Its bound on an H100 at the spline-fitting QP (n = 32, m = 15, K = 47,
// B = 4096, 25 iterations): per instance K^3/3 multiply-adds for the factor
// and K^2 per iteration, 0.74 GFLOP in all, and one KKT read (36 MB) plus
// the vectors: about 11 us either way, at 67 TFLOP/s fp32 or 3.35 TB/s.
// It is latency-bound instead: the factor is K dependent rank-1 updates and
// every iteration 2K dependent pivot steps of a triangular sweep, each
// ending in a barrier (one __syncthreads per pivot), with at most K - 1
// independent updates per step.  Later work: a warp per instance (warp
// shuffles instead of block barriers), register-blocked sweeps, or the
// explicit inverse the TPU kernel measured slower there.
//
// What the design does now: one thread block per instance holds the KKT
// (row stride K + 1, so the column walks of the backward sweep hit distinct
// banks), its pivots and the twelve state vectors in dynamic shared memory
// for the whole epoch: the factor never leaves the SM, and each vector is
// read once and written once.  The block size is chosen by K in the
// wrapper (64 threads up to K = 64, 256 above), so small systems waste few
// threads at each barrier and many instances share an SM.
//
// Layouts (batch-major, contiguous, float): kkt (B, K, K); h, xl, xu, rb,
// x, q, yb (B, n); al, au, rho, z, y (B, m).
#include <cuda_runtime.h>

#include "ldlt_device.cuh"

namespace {

// clip as torch.clamp does: max then min, NaN propagates
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <typename T>
__global__ void admm_epoch_kernel(
    const T* __restrict__ kkt, const T* __restrict__ h,
    const T* __restrict__ al, const T* __restrict__ au,
    const T* __restrict__ xl, const T* __restrict__ xu,
    const T* __restrict__ rho, const T* __restrict__ rb,
    const T* __restrict__ x_in, const T* __restrict__ z_in,
    const T* __restrict__ q_in, const T* __restrict__ y_in,
    const T* __restrict__ yb_in, T* __restrict__ x_out,
    T* __restrict__ z_out, T* __restrict__ q_out, T* __restrict__ y_out,
    T* __restrict__ yb_out, int n, int m, T sigma, T alpha, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = n + m, ldk = K + 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  T* F = reinterpret_cast<T*>(smem_raw);
  T* d = F + size_t(K) * ldk;
  T* u = d + K;
  T* hs = u + K;  // primal vectors, n each
  T* lox = hs + n;
  T* hix = lox + n;
  T* rbs = hix + n;
  T* x = rbs + n;
  T* q = x + n;
  T* yb = q + n;
  T* loz = yb + n;  // dual vectors, m each
  T* hiz = loz + m;
  T* rhos = hiz + m;
  T* z = rhos + m;
  T* y = z + m;

  const size_t b = blockIdx.x;
  const T* Mb = kkt + b * K * K;
  for (int idx = tid; idx < K * K; idx += nthr)
    F[(idx / K) * ldk + idx % K] = Mb[idx];
  for (int r = tid; r < n; r += nthr) {
    const size_t g = b * n + r;
    hs[r] = h[g];
    lox[r] = xl[g];
    hix[r] = xu[g];
    rbs[r] = rb[g];
    x[r] = x_in[g];
    q[r] = q_in[g];
    yb[r] = yb_in[g];
  }
  for (int j = tid; j < m; j += nthr) {
    const size_t g = b * m + j;
    loz[j] = al[g];
    hiz[j] = au[g];
    rhos[j] = rho[g];
    z[j] = z_in[g];
    y[j] = y_in[g];
  }
  ptk::factor_block(F, d, K, ldk);

  const T a1 = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    // each thread builds and later updates the same rows r: no barrier
    // between the update and the next right-hand side
    for (int r = tid; r < K; r += nthr) {
      if (r < n) {
        u[r] = sigma * x[r] + rbs[r] * q[r] - yb[r] - hs[r];
      } else {
        const int j = r - n;
        u[r] = z[j] - y[j] * (T(1) / rhos[j]);
      }
    }
    ptk::solve_block(F, d, K, ldk, u, K, 1);
    for (int r = tid; r < K; r += nthr) {
      if (r < n) {
        const T xt = u[r];
        const T qu = alpha * xt + a1 * q[r];
        const T qn = clip(qu + yb[r] * (T(1) / rbs[r]), lox[r], hix[r]);
        yb[r] = yb[r] + rbs[r] * (qu - qn);
        x[r] = alpha * xt + a1 * x[r];
        q[r] = qn;
      } else {
        const int j = r - n;
        const T ri = T(1) / rhos[j];
        const T zt = z[j] + (u[r] - y[j]) * ri;
        const T zu = alpha * zt + a1 * z[j];
        const T zn = clip(zu + y[j] * ri, loz[j], hiz[j]);
        y[j] = y[j] + rhos[j] * (zu - zn);
        z[j] = zn;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < n; r += nthr) {
    const size_t g = b * n + r;
    x_out[g] = x[r];
    q_out[g] = q[r];
    yb_out[g] = yb[r];
  }
  for (int j = tid; j < m; j += nthr) {
    const size_t g = b * m + j;
    z_out[g] = z[j];
    y_out[g] = y[j];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one instance needs (the wrapper's
// epoch_smem_bytes computes the same).
size_t pt_admm_epoch_smem_bytes(int n, int m) {
  const size_t K = size_t(n) + m;
  return (K * (K + 1) + 2 * K + 7 * size_t(n) + 5 * size_t(m)) * sizeof(float);
}

int pt_admm_epoch_f32(const float* kkt, const float* h, const float* al,
                      const float* au, const float* xl, const float* xu,
                      const float* rho, const float* rb, const float* x,
                      const float* z, const float* q, const float* y,
                      const float* yb, float* x_out, float* z_out,
                      float* q_out, float* y_out, float* yb_out, int B, int n,
                      int m, float sigma, float alpha, int iters, int threads,
                      void* stream) {
  const size_t smem = pt_admm_epoch_smem_bytes(n, m);
  if (int rc = int(cudaFuncSetAttribute(
          admm_epoch_kernel<float>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))))
    return rc;
  admm_epoch_kernel<float><<<B, threads, smem, (cudaStream_t)stream>>>(
      kkt, h, al, au, xl, xu, rho, rb, x, z, q, y, yb, x_out, z_out, q_out,
      y_out, yb_out, n, m, sigma, alpha, iters);
  return int(cudaGetLastError());
}

}  // extern "C"
