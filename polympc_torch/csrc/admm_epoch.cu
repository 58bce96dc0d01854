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
// every iteration 2K dependent pivot steps of a triangular sweep, with at
// most K - 1 independent updates per step.
//
// The design: one warp per instance, so a pivot step is a warp shuffle,
// not a block barrier.  The instance's KKT lives in shared memory as its
// packed upper triangle (ldlt_device.cuh: K(K+1)/2 floats, 4.5 KB at
// K = 47), factored in place by ptk::factor_packed at warp scope (one
// __syncwarp per pair of pivots).  Its twelve state vectors stay in
// registers for the whole epoch, lane l holding rows l + 32 s.  Each
// iteration builds the right-hand side in registers; the forward sweep
// shuffles pivot j's value from lane j mod 32 to the others, and each lane
// updates its rows r > j from the packed row j (contiguous across the
// lanes); then the diagonal; the backward sweep shuffles pivot i's value to
// the rows r < i, each lane reading its own packed row at column i; then
// the box and row projections.  No __syncthreads() anywhere.  The factor
// is the plain version's bit for bit, and the sweeps give each element its
// terms one at a time in the column sweeps' order (pivot j ascending, then
// column i descending), each rounded alone (sub_product): the result does
// not depend on how rows are spread over lanes, warps or blocks (the
// elementwise expressions may still take fused multiply-adds, as the
// compiler contracts them).  Four instances share a block of 128 threads
// while their triangles fit (K <= 169), fewer above; at the spline shape
// ten blocks fit an SM (registers), so the 4,096 instances run in one
// wave of 31 warps per SM.  K is bound by one triangle in a block's shared
// memory (K <= 340) and by S <= 11 register slots (K <= 352).
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

// One instance per warp, blockDim.x / 32 instances per block (a short
// last block returns its idle warps at once); S register slots a lane, K
// <= 32 S.
template <int S>
__global__ void __launch_bounds__(128) admm_epoch_kernel(
    const float* __restrict__ kkt, const float* __restrict__ h,
    const float* __restrict__ al, const float* __restrict__ au,
    const float* __restrict__ xl, const float* __restrict__ xu,
    const float* __restrict__ rho, const float* __restrict__ rb,
    const float* __restrict__ x_in, const float* __restrict__ z_in,
    const float* __restrict__ q_in, const float* __restrict__ y_in,
    const float* __restrict__ yb_in, float* __restrict__ x_out,
    float* __restrict__ z_out, float* __restrict__ q_out,
    float* __restrict__ y_out, float* __restrict__ yb_out, int B, int n,
    int m, float sigma, float alpha, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr unsigned FULL = 0xffffffffu;
  const int K = n + m, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = size_t(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= size_t(B)) return;
  float* P = reinterpret_cast<float*>(smem_raw) + warp * ptk::packed_size(K);
  ptk::load_upper(P, kkt + b * K * K, K, 0, 1);
  // slot s: row r = lane + 32 s; a primal row holds h, its box, rb, x, q
  // and yb; a dual row its bounds, rho, z and y
  float hh[S], lo[S], hi[S], pen[S], v1[S], v2[S], dv[S], u[S], dd[S];
  int rbase[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + 32 * s;
    hh[s] = v2[s] = lo[s] = hi[s] = v1[s] = dv[s] = u[s] = 0.f;
    pen[s] = 1.f;
    if (r < n) {
      const size_t g = b * n + r;
      hh[s] = h[g];
      lo[s] = xl[g];
      hi[s] = xu[g];
      pen[s] = rb[g];
      v1[s] = x_in[g];
      v2[s] = q_in[g];
      dv[s] = yb_in[g];
    } else if (r < K) {
      const size_t g = b * m + (r - n);
      lo[s] = al[g];
      hi[s] = au[g];
      pen[s] = rho[g];
      v1[s] = z_in[g];
      dv[s] = y_in[g];
    }
  }
  ptk::factor_packed<S>(P, K, 0, 1, [] { __syncwarp(); });
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + 32 * s;
    rbase[s] = ptk::packed_base(r < K ? r : K - 1, K);
    dd[s] = r < K ? P[rbase[s] + r] : 1.f;
  }

  const float a1 = 1.f - alpha;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lane + 32 * s;
      if (r < n)
        u[s] = sigma * v1[s] + pen[s] * v2[s] - dv[s] - hh[s];
      else
        u[s] = v1[s] - dv[s] * (1.f / pen[s]);
    }
    int bj = 0;  // packed_base(j, K)
#pragma unroll
    for (int js = 0; js < S; ++js) {
      for (int jl = 0; jl < 32; ++jl) {
        const int j = 32 * js + jl;
        if (j >= K - 1) break;
        const float yj = __shfl_sync(FULL, u[js], jl);
#pragma unroll
        for (int s = js; s < S; ++s) {
          const int r = lane + 32 * s;
          if (r > j && r < K) u[s] = ptk::sub_product(u[s], P[bj + r], yj);
        }
        bj += K - j - 1;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] /= dd[s];
#pragma unroll
    for (int is = S - 1; is >= 0; --is) {
      for (int il = 31; il >= 0; --il) {
        const int i = 32 * is + il;
        if (i >= K) continue;
        if (i == 0) break;
        const float xi = __shfl_sync(FULL, u[is], il);
#pragma unroll
        for (int s = 0; s <= is; ++s) {
          const int r = lane + 32 * s;
          if (r < i) u[s] = ptk::sub_product(u[s], P[rbase[s] + i], xi);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lane + 32 * s;
      if (r < n) {
        const float xt = u[s];
        const float qu = alpha * xt + a1 * v2[s];
        const float qn = clip(qu + dv[s] * (1.f / pen[s]), lo[s], hi[s]);
        dv[s] = dv[s] + pen[s] * (qu - qn);
        v1[s] = alpha * xt + a1 * v1[s];
        v2[s] = qn;
      } else {
        const float ri = 1.f / pen[s];
        const float zt = v1[s] + (u[s] - dv[s]) * ri;
        const float zu = alpha * zt + a1 * v1[s];
        const float zn = clip(zu + dv[s] * ri, lo[s], hi[s]);
        dv[s] = dv[s] + pen[s] * (zu - zn);
        v1[s] = zn;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + 32 * s;
    if (r < n) {
      const size_t g = b * n + r;
      x_out[g] = v1[s];
      q_out[g] = v2[s];
      yb_out[g] = dv[s];
    } else if (r < K) {
      const size_t g = b * m + (r - n);
      z_out[g] = v1[s];
      y_out[g] = dv[s];
    }
  }
}

size_t smem_bytes(int n, int m, int threads) {
  return size_t(threads / 32) * ptk::packed_size(n + m) * sizeof(float);
}

// f(kernel) with the epoch kernel for K = n + m, or cudaErrorInvalidValue
// for a K beyond its register slots.
template <typename F>
int with_epoch_kernel(int n, int m, F&& f) {
  return ptk::with_chunks(n + m, [&](auto sc) {
    return f(admm_epoch_kernel<decltype(sc)::value>);
  });
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `threads` (a warp per
// instance) needs; the wrapper's epoch_smem_bytes computes the same.
size_t pt_admm_epoch_smem_bytes(int n, int m, int threads) {
  return smem_bytes(n, m, threads);
}

// Blocks of `threads` one SM holds at this shape (the occupancy API), or
// 0 if none.
int pt_admm_epoch_blocks_per_sm(int n, int m, int threads) {
  const size_t smem = smem_bytes(n, m, threads);
  int blocks = 0;
  const int rc = with_epoch_kernel(n, m, [&](auto kernel) {
    if (int rc = int(cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))))
      return rc;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, threads, smem));
  });
  return rc == 0 ? blocks : 0;
}

// threads: 32, 64, 96 or 128 (one instance per warp).
int pt_admm_epoch_f32(const float* kkt, const float* h, const float* al,
                      const float* au, const float* xl, const float* xu,
                      const float* rho, const float* rb, const float* x,
                      const float* z, const float* q, const float* y,
                      const float* yb, float* x_out, float* z_out,
                      float* q_out, float* y_out, float* yb_out, int B, int n,
                      int m, float sigma, float alpha, int iters, int threads,
                      void* stream) {
  if (threads < 32 || threads > 128 || threads % 32)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, m, threads);
  const int per = threads / 32;
  return with_epoch_kernel(n, m, [&](auto kernel) {
    if (int rc = int(cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))))
      return rc;
    kernel<<<(B + per - 1) / per, threads, smem, (cudaStream_t)stream>>>(
        kkt, h, al, au, xl, xu, rho, rb, x, z, q, y, yb, x_out, z_out, q_out,
        y_out, yb_out, B, n, m, sigma, alpha, iters);
    return int(cudaGetLastError());
  });
}

}  // extern "C"
