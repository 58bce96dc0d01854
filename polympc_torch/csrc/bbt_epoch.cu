// Fused boxADMM epoch and single solve on bordered-block-tridiagonal (BBT)
// collocation KKTs, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   polympc_tpu/ops/bbt_kernel.py : bbt_admm_epoch_batched (_epoch_body)
//   polympc_tpu/ops/bbt_kernel.py : bbt_solve_batched      (_solve_only_body)
// and computes what they compute: the block LDL^T factor of the
// segment-permuted KKT (Schur-updated diagonal blocks, thin coupling solves
// W_s = T~_s^-1 E, border Schur complement inverted by unpivoted
// Gauss-Jordan), then either `iters` over-relaxed ADMM iterations on
// permutation-unified vectors gated by the primal mask, or one solve.
//
// What bounds it on an H100: not bytes.  Per epoch an instance reads its
// gathered blocks once (~60 KB at the kite shape) and its vectors, and
// writes three vectors back.  The time goes to latency: every ADMM
// iteration is two triangular sweeps per block, i.e. ~2*S*k dependent
// pivot steps each ending in a barrier, and nothing in one instance can
// overlap them.
//
// What the design does about it: one thread block per instance holds the
// instance's whole working set in dynamic shared memory for the epoch (the
// factor never leaves the SM, and nothing factor-sized is written back), so
// each pivot step costs a shared-memory axpy and one barrier, and several
// instances share an SM (about four at the kite shape) to hide each
// other's barrier latency.  wgmma, TMA and register blocking are later work.
//
// Layouts (batch-major, contiguous, T = float):
//   Td   (B, S, k, k)   diagonal blocks (padding rows/cols identity)
//   Oh   (B, S, k, nx)  couplings O_s = K[block s rows, boundary x of s-1]
//   Ct   (B, S, a, k)   border columns, transposed
//   Dp   (B, a, a)      border block
//   vin  (B, 8, L)      h, lo, hi, rv, pm, x, v, yv on the unified order
//                       (S blocks of k rows, then the a border rows)
//   vout (B, 3, L)      x, v, yv after the epoch
//   bx   (S,) int32     row offset of the boundary states in each block
#include <cuda_runtime.h>

#include "ldlt_device.cuh"

namespace {

struct Shape {
  int S, k, nx, a, L, ldk;
};

template <typename T>
struct Work {
  T *F, *d, *Oh, *W, *OG, *Ct, *V, *Sp, *tb;
};

__host__ __device__ size_t work_elems(const Shape& sh) {
  const size_t Sk = size_t(sh.S) * sh.k;
  const int tbn = sh.a > sh.nx ? sh.a : sh.nx;
  return Sk * sh.ldk + Sk + 2 * Sk * sh.nx + size_t(sh.k) * sh.nx +
         2 * Sk * sh.a + size_t(sh.a) * sh.a + tbn;
}

template <typename T>
__device__ Work<T> carve(T* p, const Shape& sh) {
  const int Sk = sh.S * sh.k;
  Work<T> w;
  w.F = p;   p += size_t(Sk) * sh.ldk;
  w.d = p;   p += Sk;
  w.Oh = p;  p += Sk * sh.nx;
  w.W = p;   p += Sk * sh.nx;
  w.OG = p;  p += sh.k * sh.nx;
  w.Ct = p;  p += Sk * sh.a;
  w.V = p;   p += Sk * sh.a;
  w.Sp = p;  p += sh.a * sh.a;
  w.tb = p;
  return w;
}

template <typename T>
__device__ void load_blocks(const Work<T>& w, const Shape& sh, const T* Td,
                            const T* Oh, const T* Ct, const T* Dp) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k = sh.k, kk = k * k, Sk = sh.S * k;
  for (int idx = tid; idx < sh.S * kk; idx += nthr) {
    const int s = idx / kk, r = (idx / k) % k, c = idx % k;
    w.F[(s * k + r) * sh.ldk + c] = Td[idx];
  }
  for (int idx = tid; idx < Sk * sh.nx; idx += nthr) w.Oh[idx] = Oh[idx];
  for (int idx = tid; idx < Sk * sh.a; idx += nthr) w.Ct[idx] = Ct[idx];
  for (int idx = tid; idx < sh.a * sh.a; idx += nthr) w.Sp[idx] = Dp[idx];
}

// Block factor of the BBT system, in place.  After it: F/d hold the packed
// factors of the Schur-updated diagonal blocks, W_s = T~_s^-1 E (rows e),
// V_s = T~_s^-1 C~_s (rows c), Ct the updated border columns C~_s, and Sp
// the INVERSE of the border Schur complement.
template <typename T>
__device__ void bbt_factor(const Work<T>& w, const Shape& sh, const int* bx) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k = sh.k, nx = sh.nx, a = sh.a, ldk = sh.ldk;
  for (int s = 0; s < sh.S; ++s) {
    T* Fs = w.F + size_t(s) * k * ldk;
    const T* Os = w.Oh + s * k * nx;
    if (s > 0) {
      const int bxp = bx[s - 1];
      const T* Wp = w.W + (s - 1) * nx * k;
      // OG = O_s G, G[e][f] = (T~_{s-1}^-1 E)[bxp + e][f]
      for (int idx = tid; idx < k * nx; idx += nthr) {
        const int r = idx / nx, f = idx % nx;
        T acc = T(0);
        for (int e = 0; e < nx; ++e) acc += Os[r * nx + e] * Wp[f * k + bxp + e];
        w.OG[idx] = acc;
      }
      // C~_s -= O_s (E' T~_{s-1}^-1 C~_{s-1})
      const T* Vp = w.V + (s - 1) * a * k;
      for (int idx = tid; idx < a * k; idx += nthr) {
        const int c = idx / k, r = idx % k;
        T acc = T(0);
        for (int e = 0; e < nx; ++e) acc += Os[r * nx + e] * Vp[c * k + bxp + e];
        w.Ct[(s * a + c) * k + r] -= acc;
      }
      __syncthreads();
      // T_s -= O_s G O_s'
      for (int idx = tid; idx < k * k; idx += nthr) {
        const int r = idx / k, c = idx % k;
        T acc = T(0);
        for (int f = 0; f < nx; ++f) acc += w.OG[r * nx + f] * Os[c * nx + f];
        Fs[r * ldk + c] -= acc;
      }
    }
    ptk::factor_block(Fs, w.d + s * k, k, ldk);
    T* Ws = w.W + s * nx * k;
    T* Vs = w.V + s * a * k;
    for (int idx = tid; idx < nx * k; idx += nthr) {
      const int e = idx / k, r = idx % k;
      Ws[idx] = (r == bx[s] + e) ? T(1) : T(0);
    }
    for (int idx = tid; idx < a * k; idx += nthr) Vs[idx] = w.Ct[s * a * k + idx];
    ptk::solve_block(Fs, w.d + s * k, k, ldk, Ws, k, nx);
    if (a > 0) {
      ptk::solve_block(Fs, w.d + s * k, k, ldk, Vs, k, a);
      // Sp -= C~_s' V_s
      for (int idx = tid; idx < a * a; idx += nthr) {
        const int c = idx / a, dd = idx % a;
        T acc = T(0);
        for (int r = 0; r < k; ++r)
          acc += w.Ct[(s * a + c) * k + r] * Vs[dd * k + r];
        w.Sp[idx] -= acc;
      }
      __syncthreads();
    }
  }
  if (a > 0) {
    // unpivoted Gauss-Jordan inverse of the a x a border Schur complement,
    // in place (strongly factorisable for a quasi-definite KKT); a is
    // small, so one thread does it
    if (tid == 0) {
      T* A = w.Sp;
      for (int i = 0; i < a; ++i) {
        const T dinv = T(1) / A[i * a + i];
        A[i * a + i] = T(1);
        for (int c = 0; c < a; ++c) A[i * a + c] *= dinv;
        for (int r = 0; r < a; ++r) {
          if (r == i) continue;
          const T f = A[r * a + i];
          A[r * a + i] = T(0);
          for (int c = 0; c < a; ++c) A[r * a + c] -= f * A[i * a + c];
        }
      }
    }
    __syncthreads();
  }
}

// Solve the factored BBT system in place: u (L,) holds the permuted RHS on
// entry and the permuted solution on exit.
template <typename T>
__device__ void bbt_solve(const Work<T>& w, const Shape& sh, const int* bx,
                          T* u) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k = sh.k, nx = sh.nx, a = sh.a, ldk = sh.ldk, S = sh.S;
  T* ub = u + S * k;
  for (int s = 0; s < S; ++s) {
    T* us = u + s * k;
    if (s > 0) {
      const int bxp = bx[s - 1];
      const T* prev = u + (s - 1) * k;
      const T* Os = w.Oh + s * k * nx;
      for (int r = tid; r < k; r += nthr) {
        T acc = T(0);
        for (int e = 0; e < nx; ++e) acc += Os[r * nx + e] * prev[bxp + e];
        us[r] -= acc;
      }
    }
    ptk::solve_block(w.F + size_t(s) * k * ldk, w.d + s * k, k, ldk, us, k, 1);
    if (a > 0) {
      for (int c = tid; c < a; c += nthr) {
        T acc = T(0);
        for (int r = 0; r < k; ++r) acc += w.Ct[(s * a + c) * k + r] * us[r];
        ub[c] -= acc;
      }
      __syncthreads();
    }
  }
  if (a > 0) {
    for (int c = tid; c < a; c += nthr) {
      T acc = T(0);
      for (int dd = 0; dd < a; ++dd) acc += w.Sp[c * a + dd] * ub[dd];
      w.tb[c] = acc;
    }
    __syncthreads();
    for (int c = tid; c < a; c += nthr) ub[c] = w.tb[c];
    __syncthreads();
  }
  for (int s = S - 1; s >= 0; --s) {
    T* us = u + s * k;
    const bool coupled = s < S - 1;
    if (coupled) {
      const T* On = w.Oh + (s + 1) * k * nx;
      const T* xn = u + (s + 1) * k;
      for (int e = tid; e < nx; e += nthr) {
        T acc = T(0);
        for (int r = 0; r < k; ++r) acc += On[r * nx + e] * xn[r];
        w.tb[e] = acc;
      }
      __syncthreads();
    }
    for (int r = tid; r < k; r += nthr) {
      T acc = T(0);
      for (int c = 0; c < a; ++c) acc += w.V[(s * a + c) * k + r] * ub[c];
      if (coupled)
        for (int e = 0; e < nx; ++e) acc += w.W[(s * nx + e) * k + r] * w.tb[e];
      us[r] -= acc;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void bbt_epoch_kernel(const T* __restrict__ Td,
                                 const T* __restrict__ Oh,
                                 const T* __restrict__ Ct,
                                 const T* __restrict__ Dp,
                                 const T* __restrict__ vin,
                                 T* __restrict__ vout,
                                 const int* __restrict__ bx, Shape sh,
                                 T sigma, T alpha, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  const Work<T> w = carve(base, sh);
  const int L = sh.L;
  T* h = base + work_elems(sh);
  T* lo = h + L;
  T* hi = lo + L;
  T* rv = hi + L;
  T* ri = rv + L;
  T* pm = ri + L;
  T* x = pm + L;
  T* v = x + L;
  T* yv = v + L;
  T* u = yv + L;

  const size_t b = blockIdx.x;
  const int k = sh.k, Sk = sh.S * k;
  load_blocks(w, sh, Td + b * Sk * k, Oh + b * Sk * sh.nx,
              Ct + b * Sk * sh.a, Dp + b * sh.a * sh.a);
  const T* vb = vin + b * 8 * L;
  for (int r = threadIdx.x; r < L; r += blockDim.x) {
    h[r] = vb[r];
    lo[r] = vb[L + r];
    hi[r] = vb[2 * L + r];
    rv[r] = vb[3 * L + r];
    ri[r] = T(1) / rv[r];
    pm[r] = vb[4 * L + r];
    x[r] = vb[5 * L + r];
    v[r] = vb[6 * L + r];
    yv[r] = vb[7 * L + r];
  }
  bbt_factor(w, sh, bx);

  for (int it = 0; it < iters; ++it) {
    for (int r = threadIdx.x; r < L; r += blockDim.x) {
      const T p = pm[r];
      u[r] = p * (sigma * x[r] + rv[r] * v[r] - yv[r] - h[r]) +
             (T(1) - p) * (v[r] - yv[r] * ri[r]);
    }
    bbt_solve(w, sh, bx, u);
    for (int r = threadIdx.x; r < L; r += blockDim.x) {
      const T p = pm[r], sol = u[r];
      const T t = p * sol + (T(1) - p) * (v[r] + (sol - yv[r]) * ri[r]);
      x[r] = p * (alpha * sol + (T(1) - alpha) * x[r]) + (T(1) - p) * x[r];
      const T vu = alpha * t + (T(1) - alpha) * v[r];
      // clip as jnp.clip does: max then min, NaN propagates
      T vn = vu + yv[r] * ri[r];
      vn = vn < lo[r] ? lo[r] : vn;
      vn = vn > hi[r] ? hi[r] : vn;
      yv[r] = yv[r] + rv[r] * (vu - vn);
      v[r] = vn;
    }
    __syncthreads();
  }
  T* vo = vout + b * 3 * L;
  for (int r = threadIdx.x; r < L; r += blockDim.x) {
    vo[r] = x[r];
    vo[L + r] = v[r];
    vo[2 * L + r] = yv[r];
  }
}

template <typename T>
__global__ void bbt_solve_kernel(const T* __restrict__ Td,
                                 const T* __restrict__ Oh,
                                 const T* __restrict__ Ct,
                                 const T* __restrict__ Dp,
                                 const T* __restrict__ rhs, T* __restrict__ out,
                                 const int* __restrict__ bx, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  const Work<T> w = carve(base, sh);
  T* u = base + work_elems(sh);
  const size_t b = blockIdx.x;
  const int k = sh.k, Sk = sh.S * k, L = sh.L;
  load_blocks(w, sh, Td + b * Sk * k, Oh + b * Sk * sh.nx,
              Ct + b * Sk * sh.a, Dp + b * sh.a * sh.a);
  for (int r = threadIdx.x; r < L; r += blockDim.x) u[r] = rhs[b * L + r];
  bbt_factor(w, sh, bx);
  bbt_solve(w, sh, bx, u);
  for (int r = threadIdx.x; r < L; r += blockDim.x) out[b * L + r] = u[r];
}

Shape make_shape(int S, int k, int nx, int a) {
  return Shape{S, k, nx, a, S * k + a, k + 1};
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one instance of each kernel needs.
size_t pt_bbt_epoch_smem_bytes(int S, int k, int nx, int a) {
  const Shape sh = make_shape(S, k, nx, a);
  return (work_elems(sh) + 10 * size_t(sh.L)) * sizeof(float);
}

size_t pt_bbt_solve_smem_bytes(int S, int k, int nx, int a) {
  const Shape sh = make_shape(S, k, nx, a);
  return (work_elems(sh) + size_t(sh.L)) * sizeof(float);
}

int pt_bbt_epoch_f32(const float* Td, const float* Oh, const float* Ct,
                     const float* Dp, const float* vin, float* vout,
                     const int* bx, int B, int S, int k, int nx, int a,
                     float sigma, float alpha, int iters, int threads,
                     void* stream) {
  const Shape sh = make_shape(S, k, nx, a);
  const size_t smem = pt_bbt_epoch_smem_bytes(S, k, nx, a);
  if (int rc = allow_smem(bbt_epoch_kernel<float>, smem)) return rc;
  bbt_epoch_kernel<float><<<B, threads, smem, (cudaStream_t)stream>>>(
      Td, Oh, Ct, Dp, vin, vout, bx, sh, sigma, alpha, iters);
  return int(cudaGetLastError());
}

int pt_bbt_solve_f32(const float* Td, const float* Oh, const float* Ct,
                     const float* Dp, const float* rhs, float* out,
                     const int* bx, int B, int S, int k, int nx, int a,
                     int threads, void* stream) {
  const Shape sh = make_shape(S, k, nx, a);
  const size_t smem = pt_bbt_solve_smem_bytes(S, k, nx, a);
  if (int rc = allow_smem(bbt_solve_kernel<float>, smem)) return rc;
  bbt_solve_kernel<float><<<B, threads, smem, (cudaStream_t)stream>>>(
      Td, Oh, Ct, Dp, rhs, out, bx, sh);
  return int(cudaGetLastError());
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

}  // extern "C"
