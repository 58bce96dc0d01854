// Fused boxADMM epoch and single solve on bordered-block-tridiagonal (BBT)
// collocation KKTs, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   polympc_tpu/ops/bbt_kernel.py : bbt_admm_epoch_batched (_epoch_body)
//   polympc_tpu/ops/bbt_kernel.py : bbt_solve_batched      (_solve_only_body)
// and computes what they compute: the block elimination of the
// segment-permuted KKT (Schur-updated diagonal blocks T~_s, thin couplings
// W_s = T~_s^-1 E, the border Schur complement inverted), then either
// `iters` over-relaxed ADMM iterations on permutation-unified vectors gated
// by the primal mask, or one solve.
//
// Design: explicit block inverses.  The factor inverts each T~_s in place
// by an unpivoted Gauss-Jordan sweep (ptk::sweep_inverse: k barrier steps,
// its pivots the unpivoted LDL^T's d); W_s is read in place as columns
// bx_s..bx_s+nx of that inverse, V_s = T~_s^-1 C~_s is one product, and
// the border's Schur complement is swept by the same primitive.  Each ADMM
// iteration then applies the inverses: a (k x k) mat-vec per block
// (ptk::block_matvec), the thin coupling and border products, the
// elementwise update; about 5S + 3 barriers, where substituting through
// LDL^T factors took 2k per block.  The plain PyTorch version substitutes;
// bbt_epoch_mirror (ops/bbt_kernel.py) is this algorithm in PyTorch.
//
// What bounds it on an H100: not bytes, and not the card's FLOPs.  Per
// epoch an instance reads its gathered blocks once (~74 KB at the race
// car's k = 96) and its vectors, and writes three vectors back.  One
// thread block per instance keeps the working set in dynamic shared memory
// for the whole epoch (the inverses never leave the SM), so the time goes
// to latency within the SM: the sweeps' k steps each (a barrier, the pivot
// vectors' loads, RA*CB multiply-adds per thread on the block held in
// registers) and, per iteration, about 5S + 3 barrier-separated phases, of
// which the mat-vecs read each inverse from shared memory.  On the card
// the two halves weigh about the same (chip_smoke.py, PERF.md).  Two
// instances share an SM at k = 96 (shared memory) and three at k = 72
// with 128 threads (registers): ops/bbt_kernel.py:epoch_threads picks the
// block size that holds more.  Tensor cores do not apply: every product
// of an iteration is a matrix-vector product per instance, and TF32 would
// break the fp32 precision contract.
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

// F: the S diagonal blocks, then their inverses, row stride ldk = k + 1;
// z: one block's mat-vec result; piv: the sweep's pivot vectors.
template <typename T>
struct Work {
  T *F, *Oh, *OG, *Ct, *V, *Sp, *tb, *z, *piv;
};

__host__ __device__ int imax(int x, int y) { return x > y ? x : y; }

// rows of the sweep's register tile, 32 * ceil(max(k, a) / 32)
__host__ __device__ int piv_rows(const Shape& sh) {
  return (imax(sh.k, sh.a) + 31) / 32 * 32;
}

__host__ __device__ size_t work_elems(const Shape& sh) {
  const size_t Sk = size_t(sh.S) * sh.k;
  return Sk * sh.ldk + Sk * sh.nx + size_t(sh.k) * sh.nx + 2 * Sk * sh.a +
         size_t(sh.a) * sh.a + imax(sh.a, sh.nx) + sh.k +
         4 + 4 * piv_rows(sh);
}

template <typename T>
__device__ Work<T> carve(T* p, const Shape& sh) {
  T* const base = p;
  const int Sk = sh.S * sh.k;
  Work<T> w;
  w.F = p;   p += size_t(Sk) * sh.ldk;
  w.Oh = p;  p += Sk * sh.nx;
  w.OG = p;  p += sh.k * sh.nx;
  w.Ct = p;  p += Sk * sh.a;
  w.V = p;   p += Sk * sh.a;
  w.Sp = p;  p += sh.a * sh.a;
  w.tb = p;  p += imax(sh.a, sh.nx);
  w.z = p;   p += sh.k;
  w.piv = base + (p - base + 3) / 4 * 4;  // 16-byte aligned
  return w;
}

template <typename T>
__device__ void load_blocks(const Work<T>& w, const Shape& sh, const T* Td,
                            const T* Oh, const T* Ct, const T* Dp) {
  const int Sk = sh.S * sh.k;
  ptk::load_rows(w.F, sh.ldk, Td, Sk, sh.k);
  ptk::load_rows(w.Oh, sh.nx, Oh, Sk, sh.nx);
  ptk::load_rows(w.Ct, sh.k, Ct, sh.S * sh.a, sh.k);
  ptk::load_rows(w.Sp, sh.a, Dp, sh.a, sh.a);
}

// Block elimination of the BBT system, in place.  After it: F holds the
// inverses T~_s^-1 of the Schur-updated diagonal blocks, V_s = T~_s^-1 C~_s
// (rows c), Ct the updated border columns C~_s, and Sp the INVERSE of the
// border Schur complement.
template <int RA, int NW, typename T>
__device__ void bbt_factor(const Work<T>& w, const Shape& sh, const int* bx) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k = sh.k, nx = sh.nx, a = sh.a, ldk = sh.ldk;
  for (int s = 0; s < sh.S; ++s) {
    T* Fs = w.F + size_t(s) * k * ldk;
    const T* Os = w.Oh + s * k * nx;
    if (s > 0) {
      const int bxp = bx[s - 1];
      // G = (T~_{s-1}^-1 E)[bxp + e][f], in place in the previous inverse
      const T* G = w.F + size_t(s - 1) * k * ldk + bxp * ldk + bxp;
      // OG = O_s G
      for (int idx = tid; idx < k * nx; idx += nthr) {
        const int r = idx / nx, f = idx % nx;
        T acc = T(0);
        for (int e = 0; e < nx; ++e) acc += Os[r * nx + e] * G[e * ldk + f];
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
    ptk::sweep_inverse<RA, NW>(Fs, k, ldk, w.piv);
    if (a > 0) {
      T* Vs = w.V + s * a * k;
      for (int c = 0; c < a; ++c)
        ptk::block_matvec(Fs, k, ldk, w.Ct + (s * a + c) * k, Vs + c * k);
      __syncthreads();
      // Sp -= C~_s' V_s
      for (int idx = tid; idx < a * a; idx += nthr) {
        const int c = idx / a, dd = idx % a;
        T acc = T(0);
        for (int r = 0; r < k; ++r)
          acc += w.Ct[(s * a + c) * k + r] * Vs[dd * k + r];
        w.Sp[idx] -= acc;
      }
    }
  }
  if (a > 0) ptk::sweep_inverse<RA, NW>(w.Sp, a, a, w.piv);
  __syncthreads();
}

// Solve the eliminated BBT system in place: u (L,) holds the permuted RHS
// on entry and the permuted solution on exit.
template <typename T>
__device__ void bbt_solve(const Work<T>& w, const Shape& sh, const int* bx,
                          T* u) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k = sh.k, nx = sh.nx, a = sh.a, ldk = sh.ldk, S = sh.S;
  T* ub = u + S * k;
  __syncthreads();
  // forward: u_s <- T~_s^-1 u_s; then u_{s+1} -= O_{s+1} u_s[bx_s + e] and
  // the border u_b -= C~_s' u_s, all from the mat-vec's result z
  for (int s = 0; s < S; ++s) {
    T* us = u + s * k;
    ptk::block_matvec(w.F + size_t(s) * k * ldk, k, ldk, us, w.z);
    __syncthreads();
    for (int r = tid; r < k; r += nthr) us[r] = w.z[r];
    if (s + 1 < S) {
      const T* On = w.Oh + (s + 1) * k * nx;
      const T* zb = w.z + bx[s];
      T* un = us + k;
      for (int r = tid; r < k; r += nthr) {
        T acc = T(0);
        for (int e = 0; e < nx; ++e) acc += On[r * nx + e] * zb[e];
        un[r] -= acc;
      }
    }
    if (a > 0) {
      const T* Cs = w.Ct + s * a * k;
      const T* z = w.z;
      ptk::warp_sums<T>(a, k, [=](int c, int r) { return Cs[c * k + r] * z[r]; },
                        [=](int c, T acc) { ub[c] -= acc; });
    }
    __syncthreads();
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
  // backward: u_s -= V_s u_b + W_s (O_{s+1}' u_{s+1}), W_s read in place
  for (int s = S - 1; s >= 0; --s) {
    T* us = u + s * k;
    const bool coupled = s < S - 1;
    if (!coupled && a == 0) continue;
    const T* Ws = w.F + size_t(s) * k * ldk + bx[s];
    if (coupled) {
      const T* On = w.Oh + (s + 1) * k * nx;
      const T* xn = us + k;
      T* tb = w.tb;
      ptk::warp_sums<T>(nx, k, [=](int e, int r) { return On[r * nx + e] * xn[r]; },
                        [=](int e, T acc) { tb[e] = acc; });
      __syncthreads();
    }
    for (int r = tid; r < k; r += nthr) {
      T acc = T(0);
      for (int c = 0; c < a; ++c) acc += w.V[(s * a + c) * k + r] * ub[c];
      if (coupled)
        for (int e = 0; e < nx; ++e) acc += Ws[r * ldk + e] * w.tb[e];
      us[r] -= acc;
    }
    __syncthreads();
  }
}

template <typename T, int RA, int NW>
__global__ void __launch_bounds__(NW * 32) bbt_epoch_kernel(const T* __restrict__ Td,
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
  __syncthreads();
  bbt_factor<RA, NW>(w, sh, bx);

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

template <typename T, int RA, int NW>
__global__ void __launch_bounds__(NW * 32) bbt_solve_kernel(const T* __restrict__ Td,
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
  __syncthreads();
  bbt_factor<RA, NW>(w, sh, bx);
  bbt_solve(w, sh, bx, u);
  for (int r = threadIdx.x; r < L; r += blockDim.x) out[b * L + r] = u[r];
}

Shape make_shape(int S, int k, int nx, int a) {
  return Shape{S, k, nx, a, S * k + a, k + 1};
}

// f(RA, NW) at the epoch's block size, 256 threads (NW = 8) or 128
// (NW = 4); the single solve is built at 256 only.
template <typename F>
int with_epoch_tile(int k, int threads, F&& f) {
  if (threads == 256) return ptk::with_tile<8>(k, f);
  if (threads == 128) return ptk::with_tile<4>(k, f);
  return int(cudaErrorInvalidValue);
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

// 1 if the kernels are built for blocks of max(k, a) rows at this many
// threads per block (the register tile of the sweep; ldlt_device.cuh).
int pt_bbt_tile_fits(int k, int a, int threads) {
  return with_epoch_tile(imax(k, a), threads,
                         [](auto, auto) { return 0; }) == 0;
}

// Thread blocks of the epoch kernel that one SM holds at once at this many
// threads per block (0 where the kernel is not built for the shape).
int pt_bbt_epoch_blocks_per_sm(int S, int k, int nx, int a, int threads) {
  if (!pt_bbt_tile_fits(k, a, threads)) return 0;
  const size_t smem = pt_bbt_epoch_smem_bytes(S, k, nx, a);
  int blocks = 0;
  const int rc = with_epoch_tile(imax(k, a), threads, [&](auto ra, auto nw) {
    auto kernel = bbt_epoch_kernel<float, decltype(ra)::value,
                                   decltype(nw)::value>;
    if (int rc = allow_smem(kernel, smem)) return rc;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, threads, smem));
  });
  return rc == 0 ? blocks : 0;
}

int pt_bbt_epoch_f32(const float* Td, const float* Oh, const float* Ct,
                     const float* Dp, const float* vin, float* vout,
                     const int* bx, int B, int S, int k, int nx, int a,
                     float sigma, float alpha, int iters, int threads,
                     void* stream) {
  const Shape sh = make_shape(S, k, nx, a);
  const size_t smem = pt_bbt_epoch_smem_bytes(S, k, nx, a);
  return with_epoch_tile(imax(k, a), threads, [&](auto ra, auto nw) {
    constexpr int RA = decltype(ra)::value, NW = decltype(nw)::value;
    auto kernel = bbt_epoch_kernel<float, RA, NW>;
    if (int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<B, NW * 32, smem, (cudaStream_t)stream>>>(
        Td, Oh, Ct, Dp, vin, vout, bx, sh, sigma, alpha, iters);
    return int(cudaGetLastError());
  });
}

int pt_bbt_solve_f32(const float* Td, const float* Oh, const float* Ct,
                     const float* Dp, const float* rhs, float* out,
                     const int* bx, int B, int S, int k, int nx, int a,
                     int threads, void* stream) {
  const Shape sh = make_shape(S, k, nx, a);
  const size_t smem = pt_bbt_solve_smem_bytes(S, k, nx, a);
  if (threads != 256) return int(cudaErrorInvalidValue);
  return ptk::with_tile<8>(imax(k, a), [&](auto ra, auto nw) {
    constexpr int RA = decltype(ra)::value, NW = decltype(nw)::value;
    auto kernel = bbt_solve_kernel<float, RA, NW>;
    if (int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<B, NW * 32, smem, (cudaStream_t)stream>>>(
        Td, Oh, Ct, Dp, rhs, out, bx, sh);
    return int(cudaGetLastError());
  });
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

}  // extern "C"
