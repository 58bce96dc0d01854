// Block-cooperative primitives on shared memory, shared by the BBT epoch
// kernels (bbt_epoch.cu), the dense LDL^T kernels (ldlt.cu) and the dense
// boxADMM epoch (admm_epoch.cu): the unpivoted LDL^T factor and solve
// (factor_block, solve_block), the explicit inverse by an in-place
// Gauss-Jordan sweep (sweep_inverse), the block products that apply such
// an inverse (block_matvec, warp_sums), and a block load (load_rows).
//
// Packed storage, as in the JAX package (polympc_tpu/ops/ldlt.py): a (k, k)
// block with row stride ldk holds L^T in its strict upper triangle
// (F[i][c] = L[c][i] for c > i), the pivots d separately, and in its lower
// triangle the Schur-complement values the recurrence left there (never
// read).  ldk = k + 1 keeps column walks free of shared-memory bank
// conflicts.
//
// factor_block, solve_block and sweep_inverse are called by all threads of
// the block and return after a __syncthreads(): their results are visible
// to the whole block.  block_matvec, warp_sums and load_rows are called
// by all threads too, but end without one: they are one phase of the
// caller's.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ptk {

// x - a * b with the product and the difference rounded one at a time,
// never fused into one multiply-add: the LDL^T primitives below then round
// as their plain PyTorch versions do (two operations), so the factor comes
// out bit for bit the plain version's.  Where an indefinite matrix's factor
// grows (the race car's refine matrices), a fused multiply-add alone moved
// a lane's residual more than ten-fold from the plain version's.
__device__ inline float sub_product(float x, float a, float b) {
  return __fsub_rn(x, __fmul_rn(a, b));
}
__device__ inline double sub_product(double x, double a, double b) {
  return __dsub_rn(x, __dmul_rn(a, b));
}

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
      F[j * ldk + c] = sub_product(F[j * ldk + c], rowi[j], rowi[c] * dinv);
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
// of Y (Y[c * ldy + r]), against a block factored by factor_block, in the
// arithmetic of Y's type V (which may be wider than the factor's T).
// Forward and backward sweeps are both column-oriented (axpy per pivot,
// one barrier per pivot).
template <typename T, typename V>
__device__ void solve_block(const T* F, const T* d, int k, int ldk, V* Y,
                            int ldy, int nrhs) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  __syncthreads();
  for (int j = 0; j < k - 1; ++j) {
    const int nt = k - j - 1;
    const T* rowj = F + j * ldk;
    for (int idx = tid; idx < nrhs * nt; idx += nthr) {
      const int c = idx / nt;
      const int r = j + 1 + idx % nt;
      Y[c * ldy + r] = sub_product(Y[c * ldy + r], V(rowj[r]), Y[c * ldy + j]);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < nrhs * k; idx += nthr) {
    const int c = idx / k, r = idx % k;
    Y[c * ldy + r] /= V(d[r]);
  }
  __syncthreads();
  for (int i = k - 1; i > 0; --i) {
    for (int idx = tid; idx < nrhs * i; idx += nthr) {
      const int c = idx / i, r = idx % i;
      Y[c * ldy + r] =
          sub_product(Y[c * ldy + r], V(F[r * ldk + i]), Y[c * ldy + i]);
    }
    __syncthreads();
  }
}

// In-place explicit inverse of the symmetric, strongly factorisable
// (quasi-definite) (k, k) block A, row stride lda, by unpivoted
// Gauss-Jordan: pivot p scales row p by 1/A[p][p], applies the rank-1
// update to every element off row and column p, and sets column p to
// -A[i][p]/A[p][p] and the diagonal to 1/A[p][p].  Its pivots are the
// numbers d of the unpivoted LDL^T, so it grows as that factor does.
//
// The block lives in registers for the whole sweep: a block of NW warps
// holds it as one RA x CB tile per thread, lane l the rows l + 32a (a < RA)
// and warp w the columns w*CB + b (b < CB), so k <= 32*RA (= NW*CB).  Pivot
// p needs only the old column p: by symmetry, row p equals it with the
// sign flipped at the indices already swept (j < p).  The warp that holds
// column p+1 writes, while the others update, the next pivot's two
// vectors into piv: the column v and the row already scaled, yd_j =
// s_j v_j / v_p (yd_p = 1 / v_p), and zeroes that column in its tile.  So
// one barrier per pivot orders the whole update, and per pivot a thread
// loads RA + CB numbers from shared memory for its RA*CB multiply-adds: k
// barrier steps and k^3 multiply-adds in all.  A is loaded from and stored
// back to shared memory once.  piv holds 4 * 32 * RA floats and is
// 16-byte aligned.
template <int RA, int NW, typename T>
__device__ void sweep_inverse(T* A, int k, int lda, T* piv) {
  constexpr int CB = 32 * RA / NW, KP = 32 * RA;
  const int lane = threadIdx.x & 31, j0 = (threadIdx.x >> 5) * CB;
  T R[RA][CB];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int i = lane + 32 * a, j = j0 + b;
      R[a][b] = i < k && j < k && j > 0 ? A[i * lda + j] : T(0);
    }
  {
    const T dinv = T(1) / A[0];
    for (int i = threadIdx.x; i < KP; i += blockDim.x) {
      const T vi = i < k ? A[i * lda] : T(0);
      piv[i] = vi;
      piv[KP + i] = i == 0 ? dinv : vi * dinv;
    }
  }
  __syncthreads();
  for (int p = 0; p < k; ++p) {
    const T* v = piv + (p & 1) * 2 * KP;
    const T* yd = v + KP;
    if (j0 < k) {
      // CB is a multiple of 4 and piv 16-byte aligned: four per load
      static_assert(CB % 4 == 0 && sizeof(T) == 4, "float4 row loads");
      T y[CB];
#pragma unroll
      for (int b = 0; b < CB; b += 4) {
        const float4 f = *reinterpret_cast<const float4*>(yd + j0 + b);
        y[b] = f.x;
        y[b + 1] = f.y;
        y[b + 2] = f.z;
        y[b + 3] = f.w;
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const T vi = v[lane + 32 * a];
#pragma unroll
        for (int b = 0; b < CB; ++b) R[a][b] -= vi * y[b];
        if (lane + 32 * a == p) {
#pragma unroll
          for (int b = 0; b < CB; ++b) R[a][b] = y[b];
        }
      }
    }
    const int q = p + 1 - j0;
    if (q >= 0 && q < CB && p + 1 < k) {
      // the next pivot's column, taken out of the tile
      T col[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) col[a] = T(0);
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        if (b != q) continue;
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          col[a] = R[a][b];
          R[a][b] = T(0);
        }
      }
      T d = T(0);
#pragma unroll
      for (int a = 0; a < RA; ++a)
        if (a == (p + 1) >> 5) d = col[a];
      const T dinv = T(1) / __shfl_sync(0xffffffffu, d, (p + 1) & 31);
      T* vn = piv + ((p + 1) & 1) * 2 * KP;
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int i = lane + 32 * a;
        vn[i] = col[a];
        vn[KP + i] = i == p + 1 ? dinv : (i <= p ? -col[a] : col[a]) * dinv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int i = lane + 32 * a, j = j0 + b;
      if (i < k && j < k) A[i * lda + j] = R[a][b];
    }
  __syncthreads();
}

// The register tiles the kernels are built for: RA = ceil(k / 32) up to
// max_ra(NW) = 6 with NW = 8 warps and 4 with NW = 4 (a larger tile would
// not fit a thread's registers), so k <= 192 at 256 threads and k <= 128
// at 128.  with_tile<NW> calls f(RA, NW), both as integral constants, and
// returns its result, or cudaErrorInvalidValue for a k outside these
// tiles; it instantiates f only for the tiles of that NW.
constexpr int max_ra(int nw) { return nw == 8 ? 6 : 4; }

template <int RA, int NW, typename F>
int tile_case(F& f) {
  if constexpr (RA <= max_ra(NW))
    return f(std::integral_constant<int, RA>{},
             std::integral_constant<int, NW>{});
  else
    return int(cudaErrorInvalidValue);
}

template <int NW, typename F>
int with_tile(int k, F&& f) {
  switch ((k + 31) / 32) {
    case 0:
    case 1: return tile_case<1, NW>(f);
    case 2: return tile_case<2, NW>(f);
    case 3: return tile_case<3, NW>(f);
    case 4: return tile_case<4, NW>(f);
    case 5: return tile_case<5, NW>(f);
    case 6: return tile_case<6, NW>(f);
  }
  return int(cudaErrorInvalidValue);
}

// y = A x for the (k, k) block A (row stride lda) and x in shared memory.
// tpr threads per row (the largest power of two up to 32 that the block
// has threads for), each summing a contiguous stretch of the row; a warp
// shuffle adds them.  With lda odd, a warp's rows fall in distinct banks.
template <typename T>
__device__ void block_matvec(const T* A, int k, int lda, const T* x, T* y) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  int tpr = 1;
  while (tpr < 32 && 2 * tpr * k <= nthr) tpr *= 2;
  const int len = (k + tpr - 1) / tpr, q = tid % tpr;
  for (int r0 = 0; r0 < k; r0 += nthr / tpr) {
    const int r = r0 + tid / tpr;
    T acc = T(0);
    if (r < k) {
      const T* row = A + r * lda;
      const int c0 = q * len, c1 = min(k, c0 + len);
      for (int c = c0; c < c1; ++c) acc += row[c] * x[c];
    }
    for (int off = tpr / 2; off > 0; off /= 2)
      acc += __shfl_down_sync(0xffffffffu, acc, off, tpr);
    if (r < k && q == 0) y[r] = acc;
  }
}

// Copy rows x cols elements from src (rows contiguous) to dst (row stride
// ldd) in shared memory, each thread loading four elements before it
// stores them, so that its loads are in flight together.
template <typename T>
__device__ void load_rows(T* dst, int ldd, const T* src, int rows, int cols) {
  const int n = rows * cols, step = blockDim.x;
  for (int base = threadIdx.x; base < n; base += 4 * step) {
    T e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      e[u] = base + u * step < n ? src[base + u * step] : T(0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * step;
      if (idx < n) dst[(idx / cols) * ldd + idx % cols] = e[u];
    }
  }
}

// out(e, sum_r term(e, r)) for e < n, r < len: one warp per output, its
// lanes striding r, a warp shuffle adding them (the thin transposed
// products of the BBT solve, whose outputs are few and whose sums long).
template <typename T, typename Term, typename Out>
__device__ void warp_sums(int n, int len, Term term, Out out) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int e = threadIdx.x >> 5; e < n; e += nw) {
    T acc = T(0);
    for (int r = lane; r < len; r += 32) acc += term(e, r);
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out(e, acc);
  }
}

}  // namespace ptk
