// Primitives on shared memory, shared by the BBT epoch kernels
// (bbt_epoch.cu), the dense LDL^T kernels (ldlt.cu) and the dense boxADMM
// epoch (admm_epoch.cu):
//   sub_product        x - a*b rounded as two operations (no fused
//                      multiply-add), in float and double;
//   packed_base,       the packed upper triangle: a symmetric matrix's
//   packed_size        rows from the diagonal on, one after another;
//   load_upper         a matrix's upper triangle into that packed form;
//   factor_packed      the unpivoted LDL^T in place on the packed triangle,
//                      by a block or by one warp, two pivots per sync, bit
//                      for bit the plain version's;
//   with_chunks        the factor's register chunks (K <= 352);
//   solve_panels       (L D L^T) x = y in double against the packed float
//                      factor, by panels of 32 pivots: a warp solves a
//                      panel's triangle with shuffles, one barrier a panel;
//   sweep_inverse      the explicit inverse by an in-place Gauss-Jordan
//                      sweep held in registers, with_tile its tiles;
//   block_matvec,      the block products that apply such an inverse;
//   warp_sums
//   load_rows          a block of rows into shared memory.
//
// L^T convention, as in the JAX package (polympc_tpu/ops/ldlt.py): the
// factor holds L^T in its strict upper triangle (F[i][c] = L[c][i] for
// c > i) and the pivots d on its diagonal (and separately); the packed
// kernels never store the lower triangle.  The row-stride (ldk = k + 1)
// blocks of the sweep keep column walks free of bank conflicts.
//
// factor_packed, solve_panels and sweep_inverse are called by all threads
// of their group and return after a barrier (factor_packed: its group's
// sync), so their results are visible to the whole group.  block_matvec,
// warp_sums, load_rows and load_upper are called by all threads too, but
// end without one: they are one phase of the caller's.
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

// The packed upper triangle: row j of a symmetric (K, K) matrix from its
// diagonal to column K-1, rows one after another, K(K+1)/2 elements in
// all.  Row j starts at j*K - j(j-1)/2, so element (j, c), c >= j, lies at
// packed_base(j, K) + c; a row's elements are contiguous, and the next
// row's base is packed_base(j, K) + K - j - 1.
__host__ __device__ inline int packed_base(int j, int K) {
  return j * (2 * K - j - 1) / 2;
}
__host__ __device__ inline size_t packed_size(int K) {
  return size_t(K) * (K + 1) / 2;
}

// Copy the upper triangle of the row-major (K, K) matrix M into the
// packed P, by the nw warps of a group (w its warp in the group): warp w
// the rows j = w (mod nw), its lanes 32 consecutive columns of a row at a
// time, eight such loads in flight before they are stored.
__device__ inline void load_upper(float* P, const float* __restrict__ M,
                                  int K, int w, int nw) {
  constexpr int U = 8;
  const int lane = threadIdx.x & 31;
  int j = w, c0 = w;  // warp-uniform: the next row and its next column
  while (j < K) {
    float e[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + lane;
      at[u] = j < K && c < K ? packed_base(j, K) + c : -1;
      e[u] = at[u] >= 0 ? M[size_t(j) * K + c] : 0.f;
      c0 += 32;
      if (c0 >= K) {
        j += nw;
        c0 = j;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at[u] >= 0) P[at[u]] = e[u];
  }
}

namespace detail {

// Rows p and p+1 of a factored pair written as L^T (factor_packed): row p
// scaled by 1 / d_p, row p+1 given pivot p's update, its diagonal d_{p+1},
// and its trailing part scaled by 1 / d_{p+1}; the values and roundings of
// ldlt_factor_plain.  One warp; every lane reads what it needs before any
// writes.
__device__ inline void finish_pair(float* P, int K, int p) {
  const int lane = threadIdx.x & 31;
  float* r0 = P + packed_base(p, K);
  float* r1 = P + packed_base(p + 1, K);
  const float dinv0 = 1.f / r0[p];
  const float w01 = r0[p + 1];
  const float d1 = sub_product(r1[p + 1], w01, w01 * dinv0);
  const float dinv1 = 1.f / d1;
  __syncwarp();
  for (int c = p + 1 + lane; c < K; c += 32) {
    const float s0 = r0[c] * dinv0;
    r0[c] = s0;
    if (c > p + 1) r1[c] = sub_product(r1[c], w01, s0) * dinv1;
  }
  if (lane == 0) r1[p + 1] = d1;
}

}  // namespace detail

// In-place LDL^T of the packed upper triangle P by a group of nw warps (w
// its warp in the group) that sync() synchronises: a block
// (__syncthreads) or one warp (__syncwarp).  Pivots go in pairs (i, i+1):
// every thread reads rows i and i+1, forms pivot i's update of row i+1
// itself, and keeps in registers both pivots' scaled rows at its columns
// (lane l the columns c = l (mod 32), TC = ceil(K/32) of them); then warp
// w applies both rank-1 updates, P[j][c] -= P[i][j] P[i][c] / d_i and then
// pivot i+1's, to the rows j > i+1, j = w (mod nw), of the trailing upper
// triangle (c >= j): one load, two products, two differences and one store
// per element and pair.  Rows i and i+1 are written as L^T (and d_{i+1})
// one pair later, when no thread reads them any more.  Every element of
// the upper triangle receives the operations of ldlt_factor_plain in its
// order, each rounded alone (sub_product), so the factor equals the plain
// version's bit for bit, d on the diagonal.  One sync per pair;
// K(K+1)(K+2)/6 element updates, half those of the square.
template <int TC, typename Sync>
__device__ void factor_packed(float* P, int K, int w, int nw, Sync sync) {
  const int lane = threadIdx.x & 31;
  sync();
  int i = 0;
  for (; i + 1 < K; i += 2) {
    const float* r0 = P + packed_base(i, K);
    const float* r1 = P + packed_base(i + 1, K);
    const float dinv0 = 1.f / r0[i];
    const float w01 = r0[i + 1];
    const float dinv1 = 1.f / sub_product(r1[i + 1], w01, w01 * dinv0);
    float s0[TC], s1[TC];
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      const int c = lane + 32 * t;
      s0[t] = s1[t] = 0.f;
      if (c > i + 1 && c < K) {
        s0[t] = r0[c] * dinv0;
        s1[t] = sub_product(r1[c], w01, s0[t]) * dinv1;
      }
    }
    int j = i + 2 + ((w - i - 2) % nw + nw) % nw;
    for (; j < K; j += nw) {
      float* rowj = P + packed_base(j, K);
      const float a = r0[j];
      const float b = sub_product(r1[j], w01, a * dinv0);
      const int t0 = j >> 5;
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        if (t < t0) continue;
        const int c = lane + 32 * t;
        if ((t > t0 || c >= j) && (t + 1 < TC || c < K))
          rowj[c] = sub_product(sub_product(rowj[c], a, s0[t]), b, s1[t]);
      }
    }
    if (i >= 2 && (i / 2 - 1) % nw == w) detail::finish_pair(P, K, i - 2);
    sync();
  }
  // the last pair; a last single pivot (K odd) updates nothing
  if (i >= 2 && (i / 2 - 1) % nw == w) detail::finish_pair(P, K, i - 2);
  sync();
}

// The register tiles factor_packed is built for: TC = ceil(K / 32) up to
// 11 (K <= 352).  with_chunks calls f(TC) with TC as an integral constant
// and returns its result, or cudaErrorInvalidValue for a larger K.
constexpr int MAX_CHUNKS = 11;

template <int TC, typename F>
int chunk_case(int tc, F& f) {
  if constexpr (TC > MAX_CHUNKS) {
    return int(cudaErrorInvalidValue);
  } else {
    if (tc == TC) return f(std::integral_constant<int, TC>{});
    return chunk_case<TC + 1>(tc, f);
  }
}

template <typename F>
int with_chunks(int K, F&& f) {
  return chunk_case<1>(K < 1 ? 1 : (K + 31) / 32, f);
}

namespace detail {

constexpr unsigned FULL = 0xffffffffu;

// Rows R0 + l (l < n <= 32) of a unit lower triangle solved in place by
// one warp: lane l holds y[R0 + l] in v, pivot jj's final value goes to
// the lanes below it by a shuffle, and each updates itself from the
// packed row R0 + jj (contiguous across the lanes).
__device__ inline double forward_diag(const float* P, int K, int R0, int n,
                                      double v) {
  const int lane = threadIdx.x & 31;
  int b = packed_base(R0, K);
  for (int jj = 0; jj + 1 < n; ++jj) {
    const double yj = __shfl_sync(FULL, v, jj);
    if (lane > jj && lane < n) v = sub_product(v, double(P[b + R0 + lane]), yj);
    b += K - (R0 + jj) - 1;
  }
  return v;
}

// The unit upper triangle of rows R0 + l (l < n), lane l holding row
// R0 + l: pivot cc's value goes up to the lanes above it, each reading its
// own packed row at column R0 + cc.
__device__ inline double backward_diag(const float* P, int K, int R0, int n,
                                       double v) {
  const int lane = threadIdx.x & 31;
  const int b = packed_base(lane < n ? R0 + lane : R0, K) + R0;
  for (int cc = n - 1; cc > 0; --cc) {
    const double xc = __shfl_sync(FULL, v, cc);
    if (lane < cc) v = sub_product(v, double(P[b + cc]), xc);
  }
  return v;
}

// v - sum_j P[j][r] y[j] over the panel's pivots j0 <= j < j1, in that
// order, each term rounded alone (row r of the forward sweep).
__device__ inline double forward_cols(const float* P, int K, int j0, int j1,
                                      int r, double v, const double* y) {
  int b = packed_base(j0, K);
  for (int j = j0; j < j1; ++j) {
    v = sub_product(v, double(P[b + r]), y[j]);
    b += K - j - 1;
  }
  return v;
}

// v - sum_c P[r][c] y[c] over the columns c0 <= c < c1, from the last
// down (row r of the backward sweep).
__device__ inline double backward_cols(const float* P, int K, int c0, int c1,
                                       int r, double v, const double* y) {
  const float* row = P + packed_base(r, K);
  for (int c = c1 - 1; c >= c0; --c) v = sub_product(v, double(row[c]), y[c]);
  return v;
}

}  // namespace detail

// Solve (L D L^T) x = y in place, y in double in shared memory, against
// the packed factor P (float; L^T in its strict upper triangle) and its
// pivots d, by the whole block (at least two warps), in panels of 32
// pivots.  Forward: warp 0 solves a panel's unit triangle with shuffles
// (detail::forward_diag); after a barrier the other warps update every row
// below the next panel with this panel's 32 columns, while warp 0 updates
// the next panel's rows itself and solves it: one barrier per panel.
// Then y /= d, and the backward sweep the same way from the last panel
// up.  Every element receives the terms of the column-oriented sweeps in
// their order (forward j ascending, backward c descending), each rounded
// alone, so the result does not depend on the panel size.  2 ceil(K/32)
// + 1 barriers in all.
__device__ inline void solve_panels(const float* P, const float* d, int K,
                                    double* y) {
  const int lane = threadIdx.x & 31;
  const bool lead = threadIdx.x < 32;
  const int t1 = int(threadIdx.x) - 32, n1 = int(blockDim.x) - 32;
  const int NP = (K + 31) / 32;
  __syncthreads();
  if (lead) {
    const int n = min(32, K);
    double v = lane < n ? y[lane] : 0.0;
    v = detail::forward_diag(P, K, 0, n, v);
    if (lane < n) y[lane] = v;
  }
  __syncthreads();
  for (int p = 0; p + 1 < NP; ++p) {
    const int P0 = 32 * p, P1 = P0 + 32;
    if (lead) {
      const int n = min(32, K - P1), r = P1 + lane;
      double v = lane < n ? detail::forward_cols(P, K, P0, P1, r, y[r], y)
                          : 0.0;
      v = detail::forward_diag(P, K, P1, n, v);
      if (lane < n) y[r] = v;
    } else {
      for (int r = P1 + 32 + t1; r < K; r += n1)
        y[r] = detail::forward_cols(P, K, P0, P1, r, y[r], y);
    }
    __syncthreads();
  }
  {
    const int R0 = 32 * (NP - 1), n = K - R0;
    if (lead) {
      double v = lane < n ? y[R0 + lane] / double(d[R0 + lane]) : 0.0;
      v = detail::backward_diag(P, K, R0, n, v);
      if (lane < n) y[R0 + lane] = v;
    } else {
      for (int r = t1; r < R0; r += n1) y[r] /= double(d[r]);
    }
    __syncthreads();
  }
  for (int p = NP - 1; p > 0; --p) {
    const int P0 = 32 * p, P1 = min(P0 + 32, K), R0 = P0 - 32;
    if (lead) {
      const int r = R0 + lane;
      double v = detail::backward_cols(P, K, P0, P1, r, y[r], y);
      v = detail::backward_diag(P, K, R0, 32, v);
      y[r] = v;
    } else {
      for (int r = t1; r < R0; r += n1)
        y[r] = detail::backward_cols(P, K, P0, P1, r, y[r], y);
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
