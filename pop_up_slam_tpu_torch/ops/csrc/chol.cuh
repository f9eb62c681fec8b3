// Panel-blocked Cholesky factorize + solve of a small SPD system: the
// device routine of the standalone Cholesky kernel (chol_solve.cu), of
// the fused Gauss-Newton kernel (fused_gn.cu) and of the Schur kernel
// K3a (schur_reduce.cu).
//
// Semantics of pop_up_slam_tpu/ops/cholesky_pallas.py::chol_solve_body:
// upper factor U (A = U^T U), modified pivot rule: a pivot at or below
// 1e-7 * max(max diag(A), 1) (the diagonal of the input) marks the
// direction as unconstrained, its U row becomes e_g and its solution
// entry is 0 (the solve skips it instead of emitting NaN).
//
// Right-looking, in panels of NB rows (kPanel = 16 on one block, measured
// faster than 32 there; kPanelDevice = 32 on the device-memory route,
// where every panel costs launches):
//   1. panel: one warp factors the NB x NB diagonal block in registers
//      (lane c owns column c; pivots and U rows travel by __shfl_sync, no
//      block barrier per pivot) and runs the forward solve U^T z = b on
//      the panel's rows;
//   2. rows: each thread owns columns of the panel's row block and solves
//      U11^T U12 = A12 down its column in registers, updating z there;
//   3. trailing: the block subtracts U12^T U12 from the upper triangle of
//      the trailing matrix, a warp four rows by 32-column blocks, each
//      thread a 4 x 1 register tile (the warp reads its rows by broadcast
//      and its columns on consecutive banks); warps and column blocks with
//      nothing on or above the diagonal skip (warp-uniform branches).
// Three block barriers per panel instead of three per pivot.  The back
// substitution U x = z is one warp, panel by panel from the last: each
// lane sums a strided share of the panel rows' products with the solved
// x, a butterfly transposes the partial sums so that lane i holds row i's,
// and the NB x NB diagonal solve runs in registers.  Nothing is
// summed with atomics, so two launches agree bit for bit.  Only the upper
// triangle of A is read; the lower triangle is scratch.
//
// Every function here takes generic pointers, so the same code runs on
// shared memory (one block holds the system) and on device memory (the
// global route of chol_solve.cu, one launch per stage).
#pragma once

#include <math.h>

namespace popup {

constexpr int kPanel = 16;        // one-block route (32 spills: PERF.md)
constexpr int kPanelDevice = 32;  // device-memory route
constexpr unsigned kFull = 0xffffffffu;

// 1e-7 * max(max diag(A), 1) over the input diagonal; one warp (every
// lane gets the value).
__device__ inline float chol_threshold(const float* A, int lda, int n) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, A[i * lda + i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  return 1e-7f * fmaxf(m, 1.0f);
}

// Stage 1, one warp: factor rows/columns k0 .. k0+p-1 (p <= NB) of A in
// registers and run the forward solve on y[k0 .. k0+p-1].  Writes the
// panel's U11 (upper triangle) and the pivots' inverse square roots
// inv[0 .. p) (0 for a skipped pivot).  Lanes and rows past p act as an
// identity block and write nothing.
template <int NB>
__device__ __forceinline__ void panel_warp_body(float* A, int lda, float* y,
                                                int k0, int p, float thresh,
                                                float* inv) {
  const int c = threadIdx.x & 31;
  const bool in = c < p;
  float col[NB];  // col[g] = A[k0+g][k0+c]
#pragma unroll
  for (int g = 0; g < NB; ++g)
    col[g] = (in && g < p) ? A[(k0 + g) * lda + k0 + c]
                           : (g == c ? 1.0f : 0.0f);
  float yc = in ? y[k0 + c] : 0.0f;
#pragma unroll
  for (int g = 0; g < NB; ++g) {
    const float pivot = __shfl_sync(kFull, col[g], g);
    const bool good = pivot > thresh;
    const float ig = good ? rsqrtf(fmaxf(pivot, 1e-20f)) : 0.0f;
    // row g of U at lane c: 0 left of the diagonal, e_g if skipped
    const float u = good ? (c >= g ? col[g] * ig : 0.0f)
                         : (c == g ? 1.0f : 0.0f);
    col[g] = u;
    const float yg = __shfl_sync(kFull, yc, g) * ig;
    yc = c == g ? yg : (c > g ? yc - u * yg : yc);
#pragma unroll
    for (int j = g + 1; j < NB; ++j)
      col[j] -= __shfl_sync(kFull, u, j) * u;
    if (c == g) inv[g] = ig;
  }
  if (in) {
#pragma unroll
    for (int g = 0; g < NB; ++g)
      if (g < p && c >= g) A[(k0 + g) * lda + k0 + c] = col[g];
    y[k0 + c] = yc;
  }
}

// A full panel (p == NB) runs a copy with p a constant, so that no step
// waits on a runtime bound check; the last, partial panel the general one.
template <int NB>
__device__ inline void chol_panel_warp(float* A, int lda, float* y, int k0,
                                       int p, float thresh, float* inv) {
  if (p == NB) panel_warp_body<NB>(A, lda, y, k0, NB, thresh, inv);
  else panel_warp_body<NB>(A, lda, y, k0, p, thresh, inv);
}

// Stage 2: columns j = k0+p+first, +stride, ... < n of the panel's row
// block: U12[:, j] = U11^-T A12[:, j], right-looking in registers (the
// column is loaded once and stored once, so no load waits on a store and
// each step's updates are independent), then the forward solve's update
// of y[j] by the panel's z.
template <int NB>
__device__ __forceinline__ void panel_rows_body(float* A, int lda, float* y,
                                                int k0, int p, int n,
                                                const float* inv, int first,
                                                int stride) {
  for (int j = k0 + p + first; j < n; j += stride) {
    float v[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i)
      v[i] = i < p ? A[(k0 + i) * lda + j] : 0.0f;
    float yj = y[j];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      if (r < p) {
        v[r] *= inv[r];
        const float* U = A + (k0 + r) * lda + k0;
#pragma unroll
        for (int i = r + 1; i < NB; ++i)
          if (i < p) v[i] -= U[i] * v[r];
        yj -= v[r] * y[k0 + r];
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < p) A[(k0 + i) * lda + j] = v[i];
    y[j] = yj;
  }
}

template <int NB>
__device__ inline void chol_panel_rows(float* A, int lda, float* y, int k0,
                                       int p, int n, const float* inv,
                                       int first, int stride) {
  if (p == NB) panel_rows_body<NB>(A, lda, y, k0, NB, n, inv, first, stride);
  else panel_rows_body<NB>(A, lda, y, k0, p, n, inv, first, stride);
}

// Stage 3 on one macro tile: A -= U12^T U12 on rows j0 + 4 ty + a (a < 4,
// this warp's rows) and columns c0 + tx + 32 b (b < ncb), upper triangle
// (j <= k) only.  A warp with no row in range, and a column block wholly
// left of the warp's rows or past the edge, skips.
__device__ inline void chol_trailing_tile(float* A, int lda, int k0, int p,
                                          int n, int j0, int c0, int tx,
                                          int ty, int ncb) {
  const int jr = j0 + 4 * ty;
  if (jr >= n) return;
  for (int b = 0; b < ncb; ++b) {
    const int cb = c0 + 32 * b;
    if (cb >= n || cb + 31 < jr) continue;
    const int k = cb + tx;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int i = 0; i < p; ++i) {
      const float* U = A + (k0 + i) * lda;
      const float uc = k < n ? U[k] : 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        acc[a] = fmaf(jr + a < n ? U[jr + a] : 0.0f, uc, acc[a]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = jr + a;
      if (j < n && k < n && j <= k) A[j * lda + k] -= acc[a];
    }
  }
}

// Stage 3 by the whole block: every macro tile (4 ny rows x 128 columns)
// of the trailing matrix that reaches the upper triangle.
__device__ inline void chol_trailing_block(float* A, int lda, int k0, int p,
                                           int n) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int ny = blockDim.x >> 5;
  const int k1 = k0 + p;
  for (int j0 = k1; j0 < n; j0 += 4 * ny)
    for (int c0 = k1; c0 < n; c0 += 128)
      if (c0 + 127 >= j0)
        chol_trailing_tile(A, lda, k0, p, n, j0, c0, tx, ty, 4);
}

// One butterfly step of the back substitution's transpose-reduce: lanes
// with bit M set keep the upper M of their first 2M partial sums, the
// others the lower M, each adding its partner's copy (a template, so that
// every index is a constant and acc stays in registers).
template <int M>
__device__ __forceinline__ void butterfly_step(float* acc, int c) {
  const bool up = (c & M) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? acc[i] : acc[i + M];
    const float keep = up ? acc[i + M] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, M);
  }
}

// One panel (rows k0 .. k0+p-1) of the back substitution by one warp.
template <int NB>
__device__ __forceinline__ void back_panel(const float* A, int lda, float* y,
                                           int n, int k0, int p, int c) {
  const int k1 = k0 + p;
  // acc[i]: this lane's share of sum_{k >= k1} U[k0+i][k] x[k]
  float acc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i] = 0.0f;
  for (int k = k1 + c; k < n; k += 32) {
    const float xk = y[k];
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < p) acc[i] = fmaf(A[(k0 + i) * lda + k], xk, acc[i]);
  }
  // butterfly transpose-reduce: lane i ends with row i's sum in acc[0]
  if (NB == 32) {
    butterfly_step<NB / 2>(acc, c);
  } else {  // 16 rows over 32 lanes: fold the halves, then transpose
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], 16);
  }
  butterfly_step<8>(acc, c);
  butterfly_step<4>(acc, c);
  butterfly_step<2>(acc, c);
  butterfly_step<1>(acc, c);
  float r = c < p ? y[k0 + c] - acc[0] : 0.0f;
  float urow[NB];  // urow[g] = U[k0+c][k0+g]
#pragma unroll
  for (int g = 0; g < NB; ++g)
    urow[g] = (c < p && g < p) ? A[(k0 + c) * lda + k0 + g] : 0.0f;
  // this lane's diagonal, inverted off the dependency chain
  const float ukk = c < p ? A[(k0 + c) * lda + k0 + c] : 1.0f;
  const float rinv = 1.0f / (fabsf(ukk) < 1e-20f ? 1e-20f : ukk);
#pragma unroll
  for (int g = NB - 1; g >= 0; --g) {
    if (g < p) {
      const float xg = __shfl_sync(kFull, r * rinv, g);
      r = c == g ? xg : (c < g ? r - urow[g] * xg : r);
    }
  }
  if (c < p) y[k0 + c] = r;
  __syncwarp();
}

// Back substitution U x = z by one warp, from the last panel; y holds z
// on entry, x on return.
template <int NB>
__device__ inline void chol_back_warp(const float* A, int lda, float* y,
                                      int n) {
  const int c = threadIdx.x & 31;
  for (int k0 = (n - 1) / NB * NB; k0 >= 0; k0 -= NB) {
    const int p = min(NB, n - k0);
    if (p == NB) back_panel<NB>(A, lda, y, n, k0, NB, c);
    else back_panel<NB>(A, lda, y, n, k0, p, c);
  }
}

// The whole solve on one block (blockDim.x a multiple of 32).  A: n x n
// row-major (leading dimension lda), factorized in place (its upper
// triangle ends up holding U); y: n floats holding b on entry and x on
// return; scratch: kPanel floats.  Every thread of the block must call this,
// after a barrier that completes A and y.
__device__ inline void chol_solve_shared(float* A, int lda, float* y, int n,
                                         float* scratch) {
  const int warp = threadIdx.x >> 5;
  const float thresh = warp == 0 ? chol_threshold(A, lda, n) : 0.0f;
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int p = min(kPanel, n - k0);
    if (warp == 0) chol_panel_warp<kPanel>(A, lda, y, k0, p, thresh, scratch);
    __syncthreads();
    chol_panel_rows<kPanel>(A, lda, y, k0, p, n, scratch, threadIdx.x,
                            blockDim.x);
    __syncthreads();
    if (k0 + p < n) {
      chol_trailing_block(A, lda, k0, p, n);
      __syncthreads();
    }
  }
  if (warp == 0) chol_back_warp<kPanel>(A, lda, y, n);
  __syncthreads();
}

}  // namespace popup
