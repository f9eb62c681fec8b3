// Shared-memory Cholesky factorize + solve of a small SPD system, written
// once for the whole block and used by the standalone Cholesky kernel
// (chol_solve.cu) and by the fused Gauss-Newton kernel (fused_gn.cu).
//
// Semantics of pop_up_slam_tpu/ops/cholesky_pallas.py::chol_solve_body:
// upper factor U (A = U^T U), modified pivot rule: a pivot at or below
// 1e-7 * max(max diag(A), 1) marks the direction as unconstrained, its U
// row becomes e_g and its solution entry is 0 (the solve skips it instead
// of emitting NaN).  Unblocked right-looking form: one pivot per step,
// the whole trailing square updated in parallel by the block.
#pragma once

#include <math.h>

namespace popup {

// A: n x n row-major in shared memory (leading dimension lda), factorized
// in place (the upper triangle ends up holding U).  y: n floats in shared
// memory holding b on entry and x on return.  red: 1 float of shared
// scratch.  Every thread of the block must call this.
__device__ inline void chol_solve_shared(float* A, int lda, float* y, int n,
                                         float* red) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) {
    float m = -INFINITY;
    for (int i = 0; i < n; ++i) m = fmaxf(m, A[i * lda + i]);
    red[0] = 1e-7f * fmaxf(m, 1.0f);
  }
  __syncthreads();
  const float thresh = red[0];

  // factorize + fused forward solve U^T z = b
  for (int g = 0; g < n; ++g) {
    const float pivot = A[g * lda + g];
    const bool good = pivot > thresh;
    const float inv = good ? rsqrtf(fmaxf(pivot, 1e-20f)) : 0.0f;
    const float yg = y[g] * inv;
    __syncthreads();  // everyone has read the pivot and y[g]
    for (int k = g + tid; k < n; k += nt) {
      A[g * lda + k] = good ? A[g * lda + k] * inv : (k == g ? 1.0f : 0.0f);
    }
    if (tid == 0) y[g] = yg;
    __syncthreads();  // row g of U is complete
    const int m = n - g - 1;
    for (int e = tid; e < m * m; e += nt) {
      const int j = g + 1 + e / m;
      const int k = g + 1 + e % m;
      A[j * lda + k] -= A[g * lda + j] * A[g * lda + k];
    }
    for (int k = g + 1 + tid; k < n; k += nt) y[k] -= A[g * lda + k] * yg;
    __syncthreads();
  }

  // back substitution U x = z, column-oriented
  for (int g = n - 1; g >= 0; --g) {
    const float ukk = A[g * lda + g];
    const float xg = y[g] / (fabsf(ukk) < 1e-20f ? 1e-20f : ukk);
    __syncthreads();  // everyone has read y[g]
    if (tid == 0) y[g] = xg;
    for (int j = tid; j < g; j += nt) y[j] -= A[j * lda + g] * xg;
    __syncthreads();
  }
}

}  // namespace popup
