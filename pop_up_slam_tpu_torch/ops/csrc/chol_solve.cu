// K4: standalone Cholesky factorize + solve of one SPD system.
//
// Replaces pop_up_slam_tpu/ops/cholesky_pallas.py::chol_solve_pallas (a
// panel-blocked upper Cholesky + forward/back substitution in one Pallas
// launch).  On the H100 the n x n system (n = 6W = 48 in production) fits
// in one block's shared memory, so the whole solve is one launch of one
// block with no device-memory traffic between its stages.  The work is
// O(n^3/3) flops but n sequential pivot steps, each ending in a block
// barrier: the kernel is bound by that dependency chain (latency), not by
// bytes or flops.  The design keeps every step inside shared memory and
// spreads each trailing update over the block's threads.
#include <cuda_runtime.h>

#include "chol.cuh"

namespace {

__global__ void chol_solve_kernel(const float* __restrict__ S,
                                  const float* __restrict__ b,
                                  float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  float* A = sm;
  float* y = A + n * n;
  float* red = y + n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) A[e] = S[e];
  for (int e = threadIdx.x; e < n; e += blockDim.x) y[e] = b[e];
  __syncthreads();
  popup::chol_solve_shared(A, n, y, n, red);
  for (int e = threadIdx.x; e < n; e += blockDim.x) x[e] = y[e];
}

}  // namespace

extern "C" int popup_chol_solve(const float* S, const float* b, float* x,
                                int n, void* stream) {
  const int smem = (int)sizeof(float) * (n * n + n + 1);  // A, y, red
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chol_solve_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(S, b, x, n);
  return (int)cudaGetLastError();
}
