// K4: standalone Cholesky factorize + solve of one SPD system.
//
// Replaces pop_up_slam_tpu/ops/cholesky_pallas.py::chol_solve_pallas (a
// panel-blocked upper Cholesky + forward/back substitution in one Pallas
// launch).  Both routes run the panel-blocked routine of chol.cuh.
//
// Bound on the H100: n^3/3 flops on 4 n^2 bytes (n = 144: 1.0 MFLOP,
// 83 KB), nanoseconds at the f32 and HBM rates; the kernel is bound by
// its chain of dependent stages (latency).  The design cuts that chain
// from 3-4 block barriers per pivot to three per panel, runs each panel's
// pivots inside one warp with register shuffles, and spreads the trailing
// updates over the block as register tiles (chol.cuh).
//
//   n <= kSharedMaxN: one block of 1024 threads holds A (n x n), z and the
//     panel's pivot inverses in shared memory (n = 224: 197 KB of the
//     227 KB a block may use), 16-row panels; one launch.
//   n >  kSharedMaxN: A lives in device memory (the caller's workspace;
//     at n = 384 it is 590 KB, resident in the 50 MB L2).  Per 32-row
//     panel, one single-block launch factors the panel and solves its row
//     block, and one grid launch applies the trailing update, a macro
//     tile per block; then one warp back-substitutes.  All launches go on
//     the caller's stream, which orders them.
#include <cuda_runtime.h>

#include "chol.cuh"

namespace {

constexpr int kSharedMaxN = 224;   // the largest multiple of 32 that fits
                                   // (256 x 256 floats do not)
constexpr int kSharedThreads = 1024;  // measured against 256 and 512 (PERF.md)
constexpr int kPanelThreads = 512;
constexpr int kTrailThreads = 128;  // macro tile 16 rows x 32 columns

__global__ void __launch_bounds__(kSharedThreads) chol_solve_kernel(
    const float* __restrict__ S, const float* __restrict__ b,
    float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  float* A = sm;
  float* y = A + n * n;
  float* scratch = y + n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) A[e] = S[e];
  for (int e = threadIdx.x; e < n; e += blockDim.x) y[e] = b[e];
  __syncthreads();
  popup::chol_solve_shared(A, n, y, n, scratch);
  for (int e = threadIdx.x; e < n; e += blockDim.x) x[e] = y[e];
}

// global route ------------------------------------------------------

__global__ void chol_copy_kernel(const float* __restrict__ S,
                                 const float* __restrict__ b,
                                 float* __restrict__ A, float* __restrict__ x,
                                 int n) {
  const int nn = n * n;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nn + n;
       e += gridDim.x * blockDim.x) {
    if (e < nn) A[e] = S[e];
    else x[e - nn] = b[e - nn];
  }
}

// panel k0: factor the diagonal block (warp 0), then the row block; the
// threshold comes from the input S at the first panel and is kept in
// *thresh_slot for the later ones
constexpr int NBD = popup::kPanelDevice;

__global__ void __launch_bounds__(kPanelThreads) chol_panel_kernel(
    const float* __restrict__ S, float* A, float* y, float* thresh_slot,
    int n, int k0) {
  __shared__ float inv[NBD];
  const int p = min(NBD, n - k0);
  if ((threadIdx.x >> 5) == 0) {
    float thresh;
    if (k0 == 0) {
      thresh = popup::chol_threshold(S, n, n);
      if (threadIdx.x == 0) *thresh_slot = thresh;
    } else {
      thresh = *thresh_slot;
    }
    popup::chol_panel_warp<NBD>(A, n, y, k0, p, thresh, inv);
  }
  __syncthreads();
  popup::chol_panel_rows<NBD>(A, n, y, k0, p, n, inv, threadIdx.x,
                              blockDim.x);
}

// trailing update after panel k0: block (bx, by) takes the macro tile at
// rows k1 + 16 by, columns k1 + 32 bx, if it reaches the upper triangle
__global__ void __launch_bounds__(kTrailThreads) chol_trailing_kernel(
    float* A, int n, int k0) {
  const int ny = blockDim.x >> 5;
  const int p = min(NBD, n - k0);
  const int j0 = k0 + p + 4 * ny * blockIdx.y;
  const int c0 = k0 + p + 32 * blockIdx.x;
  if (c0 + 31 < j0) return;
  popup::chol_trailing_tile(A, n, k0, p, n, j0, c0, threadIdx.x & 31,
                            threadIdx.x >> 5, 1);
}

__global__ void chol_back_kernel(const float* A, float* y, int n) {
  popup::chol_back_warp<NBD>(A, n, y, n);
}

}  // namespace

// work: n*n + 1 floats of device memory for n > kSharedMaxN (else unused).
extern "C" int popup_chol_solve(const float* S, const float* b, float* x,
                                float* work, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= kSharedMaxN) {
    const int smem = (int)sizeof(float) * (n * n + n + popup::kPanel);
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    chol_solve_kernel<<<1, kSharedThreads, smem, st>>>(S, b, x, n);
    return (int)cudaGetLastError();
  }
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  float* A = work;
  float* thresh_slot = work + (size_t)n * n;
  chol_copy_kernel<<<(n * n + n + 255) / 256, 256, 0, st>>>(S, b, A, x, n);
  const int rows = 4 * (kTrailThreads / 32);
  for (int k0 = 0; k0 < n; k0 += NBD) {
    chol_panel_kernel<<<1, kPanelThreads, 0, st>>>(S, A, x, thresh_slot, n,
                                                   k0);
    const int k1 = k0 + NBD;
    if (k1 < n) {
      const int m = n - k1;
      const dim3 grid((m + 31) / 32, (m + rows - 1) / rows);
      chol_trailing_kernel<<<grid, kTrailThreads, 0, st>>>(A, n, k0);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  chol_back_kernel<<<1, 32, 0, st>>>(A, x, n);
  return (int)cudaGetLastError();
}
