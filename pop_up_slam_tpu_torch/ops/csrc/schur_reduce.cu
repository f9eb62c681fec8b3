// K3a and K3b: the Schur reduction of the landmarks out of the windowed
// BA normal equations, S = Hpp - B G^T with B = Hpl Hll^-1 and G = Hpl
// flattened to (6W x 3L).
//
// Replaces pop_up_slam_tpu/ops/schur_pallas.py::schur_reduce_pallas, whose
// two Pallas kernels are
//   K3a _schur_small_kernel (6W <= 128): S, then damping, the free-pose
//       mask with an identity diagonal on masked rows, and the Cholesky
//       solve, in one launch;
//   K3b _schur_gemm_kernel (6W > 128): the tiled S = Hpp - B G^T, after
//       which the wrapper damps and masks S and K4 solves it.
//
// Bound on the H100: at the production window (n = 6W = 48, 3L = 192) the
// product is 0.9 MFLOP on 80 KB of operands, and K3a then runs 48
// dependent pivot steps: both kernels are far from the f32 roofline and
// from the memory rate.  K3a is bound by its pivot chain (latency): the
// design keeps S in one block's shared memory from the product through the
// solve, reads lambda from device memory (no host round trip per
// iteration), and forms S with each thread owning output entries summed
// over 3L in order, with no atomics, so two launches agree bit for bit.
// B and G stream through shared memory in 32-column chunks read along 3L
// (coalesced).  K3b is a plain tiled f32 GEMM on the CUDA cores (not TF32:
// the port keeps full-f32 numerics), 16x16 output tiles with 16-deep
// shared-memory tiles of B and G, the ragged edge masked in the kernel
// (nothing is padded in device memory); it is bound by launch latency at
// n = 144.
#include <cuda_runtime.h>

#include "chol.cuh"

namespace {

constexpr int kChunk = 32;       // K3a: columns of B, G per shared chunk
constexpr int kSmallThreads = 256;
constexpr int kTile = 16;        // K3b: output tile and depth tile

__global__ void schur_small_kernel(const float* __restrict__ Hpp,
                                   const float* __restrict__ B,
                                   const float* __restrict__ G,
                                   const float* __restrict__ rhs,
                                   const float* __restrict__ pm,
                                   const float* __restrict__ lam_p,
                                   float* __restrict__ S_out,
                                   float* __restrict__ x_out, int n, int C) {
  extern __shared__ float sm[];
  constexpr int ld = kChunk + 1;  // padded: column reads hit distinct banks
  float* S = sm;                  // n x n
  float* Bc = S + n * n;          // n x ld
  float* Gc = Bc + n * ld;        // n x ld
  float* y = Gc + n * ld;         // n
  float* scratch = y + n;         // kPanel: the Cholesky's pivot inverses
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // S accumulates B G^T: entry (i, j) is owned by one thread and summed
  // over k = 0 .. C-1 in order
  for (int e = tid; e < n * n; e += nt) S[e] = 0.0f;
  for (int k0 = 0; k0 < C; k0 += kChunk) {
    const int kc = min(kChunk, C - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < n * kChunk; e += nt) {
      const int i = e / kChunk, kk = e % kChunk;
      const bool in = kk < kc;
      Bc[i * ld + kk] = in ? B[i * C + k0 + kk] : 0.0f;
      Gc[i * ld + kk] = in ? G[i * C + k0 + kk] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      float acc = S[e];
      for (int kk = 0; kk < kc; ++kk)
        acc = fmaf(Bc[i * ld + kk], Gc[j * ld + kk], acc);
      S[e] = acc;
    }
  }
  __syncthreads();

  // S = Hpp - B G^T, + lambda I, free-pose mask, identity on masked rows
  const float lam = lam_p[0];
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e % n;
    float s = Hpp[e] - S[e];
    if (i == j) s += lam;
    s = s * pm[j] * pm[i];
    if (i == j) s += 1.0f - pm[i];
    S[e] = s;
    S_out[e] = s;
  }
  for (int i = tid; i < n; i += nt) y[i] = rhs[i] * pm[i];
  __syncthreads();
  popup::chol_solve_shared(S, n, y, n, scratch);
  for (int i = tid; i < n; i += nt) x_out[i] = y[i];
}

__global__ void schur_gemm_kernel(const float* __restrict__ Hpp,
                                  const float* __restrict__ B,
                                  const float* __restrict__ G,
                                  float* __restrict__ S, int n, int C) {
  __shared__ float Bs[kTile][kTile + 1];
  __shared__ float Gs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;   // row of S (and of B)
  const int col = blockIdx.x * kTile + tx;   // column of S
  const int grow = blockIdx.x * kTile + ty;  // row of G this thread loads
  float acc = 0.0f;
  for (int k0 = 0; k0 < C; k0 += kTile) {
    const int k = k0 + tx;
    Bs[ty][tx] = (row < n && k < C) ? B[row * C + k] : 0.0f;
    Gs[ty][tx] = (grow < n && k < C) ? G[grow * C + k] : 0.0f;
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) acc = fmaf(Bs[ty][kk], Gs[tx][kk], acc);
    __syncthreads();
  }
  if (row < n && col < n) S[row * n + col] = Hpp[row * n + col] - acc;
}

}  // namespace

extern "C" int popup_schur_small_smem_bytes(int n) {
  return (int)sizeof(float) *
         (n * n + 2 * n * (kChunk + 1) + n + popup::kPanel);
}

extern "C" int popup_schur_reduce_small(const float* Hpp, const float* B,
                                        const float* G, const float* rhs,
                                        const float* pm, const float* lam,
                                        float* S, float* x, int n, int C,
                                        void* stream) {
  const int smem = popup_schur_small_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      schur_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  schur_small_kernel<<<1, kSmallThreads, smem, (cudaStream_t)stream>>>(
      Hpp, B, G, rhs, pm, lam, S, x, n, C);
  return (int)cudaGetLastError();
}

extern "C" int popup_schur_gemm(const float* Hpp, const float* B,
                                const float* G, float* S, int n, int C,
                                void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  schur_gemm_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(Hpp, B, G, S, n,
                                                              C);
  return (int)cudaGetLastError();
}
