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
// dense product would be 0.9 MFLOP on 80 KB of operands, and K3a then
// runs 48 dependent pivot steps: both kernels are far from the f32
// roofline and from the memory rate, and K3a is bound by latency.  Its
// design, one block of kSmallThreads:
//   1. B and G stream through shared memory in chunks of whole landmarks
//      (up to 64, fewer where n is large: shared memory stays
//      O(n^2 + n * chunk)), rows padded to an odd stride, each thread
//      issuing all its 16-byte loads before its stores.  From each chunk
//      the block builds, per pose p (6 rows; the last may be partial), the
//      set of the chunk's landmarks whose 6x3 block of B or of G has an
//      entry that is not exactly 0 (a NaN counts): one warp ballot per 32
//      landmarks.
//   2. S is formed by items (pose pair p, q; row ra of p), each with 6
//      register accumulators (one per column of q), summing only over the
//      landmarks both poses observe, in ascending landmark order and
//      components c = 0, 1, 2, with the same fmaf(B, G, acc) as the dense
//      sum.  Every skipped term is an exact zero for finite operands, so
//      each entry keeps the dense ordered sum's bits (up to the sign of a
//      zero).  All P^2 blocks are formed: S is returned whole.
//   3. S = Hpp - B G^T, + lambda I (lambda read from device memory: LM and
//      dog-leg never wait on the host), free-pose mask, identity on
//      masked rows; then the chol.cuh solve on the block.
// Nothing is summed with atomics, so two launches agree bit for bit.
// Optional %globaltimer stamps at the phase boundaries feed the profile
// script.  K3b is a plain tiled f32 GEMM on the CUDA cores (not TF32: the
// port keeps full-f32 numerics), 16x16 output tiles with 16-deep
// shared-memory tiles of B and G, the ragged edge masked in the kernel
// (nothing is padded in device memory); it is bound by launch latency at
// n = 144.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chol.cuh"

namespace {

constexpr int kSmallThreads = 512;  // K3a, measured against 256 and 1024
constexpr int kMaxChunkL = 64;      // K3a: landmarks per chunk (one 64-bit set)
constexpr int kSmemBudget = 232448; // one block's shared memory on the H100
constexpr int kStage = 8;           // K3a: loads in flight a thread and matrix
constexpr int kTile = 16;           // K3b: output tile and depth tile

// Thread 0 writes %globaltimer (ns) into slot i of the optional stamps (5
// slots: start, observer sets built, product, damping and mask, solve).
__device__ inline void stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

// Shared layout of K3a for n rows, cl landmarks per chunk:
// S (n x n) | Bc, Gc (n x ldc each, ldc = 3 cl + 1) | y (n) | scratch
// (kPanel) | the per-pose landmark sets (P x 64 bits, 8-byte aligned).
__host__ __device__ inline int small_poses(int n) { return (n + 5) / 6; }

__host__ __device__ inline int small_smem_bytes(int n, int cl) {
  const int floats = n * n + 2 * n * (3 * cl + 1) + n + popup::kPanel;
  return (floats + 1) / 2 * 8 + 8 * small_poses(n);
}

// The most landmarks per chunk (<= kMaxChunkL, <= the landmarks there
// are) whose layout fits one block; a multiple of 4 where the chunks do
// not cover all columns at once, so that each chunk's columns start
// 16-byte aligned.
int small_chunk(int n, int C) {
  const int lm = (C + 2) / 3;
  int cl = lm < 1 ? 1 : (lm < kMaxChunkL ? lm : kMaxChunkL);
  while (cl > 1 && small_smem_bytes(n, cl) > kSmemBudget) --cl;
  if (3 * cl < C && cl >= 4) cl &= ~3;
  return cl;
}

__global__ void __launch_bounds__(kSmallThreads)
schur_small_kernel(const float* __restrict__ Hpp, const float* __restrict__ B,
                   const float* __restrict__ G, const float* __restrict__ rhs,
                   const float* __restrict__ pm,
                   const float* __restrict__ lam_p, float* __restrict__ S_out,
                   float* __restrict__ x_out, int n, int C, int cl,
                   unsigned long long* stamps) {
  extern __shared__ float sm[];
  const int ldc = 3 * cl + 1;  // odd: rows of one column hit distinct banks
  const int P = small_poses(n);
  float* S = sm;               // n x n
  float* Bc = S + n * n;       // n x ldc
  float* Gc = Bc + n * ldc;    // n x ldc
  float* y = Gc + n * ldc;     // n
  float* scratch = y + n;      // kPanel: the Cholesky's pivot inverses
  const int nf = n * n + 2 * n * ldc + n + popup::kPanel;
  unsigned long long* lmset = reinterpret_cast<unsigned long long*>(
      sm + (nf + 1) / 2 * 2);  // P: landmarks of the chunk each pose observes
  unsigned* lmset32 = reinterpret_cast<unsigned*>(lmset);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  stamp(stamps, 0);

  for (int i = tid; i < n; i += nt) y[i] = rhs[i] * pm[i];
  if (C <= 0)  // no landmarks: B G^T = 0
    for (int e = tid; e < n * n; e += nt) S[e] = 0.0f;
  const int n_items = P * P * 8;  // (p, q, ra): 8 slots per pair, 6 used
  const bool vec = (C & 3) == 0 &&
                   (((uintptr_t)B | (uintptr_t)G) & 15) == 0;
  for (int k0 = 0; k0 < C; k0 += 3 * cl) {
    const int cc = min(3 * cl, C - k0);  // columns of this chunk
    const int lc = (cc + 2) / 3;         // its landmarks
    if (k0 > 0) __syncthreads();         // the previous chunk is consumed
    // 1. stage the chunk's columns of B and G: a thread issues all its
    // loads (up to 2 kStage, 16 bytes each where rows allow) before it
    // stores any, so the staging costs about one round trip to memory
    if (vec && ((cc | k0) & 3) == 0) {
      const int qr = cc >> 2, nq = n * qr;
      for (int e0 = tid; e0 < nq; e0 += kStage * nt) {
        float4 vb[kStage], vg[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int e = e0 + u * nt;
          if (e < nq) {
            const int i = e / qr, kk = 4 * (e - i * qr);
            vb[u] = *reinterpret_cast<const float4*>(B + i * C + k0 + kk);
            vg[u] = *reinterpret_cast<const float4*>(G + i * C + k0 + kk);
          }
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int e = e0 + u * nt;
          if (e < nq) {
            const int i = e / qr, kk = 4 * (e - i * qr);
            float* b = Bc + i * ldc + kk;
            float* g = Gc + i * ldc + kk;
            b[0] = vb[u].x; b[1] = vb[u].y; b[2] = vb[u].z; b[3] = vb[u].w;
            g[0] = vg[u].x; g[1] = vg[u].y; g[2] = vg[u].z; g[3] = vg[u].w;
          }
        }
      }
    } else {
      const int tot = n * cc;
      for (int e0 = tid; e0 < tot; e0 += kStage * nt) {
        float vb[kStage], vg[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int e = e0 + u * nt;
          if (e < tot) {
            const int i = e / cc, kk = e - i * cc;
            vb[u] = B[i * C + k0 + kk];
            vg[u] = G[i * C + k0 + kk];
          }
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int e = e0 + u * nt;
          if (e < tot) {
            const int i = e / cc, kk = e - i * cc;
            Bc[i * ldc + kk] = vb[u];
            Gc[i * ldc + kk] = vg[u];
          }
        }
      }
    }
    __syncthreads();
    // per pose, the chunk's landmarks it observes: a warp per (pose, 32
    // landmarks), lane = landmark, one ballot
    for (int task = warp; task < 2 * P; task += nw) {
      const int p = task >> 1, l = 32 * (task & 1) + lane;
      bool obs = false;
      if (l < lc) {
        for (int r = 6 * p; r < min(6 * p + 6, n); ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int kk = 3 * l + c;
            if (kk < cc)
              obs |= (Bc[r * ldc + kk] != 0.0f) | (Gc[r * ldc + kk] != 0.0f);
          }
      }
      const unsigned bits = __ballot_sync(popup::kFull, obs);
      if (lane == 0) lmset32[task] = bits;  // little-endian: low word first
    }
    __syncthreads();
    if (k0 == 0) stamp(stamps, 1);
    // 2. S += B G^T over the landmarks both poses observe, in order
    for (int e = tid; e < n_items; e += nt) {
      const int k = e >> 3, ra = e & 7;
      const int p = k / P, q = k - p * P;
      const int row = 6 * p + ra;
      if (ra >= 6 || row >= n) continue;
      const int nc = min(6, n - 6 * q);
      float* s = S + row * n + 6 * q;
      float acc[6];
#pragma unroll
      for (int cb = 0; cb < 6; ++cb)
        acc[cb] = (k0 > 0 && cb < nc) ? s[cb] : 0.0f;
      const float* x = Bc + row * ldc;
      const float* g = Gc + 6 * q * ldc;
      unsigned long long both = lmset[p] & lmset[q];
      while (both) {
        const int l = __ffsll((long long)both) - 1;
        both &= both - 1;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int kk = 3 * l + c;
          if (kk >= cc) break;
          const float xv = x[kk];
#pragma unroll
          for (int cb = 0; cb < 6; ++cb)
            if (cb < nc) acc[cb] = fmaf(xv, g[cb * ldc + kk], acc[cb]);
        }
      }
#pragma unroll
      for (int cb = 0; cb < 6; ++cb)
        if (cb < nc) s[cb] = acc[cb];
    }
  }
  __syncthreads();
  stamp(stamps, 2);

  // 3. S = Hpp - B G^T, + lambda I, free-pose mask, identity on masked rows
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
  __syncthreads();
  stamp(stamps, 3);
  popup::chol_solve_shared(S, n, y, n, scratch);
  for (int i = tid; i < n; i += nt) x_out[i] = y[i];
  stamp(stamps, 4);
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

extern "C" int popup_schur_reduce_small(const float* Hpp, const float* B,
                                        const float* G, const float* rhs,
                                        const float* pm, const float* lam,
                                        float* S, float* x, int n, int C,
                                        unsigned long long* stamps,
                                        void* stream) {
  const int cl = small_chunk(n, C);
  const int smem = small_smem_bytes(n, cl);
  cudaError_t err = cudaFuncSetAttribute(
      schur_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  schur_small_kernel<<<1, kSmallThreads, smem, (cudaStream_t)stream>>>(
      Hpp, B, G, rhs, pm, lam, S, x, n, C, cl, stamps);
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
