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
// script.
//
// K3b keeps S = Hpp - B G^T alone (the wrapper damps and masks, K4
// solves), for any n and C.  At lm24's n = 144, 3L = 192 it is bound by
// latency too: its bytes take 0.1 us.  A plain tiled GEMM (16x16 tiles, 12
// serial depth steps, each a round trip to memory and two barriers) spent
// that many round trips; this one spends one a chunk:
//   1. each block owns an output tile of whole poses, kGemmPoses a side
//      (6 kGemmPoses rows and columns, the ragged edge masked), one thread
//      per entry (2 poses a side: 144 blocks at n = 144, one wave; 4 a side
//      measured slower there);
//   2. it stages its poses' rows of B and of G in chunks of up to 64 whole
//      landmarks with K3a's loader (every 16-byte load of a thread in
//      flight, 16-byte stores into rows 4 banks apart) and builds, with
//      K3a's ballot, each row pose's set of the chunk's landmarks its B
//      rows touch and each column pose's set its G rows touch (a NaN
//      counts);
//   3. each entry sums only over the landmarks in both sets, in ascending
//      order (two landmarks' loads at a time), with the dense sum's
//      fmaf(B, G, acc) from 0: every skipped term is an exact zero for
//      finite operands, so S keeps the dense ordered sum's bits (up to the
//      sign of a zero), the tiled GEMM's, and equals K3a's S at
//      lambda = 0.
// Nothing is summed with atomics; plain f32 on the CUDA cores (not TF32:
// the port keeps full-f32 numerics).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chol.cuh"

namespace {

constexpr int kSmallThreads = 512;  // K3a, measured against 256 and 1024
constexpr int kMaxChunkL = 64;      // landmarks per chunk (one 64-bit set)
constexpr int kSmemBudget = 232448; // one block's shared memory on the H100
constexpr int kStage = 8;           // K3a: loads in flight a thread and matrix
constexpr int kGemmPoses = 2;       // K3b: poses a tile side
constexpr int kGemmRows = 6 * kGemmPoses;
// K3b: one thread per tile entry, rounded up to whole warps (the ballots)
constexpr int kGemmThreads = (kGemmRows * kGemmRows + 31) / 32 * 32;
// K3b: its 12 rows a matrix take at most 4 16-byte loads a thread
constexpr int kGemmLoads = 4;
// K3b: rows 16-byte aligned (16-byte stores), 4 banks apart (a warp's
// reads of a column across its 6 rows hit distinct banks)
constexpr int kGemmLd = 3 * kMaxChunkL + 4;

// Thread 0 writes %globaltimer (ns) into slot i of K3a's optional stamps
// (5 slots: start, observer sets built, product, damping and mask, solve).
__device__ inline void stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

// Stage columns [k0, k0 + cc) of nb rows of Bsrc and ng rows of Gsrc
// (row stride C) into Bc and Gc (row stride ldc): a thread issues all its
// loads (up to kLoads a matrix, 16 bytes each where `vec` says rows and
// bases allow) before it stores any, so the staging costs about one round
// trip to memory; where ldc is a multiple of 4 and Bc, Gc are 16-byte
// aligned the stores are 16 bytes too.  A unit's row comes from a float reciprocal, not an integer
// division: e + 0.5 over a divisor of at most 192 is at least 1 / 384 from
// an integer, and the quotient (at most the 128 rows) is off by under
// 2e-5.
template <int kLoads>
__device__ inline void stage_chunk(float* Bc, float* Gc, int ldc,
                                   const float* __restrict__ Bsrc,
                                   const float* __restrict__ Gsrc, int C,
                                   int k0, int cc, int nb, int ng, bool vec,
                                   int tid, int nt) {
  const int rows = max(nb, ng);
  if (vec && ((cc | k0) & 3) == 0) {
    const int qr = cc >> 2, nq = rows * qr;
    const float rq = 1.0f / qr;
    const bool vst = (ldc & 3) == 0 &&
                     (((uintptr_t)Bc | (uintptr_t)Gc) & 15) == 0;
    for (int e0 = tid; e0 < nq; e0 += kLoads * nt) {
      float4 vb[kLoads], vg[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * nt;
        if (e < nq) {
          const int i = (int)((e + 0.5f) * rq), kk = 4 * (e - i * qr);
          if (i < nb)
            vb[u] = *reinterpret_cast<const float4*>(Bsrc + i * C + k0 + kk);
          if (i < ng)
            vg[u] = *reinterpret_cast<const float4*>(Gsrc + i * C + k0 + kk);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * nt;
        if (e < nq) {
          const int i = (int)((e + 0.5f) * rq), kk = 4 * (e - i * qr);
          if (i < nb) {
            float* b = Bc + i * ldc + kk;
            if (vst) {
              *reinterpret_cast<float4*>(b) = vb[u];
            } else {
              b[0] = vb[u].x; b[1] = vb[u].y; b[2] = vb[u].z; b[3] = vb[u].w;
            }
          }
          if (i < ng) {
            float* g = Gc + i * ldc + kk;
            if (vst) {
              *reinterpret_cast<float4*>(g) = vg[u];
            } else {
              g[0] = vg[u].x; g[1] = vg[u].y; g[2] = vg[u].z; g[3] = vg[u].w;
            }
          }
        }
      }
    }
  } else {
    const int tot = rows * cc;
    const float rc = 1.0f / cc;
    for (int e0 = tid; e0 < tot; e0 += kLoads * nt) {
      float vb[kLoads], vg[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * nt;
        if (e < tot) {
          const int i = (int)((e + 0.5f) * rc), kk = e - i * cc;
          if (i < nb) vb[u] = Bsrc[i * C + k0 + kk];
          if (i < ng) vg[u] = Gsrc[i * C + k0 + kk];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * nt;
        if (e < tot) {
          const int i = (int)((e + 0.5f) * rc), kk = e - i * cc;
          if (i < nb) Bc[i * ldc + kk] = vb[u];
          if (i < ng) Gc[i * ldc + kk] = vg[u];
        }
      }
    }
  }
}

// The chunk's landmarks (cc columns, 3 a landmark) that each of P poses
// observes: those whose columns hold an entry that is not exactly 0 (a
// NaN counts) in the pose's rows (6 a pose, none past `rows`) of X or,
// where Y is given, of Y.  A warp per (pose, 32 landmarks), lane =
// landmark, one ballot: sets32[2 p] and sets32[2 p + 1] are the low and
// high word of pose p's set (one 64-bit set, little-endian).
__device__ inline void chunk_observers(const float* X, const float* Y,
                                       int ldc, int rows, int cc, int P,
                                       unsigned* sets32, int warp, int nw,
                                       int lane) {
  for (int task = warp; task < 2 * P; task += nw) {
    const int p = task >> 1, l = 32 * (task & 1) + lane;
    bool obs = false;
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {  // unrolled: all of a lane's loads at once
      const int r = 6 * p + rr;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int kk = 3 * l + c;
        if (r < rows && kk < cc) {
          obs |= X[r * ldc + kk] != 0.0f;
          if (Y != nullptr) obs |= Y[r * ldc + kk] != 0.0f;
        }
      }
    }
    const unsigned bits = __ballot_sync(popup::kFull, obs);
    if (lane == 0) sets32[task] = bits;
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
    if (k0 > 0) __syncthreads();         // the previous chunk is consumed
    // 1. stage the chunk's columns of B and G, then per pose the chunk's
    // landmarks it observes in B or G
    stage_chunk<kStage>(Bc, Gc, ldc, B, G, C, k0, cc, n, n, vec, tid, nt);
    __syncthreads();
    chunk_observers(Bc, Gc, ldc, n, cc, P, lmset32, warp, nw, lane);
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

__global__ void __launch_bounds__(kGemmThreads)
schur_gemm_kernel(const float* __restrict__ Hpp, const float* __restrict__ B,
                  const float* __restrict__ G, float* __restrict__ S, int n,
                  int C) {
  __shared__ __align__(16) float Bc[kGemmRows * kGemmLd];  // row poses' B
  __shared__ __align__(16) float Gc[kGemmRows * kGemmLd];  // column poses' G
  // landmark sets of the row poses, then of the column poses
  __shared__ unsigned long long sets[2 * kGemmPoses];
  unsigned* sets32 = reinterpret_cast<unsigned*>(sets);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = kGemmThreads >> 5;
  const int r0 = blockIdx.y * kGemmRows, c0 = blockIdx.x * kGemmRows;
  const int nb = min(kGemmRows, n - r0), ng = min(kGemmRows, n - c0);
  // thread -> (row pose a, column pose b, row, column): 36 threads a pose
  // pair, so a warp spans at most two pairs' landmark loops
  const int pair = tid / 36, e = tid - 36 * pair;
  const int a = pair / kGemmPoses, b = pair - a * kGemmPoses;
  const int i = 6 * a + e / 6, j = 6 * b + e % 6;
  const bool mine = pair < kGemmPoses * kGemmPoses && i < nb && j < ng;
  const bool vec = (C & 3) == 0 &&
                   (((uintptr_t)B | (uintptr_t)G) & 15) == 0;
  float acc = 0.0f;
  for (int k0 = 0; k0 < C; k0 += 3 * kMaxChunkL) {
    const int cc = min(3 * kMaxChunkL, C - k0);
    if (k0 > 0) __syncthreads();  // the previous chunk is consumed
    stage_chunk<kGemmLoads>(Bc, Gc, kGemmLd, B + r0 * C, G + c0 * C, C, k0,
                            cc, nb, ng, vec, tid, kGemmThreads);
    __syncthreads();
    chunk_observers(Bc, nullptr, kGemmLd, nb, cc, kGemmPoses, sets32, warp,
                    nw, lane);
    chunk_observers(Gc, nullptr, kGemmLd, ng, cc, kGemmPoses,
                    sets32 + 2 * kGemmPoses, warp, nw, lane);
    __syncthreads();
    if (mine) {
      const float* x = Bc + i * kGemmLd;
      const float* g = Gc + j * kGemmLd;
      unsigned long long both = sets[a] & sets[kGemmPoses + b];
      while (both) {  // two landmarks a round: their loads issue together
        const int l0 = __ffsll((long long)both) - 1;
        both &= both - 1;
        const int l1 = both ? __ffsll((long long)both) - 1 : -1;
        if (both) both &= both - 1;
        float x0[3], g0[3], x1[3], g1[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k_0 = 3 * l0 + c, k_1 = 3 * l1 + c;
          if (k_0 < cc) { x0[c] = x[k_0]; g0[c] = g[k_0]; }
          if (l1 >= 0 && k_1 < cc) { x1[c] = x[k_1]; g1[c] = g[k_1]; }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (3 * l0 + c < cc) acc = fmaf(x0[c], g0[c], acc);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (l1 >= 0 && 3 * l1 + c < cc) acc = fmaf(x1[c], g1[c], acc);
      }
    }
  }
  if (mine) S[(r0 + i) * n + c0 + j] = Hpp[(r0 + i) * n + c0 + j] - acc;
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
  if (n <= 0) return 0;
  const int tiles = (n + kGemmRows - 1) / kGemmRows;
  schur_gemm_kernel<<<dim3(tiles, tiles), kGemmThreads, 0,
                      (cudaStream_t)stream>>>(Hpp, B, G, S, n, C);
  return (int)cudaGetLastError();
}
