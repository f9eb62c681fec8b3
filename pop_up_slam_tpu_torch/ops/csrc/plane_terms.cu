// K5: whitened residuals and Jacobians of every pose-plane factor.
//
// Replaces pop_up_slam_tpu/ops/plane_jacobians.py::plane_terms_pallas (the
// Pallas kernel _plane_kernel), which ran the closed form lane-parallel
// over a 42-channel structure-of-arrays packing built by its wrapper.  Here
// each block takes kFactors factors, one thread a factor, in three phases:
//   1. one wave of loads: every thread issues its share of the window's R,
//      t and planes (coalesced, into shared memory) together with its own
//      factor's indices, valid flag, measured plane and sqrt-info (one
//      matrix where every factor shares it: a_stride 0, the SLAM step's
//      broadcast), so the gather by pose and landmark index reads shared
//      memory and costs no second round trip;
//   2. the closed form, popup::plane_terms_one (the routine the fused GN
//      kernel shares, unchanged: its outputs keep their bits), into the
//      block's rows of r, Jp and Jl in shared memory;
//   3. the block writes those rows out as three contiguous runs (a warp
//      store touches one line where a thread's 30 strided stores touched
//      32).
// Invalid factors (and indices outside the window) write zeros.  The
// outputs are one buffer of 30 F floats: r (F,3), then Jp (F,3,6), then
// Jl (F,3,3).
//
// Bound on the H100: ~530 operations per valid factor against ~180 bytes
// read and written, and only F = 72 factors per call in production: far
// below both the memory and the f32 roofline, so latency bounds it: the
// launch, one round trip to memory, the closed form's dependent chain (the
// largest phase: its divisions, square roots and the S^3 basis) and the
// stores.  Optional %globaltimer stamps (block 0, thread 0) split it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_factor.cuh"

namespace {

constexpr int kFactors = 32;   // factors per block: one computing warp
constexpr int kThreads = 128;  // window staging and stores: four warps
constexpr int kStage = 4;      // window loads in flight a thread
constexpr int kSmemBudget = 232448;  // one block's shared memory on the H100

// Shared layout (floats): the window, R (9W) | t (3W) | planes (4L), then
// the block's rows of r (3 kFactors) | Jp (18 kFactors) | Jl (9 kFactors).
__host__ __device__ inline int smem_floats(int W, int L) {
  return 12 * W + 4 * L + 30 * kFactors;
}

// Thread 0 of block 0 writes %globaltimer (ns) into slot i of the optional
// stamps (4 slots: start, loads staged, closed form, stores issued).
__device__ inline void stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

// kStamps: the instance that writes the stamps; the other has no barrier
// after its stores
template <bool kStamps>
__global__ void __launch_bounds__(kThreads)
plane_terms_kernel(const float* __restrict__ R, const float* __restrict__ t,
                   const float* __restrict__ planes,
                   const int* __restrict__ pose_idx,
                   const int* __restrict__ lm_idx,
                   const float* __restrict__ pi_meas,
                   const float* __restrict__ sqrt_info,
                   const uint8_t* __restrict__ valid, float* __restrict__ out,
                   int F, int W, int L, int a_stride,
                   unsigned long long* stamps) {
  extern __shared__ float sm[];
  const int nwin = 12 * W + 4 * L;
  float* sR = sm;
  float* st = sR + 9 * W;
  float* spl = st + 3 * W;
  float* sr = sm + nwin;
  float* sJp = sr + 3 * kFactors;
  float* sJl = sJp + 18 * kFactors;
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kFactors;
  const int nf = min(kFactors, F - f0);
  const int f = f0 + tid;
  if (!kStamps) stamps = nullptr;
  stamp(stamps, 0);

  // 1. one wave of loads: the factor's own row, then the window (kStage
  // floats a thread and round, all loads of a round before its stores)
  const bool own = tid < nf;
  int p = -1, l = -1;
  bool ok = false;
  float4 pim;
  float A[9];
  if (own) {
    p = pose_idx[f];
    l = lm_idx[f];
    ok = valid[f] != 0;
    if ((reinterpret_cast<uintptr_t>(pi_meas) & 15) == 0)
      pim = reinterpret_cast<const float4*>(pi_meas)[f];
    else
      pim = make_float4(pi_meas[4 * f], pi_meas[4 * f + 1],
                        pi_meas[4 * f + 2], pi_meas[4 * f + 3]);
    const float* a = sqrt_info + a_stride * f;
#pragma unroll
    for (int e = 0; e < 9; ++e) A[e] = a[e];
  }
  for (int i0 = tid; i0 < nwin; i0 += kStage * kThreads) {
    float v[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * kThreads;
      if (i < 9 * W)
        v[k] = R[i];
      else if (i < 12 * W)
        v[k] = t[i - 9 * W];
      else if (i < nwin)
        v[k] = planes[i - 12 * W];
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * kThreads;
      if (i < nwin) sm[i] = v[k];
    }
  }
  __syncthreads();
  stamp(stamps, 1);

  // 2. the closed form, one thread a factor, gathering from shared memory
  if (own) {
    const float pm[4] = {pim.x, pim.y, pim.z, pim.w};
    float* r = sr + 3 * tid;
    float* Jp = sJp + 18 * tid;
    float* Jl = sJl + 9 * tid;
    if (ok && p >= 0 && p < W && l >= 0 && l < L) {
      popup::plane_terms_one(sR + 9 * p, st + 3 * p, spl + 4 * l, pm, A, r,
                             Jp, Jl);
    } else {
      for (int e = 0; e < 3; ++e) r[e] = 0.0f;
      for (int e = 0; e < 18; ++e) Jp[e] = 0.0f;
      for (int e = 0; e < 9; ++e) Jl[e] = 0.0f;
    }
  }
  __syncthreads();
  stamp(stamps, 2);

  // 3. the block's rows of r, Jp and Jl are three contiguous runs
  float* r_out = out + 3 * f0;
  float* Jp_out = out + 3 * F + 18 * f0;
  float* Jl_out = out + 21 * F + 9 * f0;
  for (int e = tid; e < 30 * nf; e += kThreads) {
    if (e < 3 * nf)
      r_out[e] = sr[e];
    else if (e < 21 * nf)
      Jp_out[e - 3 * nf] = sJp[e - 3 * nf];
    else
      Jl_out[e - 21 * nf] = sJl[e - 21 * nf];
  }
  if (kStamps) {
    __syncthreads();
    stamp(stamps, 3);
  }
}

}  // namespace

extern "C" int popup_plane_terms(const float* R, const float* t,
                                 const float* planes, const int* pose_idx,
                                 const int* lm_idx, const float* pi_meas,
                                 const float* sqrt_info, const uint8_t* valid,
                                 float* out, int F, int W, int L,
                                 int a_stride, unsigned long long* stamps,
                                 void* stream) {
  if (F <= 0) return 0;
  const int smem = 4 * smem_floats(W, L);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  auto* kernel = stamps != nullptr ? plane_terms_kernel<true>
                                    : plane_terms_kernel<false>;
  if (smem > 48 * 1024) {  // above the default limit: a window this wide
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (F + kFactors - 1) / kFactors;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      R, t, planes, pose_idx, lm_idx, pi_meas, sqrt_info, valid, out, F, W, L,
      a_stride, stamps);
  return (int)cudaGetLastError();
}
