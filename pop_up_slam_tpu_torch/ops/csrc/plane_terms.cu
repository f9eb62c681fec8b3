// K5: whitened residuals and Jacobians of every pose-plane factor.
//
// Replaces pop_up_slam_tpu/ops/plane_jacobians.py::plane_terms_pallas (the
// Pallas kernel _plane_kernel), which ran the closed form lane-parallel
// over a 42-channel structure-of-arrays packing built by its wrapper.  Here
// one thread computes one factor: it gathers its pose (R, t) and landmark
// plane from the window by pose_idx / lm_idx itself, so there is no
// packing pass, and writes r (F,3), Jp (F,3,6) and Jl (F,3,3) in the
// layout linearize reads.  Invalid factors (and indices outside the
// window) write zeros.
//
// Bound on the H100: ~530 operations per valid factor against ~180 bytes
// read and written, and only F = 72 factors per call in production: far
// below both the memory and the f32 roofline, so the launch bounds it.  The
// design is one launch with no host-side preparation, each thread's reads
// and writes contiguous in its own factor's rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_factor.cuh"

namespace {

__global__ void plane_terms_kernel(const float* __restrict__ R,
                                   const float* __restrict__ t,
                                   const float* __restrict__ planes,
                                   const int* __restrict__ pose_idx,
                                   const int* __restrict__ lm_idx,
                                   const float* __restrict__ pi_meas,
                                   const float* __restrict__ sqrt_info,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ r_out,
                                   float* __restrict__ Jp_out,
                                   float* __restrict__ Jl_out, int F, int W,
                                   int L) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int p = pose_idx[f];
  const int l = lm_idx[f];
  float r[3], Jp[18], Jl[9];
  if (valid[f] && p >= 0 && p < W && l >= 0 && l < L) {
    popup::plane_terms_one(R + 9 * p, t + 3 * p, planes + 4 * l,
                           pi_meas + 4 * f, sqrt_info + 9 * f, r, Jp, Jl);
  } else {
    for (int e = 0; e < 3; ++e) r[e] = 0.0f;
    for (int e = 0; e < 18; ++e) Jp[e] = 0.0f;
    for (int e = 0; e < 9; ++e) Jl[e] = 0.0f;
  }
  for (int e = 0; e < 3; ++e) r_out[3 * f + e] = r[e];
  for (int e = 0; e < 18; ++e) Jp_out[18 * f + e] = Jp[e];
  for (int e = 0; e < 9; ++e) Jl_out[9 * f + e] = Jl[e];
}

}  // namespace

extern "C" int popup_plane_terms(const float* R, const float* t,
                                 const float* planes, const int* pose_idx,
                                 const int* lm_idx, const float* pi_meas,
                                 const float* sqrt_info, const uint8_t* valid,
                                 float* r, float* Jp, float* Jl, int F, int W,
                                 int L, void* stream) {
  if (F <= 0) return 0;
  const int threads = 128;
  const int blocks = (F + threads - 1) / threads;
  plane_terms_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      R, t, planes, pose_idx, lm_idx, pi_meas, sqrt_info, valid, r, Jp, Jl, F,
      W, L);
  return (int)cudaGetLastError();
}
