// K8: the exiting keyframe's marginal sqrt-info in one launch of one warp.
//
// Replaces the per-op ops/marginal.py::marginal_sqrt on the routes that do
// not fold the marginal into K1 (LM, dog-leg, per-op GN, the sharded
// runner's solve): there it was ~734 PyTorch launches a keyframe for a few
// 6 x 6 products, one 6 x 6 SPD inverse and one 6 x 6 Cholesky.  No TPU
// kernel is replaced: the reference runs it as jnp code that XLA fuses.
//
// Bound on the H100: 481 bytes in and out and ~5,000 operations, so the
// launch latency and the serial 6 x 6 inverse and Cholesky on one lane set
// its time.  The design reads the frame step's pre-roll state where it
// lies (the window's R and t at slots 0 and 1, the exiting odometry, its
// valid flag and the slot-0 prior: no packing and no copy on the host
// side), runs marginal.cuh's device code, the same K1 runs from its MARG
// block, on one warp with its scratch in shared memory, and writes the
// 6 x 6 sqrt-info.
#include <cuda_runtime.h>
#include <stdint.h>

#include "marginal.cuh"

namespace {

using namespace popup;

struct Args {
  MargIn in;
  const uint8_t* ov;  // the exiting odometry factor's valid flag
  float adiag[6];
  float eps_m, floor_m;
  float* sqrt_out;    // (6, 6)
};

__global__ void __launch_bounds__(32) marginal_kernel(Args a) {
  __shared__ float sc[kMargScratch];
  marginal_warp(a.in, a.ov[0] != 0, a.adiag, a.eps_m, a.floor_m, sc,
                [&](int e, float s) { a.sqrt_out[e] = s; });
}

}  // namespace

// p: the window's R (W, 3, 3) and t (W, 3), odom_R (W-1, 3, 3), odom_t
// (W-1, 3), odom_valid (W-1,) bool, the prior's R (3, 3), t (3,) and
// sqrt-info (6, 6), all contiguous, then the (6, 6) output; x: the
// odometry sqrt-info diagonal (6), the H00 regularizer, the floor.
extern "C" int popup_marginal(void* const* p, const float* x, void* stream) {
  const float* R = (const float*)p[0];
  const float* t = (const float*)p[1];
  Args a;
  a.in = MargIn{R,
                t,
                R + 9,
                t + 3,
                (const float*)p[2],
                (const float*)p[3],
                (const float*)p[5],
                (const float*)p[6],
                (const float*)p[7]};
  a.ov = (const uint8_t*)p[4];
  a.sqrt_out = (float*)p[8];
  for (int k = 0; k < 6; ++k) a.adiag[k] = x[k];
  a.eps_m = x[6];
  a.floor_m = x[7];
  marginal_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
