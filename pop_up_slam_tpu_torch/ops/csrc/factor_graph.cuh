// The windowed factor graph as the kernels that solve it receive it, and
// the factor arithmetic they share: K1 (fused_gn.cu) and K6 / K7
// (lm_step.cu).  The plane factor's formulas are plane_factor.cuh's.
//
// One C interface: a kernel's entry takes a pointer table, an int table
// and a float table (ops/_problem.py builds them).  Each table starts with
// the slots every kernel reads (make_problem), then the kernel's own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lie.cuh"

namespace popup {

__host__ __device__ inline int round32(int x) { return (x + 31) & ~31; }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A robust kernel: kind 0 none, 1 huber, 2 cauchy; k its scale, k2 and
// twok the constants k * k and 2 k as factors/robust.py rounds them (the
// product in double, rounded to f32 once)
struct Robust {
  int kind;
  float k, k2, twok;
};

__device__ inline float irls_w(const Robust& r, float sq) {
  if (r.kind == 0) return 1.0f;
  if (r.kind == 1) return fminf(r.k / sqrtf(fmaxf(sq, 1e-20f)), 1.0f);
  return 1.0f / (1.0f + sq / r.k2);
}

__device__ inline float rho(const Robust& r, float sq) {
  if (r.kind == 0) return sq;
  if (r.kind == 1) {
    const float nrm = sqrtf(fmaxf(sq, 1e-20f));
    return nrm <= r.k ? sq : r.twok * nrm - r.k2;
  }
  return r.k2 * log1pf(sq / r.k2);
}

// The window and its factors.  Sqrt-info matrices are read at row stride
// *_As (0: one matrix shared by every factor, as the frame step builds
// them).
struct Problem {
  const float *R, *t, *planes;
  const uint8_t *pose_valid, *pose_fixed, *lm_valid;
  const int *pf_pose, *pf_lm;
  const float *pf_pi, *pf_A;
  const uint8_t* pf_valid;
  const int *od_i, *od_j;
  const float *od_R, *od_t, *od_A;
  const uint8_t* od_valid;
  const int* pr_idx;
  const float *pr_R, *pr_t, *pr_A;
  const uint8_t* pr_valid;
  int W, L, F, O, P;
  int pf_As, od_As, pr_As;
  Robust k_odom, k_plane, k_prior;
};

// Pointer slots of the shared part of the tables; a kernel's own pointers
// start at kOwn, its own ints at kOwnInt and its own floats at kOwnFloat.
enum Slot {
  kR, kT, kPlanes, kPoseValid, kPoseFixed, kLmValid,
  kPfPose, kPfLm, kPfPi, kPfA, kPfValid,
  kOdI, kOdJ, kOdR, kOdT, kOdA, kOdValid,
  kPrIdx, kPrR, kPrT, kPrA, kPrValid,
  kOwn
};
constexpr int kOwnInt = 11;   // W, L, F, O, P, 3 strides, 3 robust kinds
constexpr int kOwnFloat = 9;  // (k, k^2, 2k) of the three robust kernels

inline Problem make_problem(void* const* p, const int* n, const float* x) {
  Problem q;
  q.R = (const float*)p[kR];
  q.t = (const float*)p[kT];
  q.planes = (const float*)p[kPlanes];
  q.pose_valid = (const uint8_t*)p[kPoseValid];
  q.pose_fixed = (const uint8_t*)p[kPoseFixed];
  q.lm_valid = (const uint8_t*)p[kLmValid];
  q.pf_pose = (const int*)p[kPfPose];
  q.pf_lm = (const int*)p[kPfLm];
  q.pf_pi = (const float*)p[kPfPi];
  q.pf_A = (const float*)p[kPfA];
  q.pf_valid = (const uint8_t*)p[kPfValid];
  q.od_i = (const int*)p[kOdI];
  q.od_j = (const int*)p[kOdJ];
  q.od_R = (const float*)p[kOdR];
  q.od_t = (const float*)p[kOdT];
  q.od_A = (const float*)p[kOdA];
  q.od_valid = (const uint8_t*)p[kOdValid];
  q.pr_idx = (const int*)p[kPrIdx];
  q.pr_R = (const float*)p[kPrR];
  q.pr_t = (const float*)p[kPrT];
  q.pr_A = (const float*)p[kPrA];
  q.pr_valid = (const uint8_t*)p[kPrValid];
  q.W = n[0]; q.L = n[1]; q.F = n[2]; q.O = n[3]; q.P = n[4];
  q.pf_As = n[5]; q.od_As = n[6]; q.pr_As = n[7];
  q.k_odom = Robust{n[8], x[0], x[1], x[2]};
  q.k_plane = Robust{n[9], x[3], x[4], x[5]};
  q.k_prior = Robust{n[10], x[6], x[7], x[8]};
  return q;
}

// One block of `threads` threads with `smem` bytes of dynamic shared
// memory; past the block limit the attribute call fails and the wrapper
// raises.
template <typename K, typename... A>
int launch_block(K kernel, int threads, int smem, void* stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The wiring, fixed for the call: an invalid or out-of-range factor is
// wired to nothing (-1); a prior's "i" side is its constant mean.  Also
// the free-pose and valid-landmark masks.
__device__ inline void load_wiring(const Problem& q, int* pfp, int* pfl,
                                   int* oi, int* oj, float* freem,
                                   float* lmv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = q.W, L = q.L, O = q.O;
  for (int f = tid; f < q.F; f += nt) {
    const int p = q.pf_pose[f], l = q.pf_lm[f];
    const bool ok = q.pf_valid[f] && p >= 0 && p < W && l >= 0 && l < L;
    pfp[f] = ok ? p : -1;
    pfl[f] = ok ? l : -1;
  }
  for (int o = tid; o < O + q.P; o += nt) {
    if (o < O) {
      const int i = q.od_i[o], j = q.od_j[o];
      const bool ok = q.od_valid[o] && i >= 0 && i < W && j >= 0 && j < W;
      oi[o] = ok ? i : -1;
      oj[o] = ok ? j : -1;
    } else {
      const int j = q.pr_idx[o - O];
      const bool ok = q.pr_valid[o - O] && j >= 0 && j < W;
      oi[o] = -1;
      oj[o] = ok ? j : -1;
    }
  }
  for (int w = tid; w < W; w += nt)
    freem[w] = (q.pose_valid[w] && !q.pose_fixed[w]) ? 1.0f : 0.0f;
  for (int l = tid; l < L; l += nt) lmv[l] = q.lm_valid[l] ? 1.0f : 0.0f;
}

// Odometry (o < O) or prior (o >= O) factor o between poses i and j at
// the poses (Rs, ts): the whitened residual r (6) and, with jac, the
// Jacobians Jj = A Jr^-1(r0) and (odometry only) Ji = -Jj Ad(T_j^-1 T_i),
// as graph.py's _odom_terms_analytic / _prior_terms_analytic.  The priors'
// means and sqrt-info are read from (prR, prt, prA) at row stride prAs:
// the Problem's, or K1's copy in shared memory, which the marginal may
// replace.  No IRLS weight: the caller applies it.
__device__ inline void pose_factor(const Problem& q, int o, int i, int j,
                                   const float* Rs, const float* ts,
                                   const float* prR, const float* prt,
                                   const float* prA, int prAs, bool jac,
                                   float* r, float* Ji, float* Jj) {
  const bool prior = o >= q.O;
  const int p = o - q.O;
  const float* Ri = prior ? prR + 9 * p : Rs + 9 * i;
  const float* ti = prior ? prt + 3 * p : ts + 3 * i;
  const float* Rj = Rs + 9 * j;
  const float* tj = ts + 3 * j;
  const float* A = prior ? prA + prAs * p : q.od_A + q.od_As * o;
  float R_rel[9], t_rel[3], R_err[9], t_err[3];
  lie::se3_between(Ri, ti, Rj, tj, R_rel, t_rel);
  if (prior) {
    for (int e = 0; e < 9; ++e) R_err[e] = R_rel[e];
    for (int e = 0; e < 3; ++e) t_err[e] = t_rel[e];
  } else {
    lie::se3_between(q.od_R + 9 * o, q.od_t + 3 * o, R_rel, t_rel, R_err,
                     t_err);
  }
  float r0[6];
  lie::se3_log(R_err, t_err, r0, r0 + 3);
  lie::mmn(A, r0, r, 6, 6, 1);
  if (!jac) return;
  float Jr[36];
  lie::se3_right_jacobian_inv(r0, r0 + 3, Jr);
  lie::mmn(A, Jr, Jj, 6, 6, 6);
  if (prior) return;
  float R_ji[9], t_ji[3], Ad[36], T[36];
  lie::se3_between(Rj, tj, Ri, ti, R_ji, t_ji);
  lie::se3_adjoint(R_ji, t_ji, Ad);
  lie::mmn(Jj, Ad, T, 6, 6, 6);
  for (int e = 0; e < 36; ++e) Ji[e] = -T[e];
}

}  // namespace popup
