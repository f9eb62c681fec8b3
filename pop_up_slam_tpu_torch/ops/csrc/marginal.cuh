// The exiting keyframe's marginal (pipeline/slam.py _marginalize_oldest,
// ops/marginal.py marginal_sqrt) on one warp: the device code K1
// (fused_gn.cu) runs inside its launch and K8 (marginal.cu) runs alone.
//
// The slot-0 prior and the exiting odometry factor 0->1 (whitened by
// diag(adiag)) are folded, p0 is eliminated in closed form (the 6 x 6 SPD
// inverse of H00), the information is floored and the sqrt-info is
// chol(Hm)^T.  Lanes 0 and 1 run the odometry and the prior residual
// chains (between, log, J_r^-1) as the same code on different data, lane 2
// the adjoint; the 6 x 6 products are spread over the warp; the 6 x 6
// inverse and Cholesky stay on lane 0.
#pragma once

#include "lie.cuh"

namespace popup {

constexpr int kMargScratch = 14 * 36;  // the marginal's 6 x 6 matrices

// The marginal's inputs where they lie, each a row-major 3 x 3 R, a 3-vector
// t or the 6 x 6 prior sqrt-info: K1 passes the rows of its MARG block, K8
// the frame step's state.
struct MargIn {
  const float *R0, *t0, *R1, *t1;  // pre-roll slots 0 and 1
  const float *Rm, *tm;            // the exiting odometry 0 -> 1
  const float *prR, *prt, *prA;    // the slot-0 prior
};

// C = op(A) B for 6 x 6 matrices (op(A) = A or A^T), spread over a warp:
// lane e computes entries e and e + 32, each a 6-term sum in order.
__device__ inline void warp_mm6(const float* A, bool at, const float* B,
                                float* C, int lane) {
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e - 6 * i;
    float s = 0.0f;
    for (int p = 0; p < 6; ++p)
      s += (at ? A[6 * p + i] : A[6 * i + p]) * B[6 * p + j];
    C[e] = s;
  }
}

// The sqrt-info of the marginal on slot 1, by the calling warp: out(e, s)
// receives entry e (row-major) of the 6 x 6 sqrt = L^T, on lane e % 32.
// ov: the odometry factor is valid; adiag, eps, floor_m: the odometry
// sqrt-info diagonal, the H00 regularizer and the information floor.  sc:
// kMargScratch floats of the warp's shared memory.
template <class Out>
__device__ inline void marginal_warp(const MargIn& m, bool ov,
                                     const float* adiag, float eps,
                                     float floor_m, float* sc, Out out) {
  const int lane = threadIdx.x & 31;
  float *Jro = sc, *Jrq = sc + 36, *AJ = sc + 72, *Ad = sc + 108;
  float *J0 = sc + 144, *J1 = sc + 180, *Jq = sc + 216, *H00 = sc + 252;
  float *H01 = sc + 288, *H11 = sc + 324, *H00i = sc + 360, *T = sc + 396;
  float *Hs = sc + 432, *Lm = sc + 468;

  if (lane < 2) {
    // lane 0: log(Rm^-1 (R0^-1 R1)); lane 1: log(I^-1 (prR^-1 R0)), the
    // identity step leaving the prior's relative pose exactly as it is
    const bool od = lane == 0;
    float Ra[9], ta[3], Rb[9], tb[3], Rc[9], tc[3];
    for (int e = 0; e < 9; ++e) {
      Ra[e] = od ? m.R0[e] : m.prR[e];
      Rb[e] = od ? m.R1[e] : m.R0[e];
      Rc[e] = od ? m.Rm[e] : (e % 4 == 0 ? 1.0f : 0.0f);
    }
    for (int e = 0; e < 3; ++e) {
      ta[e] = od ? m.t0[e] : m.prt[e];
      tb[e] = od ? m.t1[e] : m.t0[e];
      tc[e] = od ? m.tm[e] : 0.0f;
    }
    float Rr[9], tr[3], Re[9], te[3], xi[6], Jr[36];
    lie::se3_between(Ra, ta, Rb, tb, Rr, tr);
    lie::se3_between(Rc, tc, Rr, tr, Re, te);
    lie::se3_log(Re, te, xi, xi + 3);
    lie::se3_right_jacobian_inv(xi, xi + 3, Jr);
    float* o = od ? Jro : Jrq;
    for (int e = 0; e < 36; ++e) o[e] = Jr[e];
  } else if (lane == 2) {
    float R10[9], t10[3];
    lie::se3_between(m.R1, m.t1, m.R0, m.t0, R10, t10);
    lie::se3_adjoint(R10, t10, Ad);
  }
  __syncwarp();
  for (int e = lane; e < 36; e += 32) {
    AJ[e] = adiag[e / 6] * Jro[e];
    J1[e] = ov ? AJ[e] : 0.0f;
  }
  warp_mm6(m.prA, false, Jrq, Jq, lane);
  __syncwarp();
  warp_mm6(AJ, false, Ad, J0, lane);
  __syncwarp();
  for (int e = lane; e < 36; e += 32) J0[e] = ov ? -J0[e] : 0.0f;
  __syncwarp();
  warp_mm6(J0, true, J0, H00, lane);
  warp_mm6(Jq, true, Jq, T, lane);
  warp_mm6(J0, true, J1, H01, lane);
  warp_mm6(J1, true, J1, H11, lane);
  __syncwarp();
  for (int e = lane; e < 36; e += 32)
    H00[e] += T[e] + (e % 7 == 0 ? eps : 0.0f);
  __syncwarp();
  if (lane == 0) lie::spd_inv6(H00, H00i);
  __syncwarp();
  warp_mm6(H01, true, H00i, T, lane);  // H01^T H00^-1
  __syncwarp();
  warp_mm6(T, false, H01, Hs, lane);
  __syncwarp();
  for (int e = lane; e < 36; e += 32) Hs[e] = H11[e] - Hs[e];
  __syncwarp();
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e - 6 * i;
    Lm[e] = 0.5f * (Hs[6 * i + j] + Hs[6 * j + i]) +
            (i == j ? floor_m : 0.0f);
  }
  __syncwarp();
  if (lane == 0) lie::chol_lower6(Lm, H00);  // the lower factor, into H00
  __syncwarp();
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e - 6 * i;
    out(e, H00[6 * j + i]);  // sqrt = L^T
  }
}

}  // namespace popup
