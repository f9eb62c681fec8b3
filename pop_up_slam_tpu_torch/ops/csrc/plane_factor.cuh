// One pose-plane factor as scalar device functions, every plane-factor
// formula of the kernels in one file: its whitened residual and Jacobians
// (the closed form of pop_up_slam_tpu/ops/plane_jacobians.py::_plane_kernel,
// shared by the standalone plane-Jacobian kernel plane_terms.cu and the
// fused Gauss-Newton kernel fused_gn.cu, which then applies its IRLS
// weight), and its residual alone (the LM trial kernel, lm_step.cu).
#pragma once

#include "lie.cuh"

namespace popup {

// R_wc (3x3 row-major), t_wc, pi_w (4): the factor's pose and landmark;
// pim (4): the measured camera-frame plane; A (3x3): its sqrt-info.
// Writes r (3), Jp (3x6 row-major, tangent order (rho, phi)) and
// Jl (3x3), all whitened by A.
__device__ inline void plane_terms_one(const float* R_wc, const float* t_wc,
                                       const float* pi_w, const float* pim,
                                       const float* A, float* r_out,
                                       float* Jp_out, float* Jl_out) {
  float R_cw[9], t_cw[3];
  lie::transpose3(R_wc, R_cw);
  lie::mv3(R_cw, t_wc, t_cw);
  for (int k = 0; k < 3; ++k) t_cw[k] = -t_cw[k];

  // predicted camera-frame plane, with plane.normalize's canonical sign
  float nc[3];
  lie::mv3(R_cw, pi_w, nc);
  float dc = pi_w[3] - lie::dot3(t_cw, nc);
  const float tol = 1e-6f;
  const float sgn = fabsf(dc) > tol      ? lie::signo(dc)
                    : fabsf(nc[2]) > tol ? lie::signo(nc[2])
                    : fabsf(nc[1]) > tol ? lie::signo(nc[1])
                                         : lie::signo(nc[0] + 1e-30f);
  for (int k = 0; k < 3; ++k) nc[k] *= sgn;
  dc *= sgn;
  const float c = sqrtf(fmaxf(lie::dot3(nc, nc), 1e-18f));
  const float inv_c = 1.0f / c;
  float np[3];
  for (int k = 0; k < 3; ++k) np[k] = nc[k] * inv_c;
  const float dp = dc * inv_c;

  // measured plane in Hessian-normal form, sign-aligned to the prediction
  const float nn = fmaxf(sqrtf(lie::dot3(pim, pim)), 1e-9f);
  float nm[3];
  for (int k = 0; k < 3; ++k) nm[k] = pim[k] / nn;
  float dm = pim[3] / nn;
  const float s_al = lie::signo(lie::dot3(np, nm));
  for (int k = 0; k < 3; ++k) nm[k] *= s_al;
  dm *= s_al;
  float B0[3], B1[3];
  lie::normal_tangent_cols(nm, B0, B1);

  float r[3] = {lie::dot3(B0, np), lie::dot3(B1, np), dp - dm};

  // pose Jacobian: rows 0, 1 = B^T hat(np) in the phi columns, row 2 =
  // np^T in the rho columns
  float hn[9];
  lie::hat3(np, hn);
  float Jp[18];
  for (int j = 0; j < 3; ++j) {
    Jp[j] = 0.0f;
    Jp[6 + j] = 0.0f;
    Jp[3 + j] = B0[0] * hn[j] + B0[1] * hn[3 + j] + B0[2] * hn[6 + j];
    Jp[9 + j] = B1[0] * hn[j] + B1[1] * hn[3 + j] + B1[2] * hn[6 + j];
    Jp[12 + j] = np[j];
    Jp[15 + j] = 0.0f;
  }

  // landmark Jacobian through the S^3 tangent basis of pi_w
  float B4[12];
  lie::tangent_basis4(pi_w, B4);
  float dnc[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      dnc[3 * i + j] = sgn * (R_cw[3 * i] * B4[j] + R_cw[3 * i + 1] * B4[3 + j] +
                              R_cw[3 * i + 2] * B4[6 + j]);
  float Jl[9];
  for (int j = 0; j < 3; ++j) {
    const float ddc = sgn * B4[9 + j] -
                      (dnc[j] * t_cw[0] + dnc[3 + j] * t_cw[1] + dnc[6 + j] * t_cw[2]);
    const float npdnc = np[0] * dnc[j] + np[1] * dnc[3 + j] + np[2] * dnc[6 + j];
    float dnp[3];
    for (int i = 0; i < 3; ++i) dnp[i] = (dnc[3 * i + j] - np[i] * npdnc) * inv_c;
    Jl[j] = lie::dot3(B0, dnp);
    Jl[3 + j] = lie::dot3(B1, dnp);
    Jl[6 + j] = (ddc - dp * npdnc) * inv_c;
  }

  // whiten
  lie::mv3(A, r, r_out);
  lie::mmn(A, Jp, Jp_out, 3, 3, 6);
  lie::mmn(A, Jl, Jl_out, 3, 3, 3);
}

// graph.py's plane_residual: A hessian_local(transform(pi_w, T_wc^-1),
// pi_meas), the prediction normalized on S^3 first.
__device__ inline void plane_residual(const float* R_wc, const float* t_wc,
                                      const float* pi_w, const float* pim,
                                      const float* A, float* r_out) {
  float R_cw[9], t_cw[3], pc[4];
  lie::transpose3(R_wc, R_cw);
  lie::mv3(R_cw, t_wc, t_cw);
  for (int k = 0; k < 3; ++k) t_cw[k] = -t_cw[k];
  lie::mv3(R_cw, pi_w, pc);
  pc[3] = pi_w[3] - lie::dot3(t_cw, pc);
  lie::plane_normalize(pc);
  const float cp = fmaxf(sqrtf(lie::dot3(pc, pc)), 1e-9f);
  const float cm = fmaxf(sqrtf(lie::dot3(pim, pim)), 1e-9f);
  float np[3], nm[3];
  for (int k = 0; k < 3; ++k) {
    np[k] = pc[k] / cp;
    nm[k] = pim[k] / cm;
  }
  const float dp = pc[3] / cp;
  float dm = pim[3] / cm;
  const float s = lie::dot3(np, nm) >= 0.0f ? 1.0f : -1.0f;
  for (int k = 0; k < 3; ++k) nm[k] *= s;
  dm *= s;
  float B0[3], B1[3];
  lie::normal_tangent_cols(nm, B0, B1);
  const float r[3] = {lie::dot3(B0, np), lie::dot3(B1, np), dp - dm};
  lie::mv3(A, r, r_out);
}

}  // namespace popup
