// SE(3) / SO(3) / S^3 algebra as scalar device functions.
//
// The CUDA counterpart of pop_up_slam_tpu/ops/soa_math.py (itself the
// component form of geometry/se3.py and geometry/plane.py): same
// formulas, same f32 small-angle Taylor switches below kSmall, same
// first-maximum tie rules.  Matrices are row-major float arrays (3x3 = 9,
// 6x6 = 36, the 4x3 tangent basis = 12), vectors plain float arrays.
#pragma once

#include <math.h>

namespace lie {

constexpr float kEps = 1e-8f;
constexpr float kSmall = 0.1f;

__device__ __forceinline__ float signo(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float safe_norm3(const float* v) {
  const float sq = dot3(v, v);
  return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// ---- small-angle coefficient functions (se3.py) ----
__device__ inline float sinc(float x) {
  const float x2 = x * x;
  if (fabsf(x) < kSmall) return 1.0f - x2 / 6.0f + x2 * x2 / 120.0f;
  return sinf(x) / x;
}
__device__ inline float cosc(float x) {
  const float s = sinc(0.5f * x);
  return 0.5f * s * s;
}
__device__ inline float sincc(float x) {
  const float x2 = x * x;
  if (fabsf(x) < kSmall) return 1.0f / 6.0f - x2 / 120.0f + x2 * x2 / 5040.0f;
  return (x - sinf(x)) / (x * x * x);
}
__device__ inline float cot_term(float th) {
  const float t2 = th * th;
  if (th < kSmall) return 1.0f / 12.0f + t2 / 720.0f + t2 * t2 / 30240.0f;
  const float h = 0.5f * th;
  return (1.0f - h * cosf(h) / fmaxf(sinf(h), kEps)) / (th * th);
}
__device__ inline float c2_coeff(float th) {
  const float t2 = th * th;
  if (th < kSmall) return 1.0f / 24.0f - t2 / 720.0f + t2 * t2 / 40320.0f;
  return (th * th + 2.0f * cosf(th) - 2.0f) / (2.0f * th * th * th * th);
}
__device__ inline float c3_coeff(float th) {
  const float t2 = th * th;
  if (th < kSmall) return 1.0f / 120.0f - t2 / 2520.0f + t2 * t2 / 120960.0f;
  return (2.0f * th - 3.0f * sinf(th) + th * cosf(th)) /
         (2.0f * th * th * th * th * th);
}

// ---- 3x3 helpers ----
__device__ inline void mm3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}
__device__ inline void mv3(const float* A, const float* x, float* y) {
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}
__device__ inline void transpose3(const float* A, float* At) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) At[3 * i + j] = A[3 * j + i];
}
__device__ inline void hat3(const float* v, float* K) {
  K[0] = 0.0f;  K[1] = -v[2]; K[2] = v[1];
  K[3] = v[2];  K[4] = 0.0f;  K[5] = -v[0];
  K[6] = -v[1]; K[7] = v[0];  K[8] = 0.0f;
}
__device__ inline void hat3_sq(const float* v, float* KK) {
  const float n2 = dot3(v, v);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      KK[3 * i + j] = v[i] * v[j] - (i == j ? n2 : 0.0f);
}
// M = I + a K + b KK
__device__ inline void eye_plus(float a, const float* K, float b,
                                const float* KK, float* M) {
  for (int e = 0; e < 9; ++e)
    M[e] = (e % 4 == 0 ? 1.0f : 0.0f) + a * K[e] + b * KK[e];
}

// ---- SO(3) / SE(3) ----
__device__ inline void so3_exp(const float* phi, float* R) {
  const float th = safe_norm3(phi);
  float K[9], KK[9];
  hat3(phi, K);
  hat3_sq(phi, KK);
  eye_plus(sinc(th), K, cosc(th), KK, R);
}

// Shepperd's method, candidate chosen by the first maximum of
// (tr, m00, m11, m22); w >= 0.
__device__ inline void rotmat_to_quat(const float* R, float* q) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = m00 + m11 + m22;
  const bool c0 = (tr >= m00) && (tr >= m11) && (tr >= m22);
  const bool c1 = !c0 && (m00 >= m11) && (m00 >= m22);
  const bool c2 = !c0 && !c1 && (m11 >= m22);
  if (c0) {
    q[0] = 1.0f + tr; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (c1) {
    q[0] = m21 - m12; q[1] = 1.0f + m00 - m11 - m22; q[2] = m01 + m10;
    q[3] = m02 + m20;
  } else if (c2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = 1.0f - m00 + m11 - m22;
    q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21;
    q[3] = 1.0f - m00 - m11 + m22;
  }
  const float nrm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float s = signo(q[0] / nrm) / nrm;
  for (int k = 0; k < 4; ++k) q[k] *= s;
}

__device__ inline void so3_log(const float* R, float* phi) {
  float q[4];
  rotmat_to_quat(R, q);
  const float w = q[0];
  const float* v = q + 1;
  const float vn = safe_norm3(v);
  const float ws = fmaxf(w, kEps);
  const float scale = vn < 1e-3f
                          ? 2.0f / ws - 2.0f * vn * vn / (3.0f * ws * ws * ws)
                          : 2.0f * atan2f(vn, w) / fmaxf(vn, kEps);
  for (int k = 0; k < 3; ++k) phi[k] = scale * v[k];
}

__device__ inline void se3_V(const float* phi, float* V) {
  const float th = safe_norm3(phi);
  float K[9], KK[9];
  hat3(phi, K);
  hat3_sq(phi, KK);
  eye_plus(cosc(th), K, sincc(th), KK, V);
}

__device__ inline void se3_V_inv(const float* phi, float* Vi) {
  const float th = safe_norm3(phi);
  float K[9], KK[9];
  hat3(phi, K);
  hat3_sq(phi, KK);
  eye_plus(-0.5f, K, cot_term(th), KK, Vi);
}

// Barfoot's Q(rho, phi).
__device__ inline void se3_Q(const float* rho, const float* phi, float* Q) {
  const float th = safe_norm3(phi);
  const float c1 = sincc(th), c2 = c2_coeff(th), c3 = c3_coeff(th);
  float rx[9], px[9], pr[9], rp[9], prp[9], ppr[9], rpp[9], prpp[9], pprp[9];
  hat3(rho, rx);
  hat3(phi, px);
  mm3(px, rx, pr);
  mm3(rx, px, rp);
  mm3(pr, px, prp);
  mm3(px, pr, ppr);
  mm3(rp, px, rpp);
  mm3(prp, px, prpp);
  mm3(ppr, px, pprp);
  for (int e = 0; e < 9; ++e)
    Q[e] = 0.5f * rx[e] + c1 * (pr[e] + rp[e] + prp[e]) +
           c2 * (ppr[e] + rpp[e] - 3.0f * prp[e]) + c3 * (prpp[e] + pprp[e]);
}

// J_r^-1(xi) = J_l^-1(-xi) = [[V^-1, -V^-1 Q V^-1], [0, V^-1]] at -xi.
__device__ inline void se3_right_jacobian_inv(const float* rho, const float* phi,
                                              float* J) {
  const float nr[3] = {-rho[0], -rho[1], -rho[2]};
  const float np[3] = {-phi[0], -phi[1], -phi[2]};
  float Vi[9], Q[9], T[9], TR[9];
  se3_V_inv(np, Vi);
  se3_Q(nr, np, Q);
  mm3(Vi, Q, T);
  mm3(T, Vi, TR);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      J[6 * i + j] = Vi[3 * i + j];
      J[6 * i + 3 + j] = -TR[3 * i + j];
      J[6 * (i + 3) + j] = 0.0f;
      J[6 * (i + 3) + 3 + j] = Vi[3 * i + j];
    }
}

// Ad(R, t) = [[R, hat(t) R], [0, R]].
__device__ inline void se3_adjoint(const float* R, const float* t, float* Ad) {
  float tx[9], tR[9];
  hat3(t, tx);
  mm3(tx, R, tR);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Ad[6 * i + j] = R[3 * i + j];
      Ad[6 * i + 3 + j] = tR[3 * i + j];
      Ad[6 * (i + 3) + j] = 0.0f;
      Ad[6 * (i + 3) + 3 + j] = R[3 * i + j];
    }
}

__device__ inline void se3_log(const float* R, const float* t, float* rho,
                               float* phi) {
  float Vi[9];
  so3_log(R, phi);
  se3_V_inv(phi, Vi);
  mv3(Vi, t, rho);
}

__device__ inline void se3_exp(const float* rho, const float* phi, float* R,
                               float* t) {
  float V[9];
  so3_exp(phi, R);
  se3_V(phi, V);
  mv3(V, rho, t);
}

__device__ inline void se3_compose(const float* Ra, const float* ta,
                                   const float* Rb, const float* tb, float* R,
                                   float* t) {
  mm3(Ra, Rb, R);
  mv3(Ra, tb, t);
  for (int k = 0; k < 3; ++k) t[k] += ta[k];
}

// a^-1 o b
__device__ inline void se3_between(const float* Ra, const float* ta,
                                   const float* Rb, const float* tb, float* R,
                                   float* t) {
  float Ri[9], ti[3];
  transpose3(Ra, Ri);
  mv3(Ri, ta, ti);
  for (int k = 0; k < 3; ++k) ti[k] = -ti[k];
  se3_compose(Ri, ti, Rb, tb, R, t);
}

// ---- small dense helpers (ld = leading dimension) ----
__device__ inline void mmn(const float* A, const float* B, float* C, int n,
                           int k, int m) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      float s = 0.0f;
      for (int p = 0; p < k; ++p) s += A[k * i + p] * B[m * p + j];
      C[m * i + j] = s;
    }
}
// C = A^T B with A (k x n), B (k x m)
__device__ inline void mtmn(const float* A, const float* B, float* C, int n,
                            int k, int m) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      float s = 0.0f;
      for (int p = 0; p < k; ++p) s += A[n * p + i] * B[m * p + j];
      C[m * i + j] = s;
    }
}

// closed-form 3x3 inverse, |det| floored at 1e-12 (solver.schur.inv3x3)
__device__ inline void inv3(const float* M, float* Mi) {
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A00 = e * i - f * h, A01 = c * h - b * i, A02 = b * f - c * e;
  const float A10 = f * g - d * i, A11 = a * i - c * g, A12 = c * d - a * f;
  const float A20 = d * h - e * g, A21 = b * g - a * h, A22 = a * e - b * d;
  float det = a * A00 + b * A10 + c * A20;
  if (fabsf(det) < 1e-12f) det = 1e-12f;
  Mi[0] = A00 / det; Mi[1] = A01 / det; Mi[2] = A02 / det;
  Mi[3] = A10 / det; Mi[4] = A11 / det; Mi[5] = A12 / det;
  Mi[6] = A20 / det; Mi[7] = A21 / det; Mi[8] = A22 / det;
}

// 6x6 SPD inverse by 3x3 block elimination (solver.schur.spd_inv6_blocked)
__device__ inline void spd_inv6(const float* H, float* Hi) {
  float A[9], B[9], D[9], Ai[9], AiB[9], BtAiB[9], S[9], Si[9], TR[9], T2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = H[6 * i + j];
      B[3 * i + j] = H[6 * i + 3 + j];
      D[3 * i + j] = H[6 * (i + 3) + 3 + j];
    }
  inv3(A, Ai);
  mm3(Ai, B, AiB);
  mtmn(B, AiB, BtAiB, 3, 3, 3);
  for (int e = 0; e < 9; ++e) S[e] = D[e] - BtAiB[e];
  inv3(S, Si);
  mm3(AiB, Si, TR);
  for (int e = 0; e < 9; ++e) TR[e] = -TR[e];
  // TL = Ai - TR AiB^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      T2[3 * i + j] = TR[3 * i] * AiB[3 * j] + TR[3 * i + 1] * AiB[3 * j + 1] +
                      TR[3 * i + 2] * AiB[3 * j + 2];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Hi[6 * i + j] = Ai[3 * i + j] - T2[3 * i + j];
      Hi[6 * i + 3 + j] = TR[3 * i + j];
      Hi[6 * (i + 3) + j] = TR[3 * j + i];
      Hi[6 * (i + 3) + 3 + j] = Si[3 * i + j];
    }
}

// right-looking lower Cholesky of a 6x6, pivots floored at 1e-12
// (solver.schur.chol_small)
__device__ inline void chol_lower6(const float* A_in, float* L) {
  float A[36];
  for (int e = 0; e < 36; ++e) { A[e] = A_in[e]; L[e] = 0.0f; }
  for (int j = 0; j < 6; ++j) {
    const float d = sqrtf(fmaxf(A[6 * j + j], 1e-12f));
    float col[6];
    for (int i = 0; i < 6; ++i) col[i] = i >= j ? A[6 * i + j] / d : 0.0f;
    for (int i = j; i < 6; ++i) L[6 * i + j] = col[i];
    for (int i = 0; i < 6; ++i)
      for (int k = 0; k < 6; ++k) A[6 * i + k] -= col[i] * col[k];
  }
}

// ---- planes on S^3 ----
// unit 4-norm + canonical sign (plane.normalize)
__device__ inline void plane_normalize(float* pi) {
  const float nrm = fmaxf(
      sqrtf(pi[0] * pi[0] + pi[1] * pi[1] + pi[2] * pi[2] + pi[3] * pi[3]),
      1e-9f);
  for (int k = 0; k < 4; ++k) pi[k] /= nrm;
  const float tol = 1e-6f;
  const float s = fabsf(pi[3]) > tol   ? signo(pi[3])
                  : fabsf(pi[2]) > tol ? signo(pi[2])
                  : fabsf(pi[1]) > tol ? signo(pi[1])
                                       : signo(pi[0] + 1e-30f);
  for (int k = 0; k < 4; ++k) pi[k] *= s;
}

// Householder tangent basis of S^3 at pi (4x3 row-major): k = first
// argmax |pi_k|, kept columns the three != k in ascending order.
__device__ inline void tangent_basis4(const float* pi, float* B) {
  int k = 0;
  float best = fabsf(pi[0]);
  for (int i = 1; i < 4; ++i)
    if (fabsf(pi[i]) > best) { best = fabsf(pi[i]); k = i; }
  const float s = signo(pi[k]);
  float v[4];
  for (int i = 0; i < 4; ++i) v[i] = pi[i] - (i == k ? s : 0.0f);
  const float vv = fmaxf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3],
                         1e-9f);
  for (int i = 0; i < 4; ++i) {
    int c = 0;
    for (int j = 0; j < 4; ++j) {
      if (j == k) continue;
      B[3 * i + c] = (i == j ? 1.0f : 0.0f) - 2.0f * v[i] * v[j] / vv;
      ++c;
    }
  }
}

// the two tangent columns of S^2 at unit normal n (plane.normal_tangent_basis)
__device__ inline void normal_tangent_cols(const float* n, float* c0, float* c1) {
  int k = 0;
  float best = fabsf(n[0]);
  for (int i = 1; i < 3; ++i)
    if (fabsf(n[i]) > best) { best = fabsf(n[i]); k = i; }
  const float s = signo(n[k]);
  float v[3];
  for (int i = 0; i < 3; ++i) v[i] = n[i] - (i == k ? s : 0.0f);
  const float vv = fmaxf(dot3(v, v), 1e-9f);
  const int j0 = k == 0 ? 1 : 0;
  const int j1 = k == 2 ? 1 : 2;
  for (int i = 0; i < 3; ++i) {
    c0[i] = (i == j0 ? 1.0f : 0.0f) - 2.0f * v[i] * v[j0] / vv;
    c1[i] = (i == j1 ? 1.0f : 0.0f) - 2.0f * v[i] * v[j1] / vv;
  }
}

}  // namespace lie
