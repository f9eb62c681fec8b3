// K1: all Gauss-Newton iterations of the windowed bundle adjustment, plus
// the exiting keyframe's marginal, in one launch of one thread block.
//
// Replaces pop_up_slam_tpu/ops/fused_gn.py::fused_gn_solve (the Pallas
// kernel _fused_kernel / body fused_gn_iterations).  Per iteration:
// analytic linearization of the odometry, prior and pose-plane factors
// with IRLS weights; the blocked normal equations; Schur elimination of
// the landmarks with closed-form 3x3 inverses; the reduced Cholesky solve
// (the K4 device routine in chol.cuh); landmark back-substitution; step
// sanitization; SE(3) / S^3 retraction.
//
// Bound on the H100: about 1 MFLOP per iteration at the production window
// (W=8, L=64, 72 plane factors) and ~50 KB of inputs, so neither bytes nor
// flops bound it: it is a chain of dependent phases (linearize -> assemble
// -> Schur -> 48 pivot steps -> retract), i.e. latency-bound.  The design
// keeps the whole problem (poses, planes, factor Jacobians, Hpp, Hpl,
// Hpl Hll^-1, Hll^-1 and the right-hand sides, ~100 KB) resident in one
// block's shared memory for every iteration, so device memory is touched
// only to read the inputs once and write the outputs once, and there is
// one launch per keyframe.  The normal equations are assembled by
// gathering: each output entry is summed over its factors in index order
// by one thread, with no atomics, so two runs agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chol.cuh"
#include "lie.cuh"

namespace {

constexpr int kThreads = 256;

struct Robust {
  int kind;  // 0 none, 1 huber, 2 cauchy
  float scale;
};

__device__ inline float irls_w(Robust k, float sq) {
  if (k.kind == 0) return 1.0f;
  if (k.kind == 1) return fminf(1.0f, k.scale / sqrtf(fmaxf(sq, 1e-20f)));
  return 1.0f / (1.0f + sq / (k.scale * k.scale));
}

__device__ inline float rho(Robust k, float sq) {
  if (k.kind == 0) return sq;
  if (k.kind == 1) {
    const float nrm = sqrtf(fmaxf(sq, 1e-20f));
    return nrm <= k.scale ? sq : 2.0f * k.scale * nrm - k.scale * k.scale;
  }
  return k.scale * k.scale * log1pf(sq / (k.scale * k.scale));
}

struct Dims {
  int W, L, F, O, P, iters;
};

// Offsets (in 4-byte words) of the shared-memory arrays.
struct Layout {
  int Rs, ts, pls, prR, prt, prA, freem, lmv, pfp, pfl, oi, oj;
  int pr, pJp, pJl, prho, orr, oJi, oJj, orho;
  int Hpp, Hpl, B, Winv, bp, bl, rhs, dxp, dxl, scal, total;
};

__host__ __device__ inline Layout make_layout(Dims d) {
  const int n6 = 6 * d.W, n3 = 3 * d.L, OP = d.O + d.P;
  Layout l;
  int o = 0;
  l.Rs = o;    o += 9 * d.W;
  l.ts = o;    o += 3 * d.W;
  l.pls = o;   o += 4 * d.L;
  l.prR = o;   o += 9 * d.P;
  l.prt = o;   o += 3 * d.P;
  l.prA = o;   o += 36 * d.P;
  l.freem = o; o += d.W;
  l.lmv = o;   o += d.L;
  l.pfp = o;   o += d.F;
  l.pfl = o;   o += d.F;
  l.oi = o;    o += OP;
  l.oj = o;    o += OP;
  l.pr = o;    o += 3 * d.F;
  l.pJp = o;   o += 18 * d.F;
  l.pJl = o;   o += 9 * d.F;
  l.prho = o;  o += d.F;
  l.orr = o;   o += 6 * OP;
  l.oJi = o;   o += 36 * OP;
  l.oJj = o;   o += 36 * OP;
  l.orho = o;  o += OP;
  l.Hpp = o;   o += n6 * n6;
  l.Hpl = o;   o += n6 * n3;
  l.B = o;     o += n6 * n3;
  l.Winv = o;  o += 9 * d.L;
  l.bp = o;    o += n6;
  l.bl = o;    o += n3;
  l.rhs = o;   o += n6;
  l.dxp = o;   o += n6;
  l.dxl = o;   o += n3;
  l.scal = o;  o += 8;
  l.total = o;
  return l;
}

struct Args {
  const float *R, *t, *planes, *prR, *prt, *prA, *pfpi, *pfA, *odR, *odt, *odA;
  const uint8_t* bools;  // [pose_valid W | pose_fixed W | lm_valid L | pf F | od O | pr P]
  const int* idx;        // [pf_pose F | pf_lm F | od_i O | od_j O | pr_idx P]
  const float* marg;     // (8, 16) or null
  float lam;
  Dims d;
  Robust k_odom, k_plane, k_prior;
  int fuse_marg;
  float adiag[6];
  float eps_m, floor_m;
  float *R_out, *t_out, *planes_out, *costs_out, *msqrt_out;
};

// ---------------------------------------------------------------------
// per-factor linearization (one thread per factor)
// ---------------------------------------------------------------------

__device__ void plane_factor(const Args& a, int f, int p, int l,
                             const float* Rs, const float* ts,
                             const float* pls, float* r_out, float* Jp_out,
                             float* Jl_out, float* rho_out) {
  if (p < 0) {
    for (int e = 0; e < 3; ++e) r_out[e] = 0.0f;
    for (int e = 0; e < 18; ++e) Jp_out[e] = 0.0f;
    for (int e = 0; e < 9; ++e) Jl_out[e] = 0.0f;
    *rho_out = rho(a.k_plane, 0.0f);
    return;
  }
  const float* R_wc = Rs + 9 * p;
  const float* t_wc = ts + 3 * p;
  const float* pi_w = pls + 4 * l;
  float R_cw[9], t_cw[3];
  lie::transpose3(R_wc, R_cw);
  lie::mv3(R_cw, t_wc, t_cw);
  for (int k = 0; k < 3; ++k) t_cw[k] = -t_cw[k];

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
  const float* pim = a.pfpi + 4 * f;
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
  const float* A = a.pfA + 9 * f;
  float rw[3], Jpw[18], Jlw[9];
  lie::mv3(A, r, rw);
  lie::mmn(A, Jp, Jpw, 3, 3, 6);
  lie::mmn(A, Jl, Jlw, 3, 3, 3);
  const float sq = lie::dot3(rw, rw);
  *rho_out = rho(a.k_plane, sq);
  const float sw = sqrtf(irls_w(a.k_plane, sq));
  for (int e = 0; e < 3; ++e) r_out[e] = rw[e] * sw;
  for (int e = 0; e < 18; ++e) Jp_out[e] = Jpw[e] * sw;
  for (int e = 0; e < 9; ++e) Jl_out[e] = Jlw[e] * sw;
}

// odometry (o < O) or prior (o >= O) factor
__device__ void pose_factor(const Args& a, int o, int i, int j,
                            const float* Rs, const float* ts,
                            const float* prR, const float* prt,
                            const float* prA, float* r_out, float* Ji_out,
                            float* Jj_out, float* rho_out) {
  const bool prior = o >= a.d.O;
  const Robust k = prior ? a.k_prior : a.k_odom;
  if (j < 0) {
    for (int e = 0; e < 6; ++e) r_out[e] = 0.0f;
    for (int e = 0; e < 36; ++e) { Ji_out[e] = 0.0f; Jj_out[e] = 0.0f; }
    *rho_out = rho(k, 0.0f);
    return;
  }
  const int q = o - a.d.O;
  const float* Ri = prior ? prR + 9 * q : Rs + 9 * i;
  const float* ti = prior ? prt + 3 * q : ts + 3 * i;
  const float* Rj = Rs + 9 * j;
  const float* tj = ts + 3 * j;
  const float* A = prior ? prA + 36 * q : a.odA + 36 * o;

  float R_rel[9], t_rel[3], R_err[9], t_err[3];
  lie::se3_between(Ri, ti, Rj, tj, R_rel, t_rel);
  if (prior) {
    for (int e = 0; e < 9; ++e) R_err[e] = R_rel[e];
    for (int e = 0; e < 3; ++e) t_err[e] = t_rel[e];
  } else {
    lie::se3_between(a.odR + 9 * o, a.odt + 3 * o, R_rel, t_rel, R_err, t_err);
  }
  float r0[6];
  lie::se3_log(R_err, t_err, r0, r0 + 3);
  float Jr[36], AJ[36];
  lie::se3_right_jacobian_inv(r0, r0 + 3, Jr);
  lie::mmn(A, Jr, AJ, 6, 6, 6);
  float R_ji[9], t_ji[3], Ad[36], Ji[36];
  lie::se3_between(Rj, tj, Ri, ti, R_ji, t_ji);
  lie::se3_adjoint(R_ji, t_ji, Ad);
  lie::mmn(AJ, Ad, Ji, 6, 6, 6);
  float r[6];
  lie::mmn(A, r0, r, 6, 6, 1);

  float sq = 0.0f;
  for (int e = 0; e < 6; ++e) sq += r[e] * r[e];
  *rho_out = rho(k, sq);
  const float sw = sqrtf(irls_w(k, sq));
  for (int e = 0; e < 6; ++e) r_out[e] = r[e] * sw;
  for (int e = 0; e < 36; ++e) {
    Ji_out[e] = -Ji[e] * sw;
    Jj_out[e] = AJ[e] * sw;
  }
}

// the exiting keyframe's marginal (pipeline/slam.py _marginalize_oldest)
// from the MARG block; overrides the prior factor when the window is full
__device__ void marginal(const Args& a, float* prR, float* prt, float* prA) {
  const float* M = a.marg;
  const float *R0 = M, *t0 = M + 9, *R1 = M + 16, *t1 = M + 25;
  const float *Rm = M + 32, *tm = M + 41;
  const float ov0 = M[48], full = M[49];
  const float *prRo = M + 64, *prto = M + 73, *prAo = M + 80;

  float Rr[9], tr[3], Re[9], te[3], xi[6], Jr[36], AJ[36];
  lie::se3_between(R0, t0, R1, t1, Rr, tr);
  lie::se3_between(Rm, tm, Rr, tr, Re, te);
  lie::se3_log(Re, te, xi, xi + 3);
  lie::se3_right_jacobian_inv(xi, xi + 3, Jr);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) AJ[6 * i + j] = a.adiag[i] * Jr[6 * i + j];
  float R10[9], t10[3], Ad[36], J0[36], J1[36];
  lie::se3_between(R1, t1, R0, t0, R10, t10);
  lie::se3_adjoint(R10, t10, Ad);
  lie::mmn(AJ, Ad, J0, 6, 6, 6);
  const bool ovb = ov0 > 0.5f;
  for (int e = 0; e < 36; ++e) {
    J0[e] = ovb ? -J0[e] : 0.0f;
    J1[e] = ovb ? AJ[e] : 0.0f;
  }
  float Rpe[9], tpe[3], Jq[36];
  lie::se3_between(prRo, prto, R0, t0, Rpe, tpe);
  lie::se3_log(Rpe, tpe, xi, xi + 3);
  lie::se3_right_jacobian_inv(xi, xi + 3, Jr);
  lie::mmn(prAo, Jr, Jq, 6, 6, 6);

  float H00[36], Hq[36], H01[36], H11[36], H00i[36], T[36], Hm[36];
  lie::mtmn(J0, J0, H00, 6, 6, 6);
  lie::mtmn(Jq, Jq, Hq, 6, 6, 6);
  for (int e = 0; e < 36; ++e) H00[e] += Hq[e] + (e % 7 == 0 ? a.eps_m : 0.0f);
  lie::mtmn(J0, J1, H01, 6, 6, 6);
  lie::mtmn(J1, J1, H11, 6, 6, 6);
  lie::spd_inv6(H00, H00i);
  lie::mtmn(H01, H00i, T, 6, 6, 6);  // H01^T H00^-1
  lie::mmn(T, H01, Hm, 6, 6, 6);
  for (int e = 0; e < 36; ++e) Hm[e] = H11[e] - Hm[e];
  float Hs[36], Lm[36];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j)
      Hs[6 * i + j] = 0.5f * (Hm[6 * i + j] + Hm[6 * j + i]) +
                      (i == j ? a.floor_m : 0.0f);
  lie::chol_lower6(Hs, Lm);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      const float s = Lm[6 * j + i];  // sqrt = L^T
      a.msqrt_out[6 * i + j] = s;
      prA[6 * i + j] = full * s + (1.0f - full) * prAo[6 * i + j];
    }
  for (int e = 0; e < 9; ++e) prR[e] = full * R1[e] + (1.0f - full) * prRo[e];
  for (int e = 0; e < 3; ++e) prt[e] = full * t1[e] + (1.0f - full) * prto[e];
}

__global__ void __launch_bounds__(kThreads) fused_gn_kernel(Args a) {
  extern __shared__ float sm[];
  const Dims d = a.d;
  const int W = d.W, L = d.L, F = d.F, O = d.O, P = d.P, OP = O + P;
  const int n6 = 6 * W, n3 = 3 * L;
  const Layout ly = make_layout(d);
  float *Rs = sm + ly.Rs, *ts = sm + ly.ts, *pls = sm + ly.pls;
  float *prR = sm + ly.prR, *prt = sm + ly.prt, *prA = sm + ly.prA;
  float *freem = sm + ly.freem, *lmv = sm + ly.lmv;
  int *pfp = (int*)(sm + ly.pfp), *pfl = (int*)(sm + ly.pfl);
  int *oi = (int*)(sm + ly.oi), *oj = (int*)(sm + ly.oj);
  float *pr = sm + ly.pr, *pJp = sm + ly.pJp, *pJl = sm + ly.pJl;
  float *prho = sm + ly.prho, *orr = sm + ly.orr, *oJi = sm + ly.oJi;
  float *oJj = sm + ly.oJj, *orho = sm + ly.orho;
  float *Hpp = sm + ly.Hpp, *Hpl = sm + ly.Hpl, *Bm = sm + ly.B;
  float *Winv = sm + ly.Winv, *bp = sm + ly.bp, *bl = sm + ly.bl;
  float *rhs = sm + ly.rhs, *dxp = sm + ly.dxp, *dxl = sm + ly.dxl;
  float* scal = sm + ly.scal;
  const int tid = threadIdx.x, nt = blockDim.x;

  const uint8_t* pval = a.bools;
  const uint8_t* pfix = pval + W;
  const uint8_t* lmvb = pfix + W;
  const uint8_t* pfv = lmvb + L;
  const uint8_t* odv = pfv + F;
  const uint8_t* prv = odv + O;
  const int* pfpose = a.idx;
  const int* pflm = pfpose + F;
  const int* odi = pflm + F;
  const int* odj = odi + O;
  const int* pridx = odj + O;

  // ---- load the state and the static factor wiring ----
  for (int e = tid; e < 9 * W; e += nt) Rs[e] = a.R[e];
  for (int e = tid; e < 3 * W; e += nt) ts[e] = a.t[e];
  for (int e = tid; e < 4 * L; e += nt) pls[e] = a.planes[e];
  for (int e = tid; e < 9 * P; e += nt) prR[e] = a.prR[e];
  for (int e = tid; e < 3 * P; e += nt) prt[e] = a.prt[e];
  for (int e = tid; e < 36 * P; e += nt) prA[e] = a.prA[e];
  for (int w = tid; w < W; w += nt) freem[w] = (pval[w] && !pfix[w]) ? 1.0f : 0.0f;
  for (int l = tid; l < L; l += nt) lmv[l] = lmvb[l] ? 1.0f : 0.0f;
  // an invalid or out-of-range factor is wired to nothing (-1)
  for (int f = tid; f < F; f += nt) {
    const int p = pfpose[f], l = pflm[f];
    const bool ok = pfv[f] && p >= 0 && p < W && l >= 0 && l < L;
    pfp[f] = ok ? p : -1;
    pfl[f] = ok ? l : -1;
  }
  for (int o = tid; o < OP; o += nt) {
    if (o < O) {
      const int i = odi[o], j = odj[o];
      const bool ok = odv[o] && i >= 0 && i < W && j >= 0 && j < W;
      oi[o] = ok ? i : -1;
      oj[o] = ok ? j : -1;
    } else {
      const int j = pridx[o - O];
      const bool ok = prv[o - O] && j >= 0 && j < W;
      oi[o] = -1;  // a prior's "i" side is its constant mean
      oj[o] = ok ? j : -1;
    }
  }
  __syncthreads();
  if (a.fuse_marg && tid == 0) marginal(a, prR, prt, prA);
  __syncthreads();

  const int pbase = (F + 31) / 32 * 32;  // pose factors start on a warp
  const int nHppRows = W * W * 6, nHpl = W * L;
  for (int it = 0; it < d.iters; ++it) {
    // ---- linearize every factor ----
    for (int e = tid; e < pbase + OP; e += nt) {
      if (e < F) {
        plane_factor(a, e, pfp[e], pfl[e], Rs, ts, pls, pr + 3 * e,
                     pJp + 18 * e, pJl + 9 * e, prho + e);
      } else if (e >= pbase) {
        const int o = e - pbase;
        pose_factor(a, o, oi[o], oj[o], Rs, ts, prR, prt, prA, orr + 6 * o,
                    oJi + 36 * o, oJj + 36 * o, orho + o);
      }
    }
    __syncthreads();

    // ---- normal equations by gathering (no atomics), Hll^-1, cost ----
    const int nB = nHppRows + nHpl + n6 + L + 1;
    for (int e = tid; e < nB; e += nt) {
      if (e < nHppRows) {  // one 6-wide row of block (p, q)
        const int p = e / (6 * W), q = (e % (6 * W)) / 6, ra = e % 6;
        float acc[6] = {0, 0, 0, 0, 0, 0};
        for (int o = 0; o < OP; ++o) {
          const int ii = oi[o], jj = oj[o];
          const float* Ji = oJi + 36 * o;
          const float* Jj = oJj + 36 * o;
          const float* X = nullptr;
          const float* Y = nullptr;
          for (int side = 0; side < 4; ++side) {
            const int s0 = side < 2 ? ii : jj;
            const int s1 = (side & 1) ? jj : ii;
            if (s0 != p || s1 != q) continue;
            X = side < 2 ? Ji : Jj;
            Y = (side & 1) ? Jj : Ji;
            for (int b = 0; b < 6; ++b) {
              float s = 0.0f;
              for (int r = 0; r < 6; ++r) s += X[6 * r + ra] * Y[6 * r + b];
              acc[b] += s;
            }
          }
        }
        if (p == q) {
          for (int f = 0; f < F; ++f) {
            if (pfp[f] != p) continue;
            const float* Jp = pJp + 18 * f;
            for (int b = 0; b < 6; ++b)
              acc[b] += Jp[ra] * Jp[b] + Jp[6 + ra] * Jp[6 + b] +
                        Jp[12 + ra] * Jp[12 + b];
          }
        }
        for (int b = 0; b < 6; ++b) Hpp[(6 * p + ra) * n6 + 6 * q + b] = acc[b];
      } else if (e < nHppRows + nHpl) {  // block (p, l) of Hpl
        const int k = e - nHppRows;
        const int p = k / L, l = k % L;
        float acc[18];
        for (int c = 0; c < 18; ++c) acc[c] = 0.0f;
        for (int f = 0; f < F; ++f) {
          if (pfp[f] != p || pfl[f] != l) continue;
          const float* Jp = pJp + 18 * f;
          const float* Jl = pJl + 9 * f;
          for (int ra = 0; ra < 6; ++ra)
            for (int c = 0; c < 3; ++c)
              acc[3 * ra + c] += Jp[ra] * Jl[c] + Jp[6 + ra] * Jl[3 + c] +
                                 Jp[12 + ra] * Jl[6 + c];
        }
        for (int ra = 0; ra < 6; ++ra)
          for (int c = 0; c < 3; ++c)
            Hpl[(6 * p + ra) * n3 + 3 * l + c] = acc[3 * ra + c];
      } else if (e < nHppRows + nHpl + n6) {  // bp entry
        const int k = e - nHppRows - nHpl;
        const int p = k / 6, ra = k % 6;
        float acc = 0.0f;
        for (int o = 0; o < OP; ++o) {
          const float* r = orr + 6 * o;
          if (oi[o] == p) {
            const float* J = oJi + 36 * o;
            for (int x = 0; x < 6; ++x) acc += J[6 * x + ra] * r[x];
          }
          if (oj[o] == p) {
            const float* J = oJj + 36 * o;
            for (int x = 0; x < 6; ++x) acc += J[6 * x + ra] * r[x];
          }
        }
        for (int f = 0; f < F; ++f) {
          if (pfp[f] != p) continue;
          const float* Jp = pJp + 18 * f;
          const float* r = pr + 3 * f;
          acc += Jp[ra] * r[0] + Jp[6 + ra] * r[1] + Jp[12 + ra] * r[2];
        }
        bp[k] = acc;
      } else if (e < nHppRows + nHpl + n6 + L) {  // landmark: Hll, bl, Hll^-1
        const int l = e - nHppRows - nHpl - n6;
        float H[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        float g[3] = {0, 0, 0};
        for (int f = 0; f < F; ++f) {
          if (pfl[f] != l) continue;
          const float* Jl = pJl + 9 * f;
          const float* r = pr + 3 * f;
          for (int x = 0; x < 3; ++x) {
            for (int y = 0; y < 3; ++y)
              H[3 * x + y] += Jl[x] * Jl[y] + Jl[3 + x] * Jl[3 + y] +
                              Jl[6 + x] * Jl[6 + y];
            g[x] += Jl[x] * r[0] + Jl[3 + x] * r[1] + Jl[6 + x] * r[2];
          }
        }
        for (int x = 0; x < 3; ++x) bl[3 * l + x] = g[x];
        float Hd[9];
        for (int x = 0; x < 9; ++x)
          Hd[x] = lmv[l] > 0.5f ? H[x] + (x % 4 == 0 ? a.lam : 0.0f)
                                : (x % 4 == 0 ? 1.0f : 0.0f);
        lie::inv3(Hd, Winv + 9 * l);
      } else {  // robustified cost at this linearization point
        float cpl = 0.0f, co = 0.0f;
        for (int f = 0; f < F; ++f) cpl += prho[f];
        for (int o = 0; o < OP; ++o) co += orho[o];
        scal[1] = 0.5f * (cpl + co);
      }
    }
    __syncthreads();

    // ---- B = Hpl Hll^-1 ----
    for (int e = tid; e < n6 * L; e += nt) {
      const int ra = e / L, l = e % L;
      const float* h = Hpl + ra * n3 + 3 * l;
      const float* wi = Winv + 9 * l;
      for (int c = 0; c < 3; ++c)
        Bm[ra * n3 + 3 * l + c] = h[0] * wi[c] + h[1] * wi[3 + c] + h[2] * wi[6 + c];
    }
    __syncthreads();

    // ---- reduced system S = Hpp - B Hpl^T (damped, gauge-masked), rhs ----
    for (int e = tid; e < n6 * n6 + n6; e += nt) {
      if (e < n6 * n6) {
        const int ra = e / n6, cb = e % n6;
        const float* x = Bm + ra * n3;
        const float* y = Hpl + cb * n3;
        float s = 0.0f;
        for (int k = 0; k < n3; ++k) s += x[k] * y[k];
        const float pa = freem[ra / 6], pb = freem[cb / 6];
        float v = (Hpp[e] - s + (ra == cb ? a.lam : 0.0f)) * pa * pb;
        if (ra == cb) v += 1.0f - pa;
        Hpp[e] = v;
      } else {
        const int ra = e - n6 * n6;
        const float* x = Bm + ra * n3;
        float s = 0.0f;
        for (int k = 0; k < n3; ++k) s += bl[k] * x[k];
        rhs[ra] = -(bp[ra] - s) * freem[ra / 6];
      }
    }
    __syncthreads();

    popup::chol_solve_shared(Hpp, n6, rhs, n6, scal);

    // ---- pose step; landmark back-substitution ----
    for (int e = tid; e < n6 + L; e += nt) {
      if (e < n6) {
        dxp[e] = rhs[e] * freem[e / 6];
      } else {
        const int l = e - n6;
        float v[3];
        for (int c = 0; c < 3; ++c) {
          float s = 0.0f;
          for (int ra = 0; ra < n6; ++ra)
            s += rhs[ra] * freem[ra / 6] * Hpl[ra * n3 + 3 * l + c];
          v[c] = bl[3 * l + c] + s;
        }
        const float* wi = Winv + 9 * l;
        for (int c = 0; c < 3; ++c)
          dxl[3 * l + c] =
              -(wi[3 * c] * v[0] + wi[3 * c + 1] * v[1] + wi[3 * c + 2] * v[2]) *
              lmv[l];
      }
    }
    __syncthreads();

    // ---- sanitize_step: zero a non-finite or divergent step ----
    if (tid == 0) {
      float sq = 0.0f;
      for (int e = 0; e < n6; ++e) sq += dxp[e] * dxp[e];
      for (int e = 0; e < n3; ++e) sq += dxl[e] * dxl[e];
      scal[2] = (isfinite(sq) && sq < 1e6f) ? 1.0f : 0.0f;
      a.costs_out[it] = scal[1];
    }
    __syncthreads();
    const float okf = scal[2];

    // ---- retract ----
    for (int e = tid; e < W + L; e += nt) {
      if (e < W) {
        if (freem[e] > 0.5f) {
          float rho6[3], phi6[3], Rd[9], td[3], Rn[9], tn[3];
          for (int k = 0; k < 3; ++k) {
            rho6[k] = dxp[6 * e + k] * okf;
            phi6[k] = dxp[6 * e + 3 + k] * okf;
          }
          lie::se3_exp(rho6, phi6, Rd, td);
          lie::se3_compose(Rs + 9 * e, ts + 3 * e, Rd, td, Rn, tn);
          for (int k = 0; k < 9; ++k) Rs[9 * e + k] = Rn[k];
          for (int k = 0; k < 3; ++k) ts[3 * e + k] = tn[k];
        }
      } else {
        const int l = e - W;
        if (lmv[l] > 0.5f) {
          float* pi = pls + 4 * l;
          float B4[12], pn[4];
          lie::tangent_basis4(pi, B4);
          for (int i = 0; i < 4; ++i)
            pn[i] = pi[i] + B4[3 * i] * (dxl[3 * l] * okf) +
                    B4[3 * i + 1] * (dxl[3 * l + 1] * okf) +
                    B4[3 * i + 2] * (dxl[3 * l + 2] * okf);
          lie::plane_normalize(pn);
          for (int i = 0; i < 4; ++i) pi[i] = pn[i];
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < 9 * W; e += nt) a.R_out[e] = Rs[e];
  for (int e = tid; e < 3 * W; e += nt) a.t_out[e] = ts[e];
  for (int e = tid; e < 4 * L; e += nt) a.planes_out[e] = pls[e];
}

}  // namespace

extern "C" int popup_fused_gn_smem_bytes(int W, int L, int F, int O, int P) {
  return (int)sizeof(float) * make_layout(Dims{W, L, F, O, P, 0}).total;
}

extern "C" int popup_fused_gn(
    const float* R, const float* t, const float* planes, const float* prR,
    const float* prt, const float* prA, const float* pfpi, const float* pfA,
    const float* odR, const float* odt, const float* odA, const uint8_t* bools,
    const int* idx, const float* marg, float lam, int W, int L, int F, int O,
    int P, int iters, int k_odom, float s_odom, int k_plane, float s_plane,
    int k_prior, float s_prior, const float* marg_static, float* R_out,
    float* t_out, float* planes_out, float* costs_out, float* msqrt_out,
    void* stream) {
  Args a;
  a.R = R; a.t = t; a.planes = planes; a.prR = prR; a.prt = prt; a.prA = prA;
  a.pfpi = pfpi; a.pfA = pfA; a.odR = odR; a.odt = odt; a.odA = odA;
  a.bools = bools; a.idx = idx; a.marg = marg; a.lam = lam;
  a.d = Dims{W, L, F, O, P, iters};
  a.k_odom = Robust{k_odom, s_odom};
  a.k_plane = Robust{k_plane, s_plane};
  a.k_prior = Robust{k_prior, s_prior};
  a.fuse_marg = marg != nullptr;
  for (int k = 0; k < 6; ++k) a.adiag[k] = marg_static ? marg_static[k] : 0.0f;
  a.eps_m = marg_static ? marg_static[6] : 0.0f;
  a.floor_m = marg_static ? marg_static[7] : 0.0f;
  a.R_out = R_out; a.t_out = t_out; a.planes_out = planes_out;
  a.costs_out = costs_out; a.msqrt_out = msqrt_out;

  // the wrapper's shape gate (fused_gn_supported) keeps smem within the
  // block limit; past it the attribute call fails and the wrapper raises
  const int smem = popup_fused_gn_smem_bytes(W, L, F, O, P);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_gn_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
