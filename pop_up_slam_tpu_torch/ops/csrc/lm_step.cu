// K6 and K7: the Levenberg-Marquardt iteration around K5 and K3a.
//
// One LM iteration of solver/gauss_newton.py::lm_solve is four launches on
// CUDA tensors: K5 (the plane terms), K6 lm_assemble_kernel (below), K3a
// (the Schur reduction and the reduced solve) and K7 lm_trial_kernel
// (below); the window's first cost is one more launch of K7 alone.
//
// No TPU kernel is replaced: the reference runs this glue as jnp code
// that XLA fuses.  In PyTorch it was ~1,300-2,000 launches an iteration
// (linearize's odometry, prior, IRLS and index_put assembly,
// reduce_operands, the back-substitution, apply_update, total_cost, the
// select and the lambda update), each ~1.4 us of device time, for about
// 1 MFLOP of work in all.  Both kernels are latency-bound: at the
// production window (W=8, L=64, 72 plane factors) each holds its whole
// problem (a few KB to ~17 KB) in one block's shared memory, runs a short
// chain of phases separated by barriers, and touches device memory only to
// read its inputs once and write its outputs once.
//
// K6 writes K3a's operands as ops/schur.py::reduce_operands lays them out
// (Hpp, B = Hpl (Hll + lambda I)^-1, G = Hpl, rhs = -(bp - B bl), the
// free-pose mask pm), plus Hll^-1 and bl for K7's back-substitution.  It
// applies the IRLS weights to K5's terms, linearizes the odometry and
// prior factors in closed form, and assembles the normal equations by
// gathering: each entry is summed over its factors in factor-index order,
// in the order linearize's index_put_ calls add them, by one thread, with
// no atomics, so two runs agree bit for bit.
//
// K7 takes K3a's solution x: dxp = x pm, dxl = -Hll^-1 (bl + Hpl^T dxp),
// the step norm and sanitize_step (warp reductions), the SE(3) / S^3
// retraction, every factor's residual at the trial window and its cost
// (a warp reduction), the accept test, the lambda and cost updates, and
// iteration k's SolveStats entries, in place in the caller's buffers; the
// selected window goes to fresh output buffers.  Lambda and the decision
// stay on the device.  With no x it only evaluates the cost of the input
// window (SolveStats' first cost, with the first lambda).
//
// Item kinds run in warp-uniform ranges (each starts on a warp).  The
// window and factors, their wiring, the robust kernels and the pose
// factor are factor_graph.cuh's (shared with K1, fused_gn.cu); the plane
// residual is plane_factor.cuh's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "factor_graph.cuh"
#include "plane_factor.cuh"

namespace {

using namespace popup;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------
// K6: the normal equations and K3a's operands
// ---------------------------------------------------------------------

struct AsmIO {
  const float *r, *Jp, *Jl;  // K5's (F, 3), (F, 3, 6), (F, 3, 3)
  const float* lam;          // 0-d, device
  float *Hpp, *B, *G, *rhs, *pm, *Hll_inv, *bl;
};

// Offsets (in 4-byte words) of K6's shared arrays
struct AsmLayout {
  int obs, Rs, ts, freem, lmv, pfp, pfl, oi, oj, pr, pJp, pJl, orr, oJi, oJj;
  int Winv, bl, bp, lstart, llist, pstart, plist, total;
};

__host__ __device__ inline AsmLayout asm_layout(int W, int L, int F, int O,
                                                int P) {
  const int OP = O + P;
  AsmLayout l;
  int o = 0;
  l.obs = o;    o += 2 * L;  // uint64 per landmark, 8-byte aligned
  l.Rs = o;     o += 9 * W;
  l.ts = o;     o += 3 * W;
  l.freem = o;  o += W;
  l.lmv = o;    o += L;
  l.pfp = o;    o += F;
  l.pfl = o;    o += F;
  l.oi = o;     o += OP;
  l.oj = o;     o += OP;
  l.pr = o;     o += 3 * F;
  l.pJp = o;    o += 18 * F;
  l.pJl = o;    o += 9 * F;
  l.orr = o;    o += 6 * OP;
  l.oJi = o;    o += 36 * OP;
  l.oJj = o;    o += 36 * OP;
  l.Winv = o;   o += 9 * L;
  l.bl = o;     o += 3 * L;
  l.bp = o;     o += 6 * W;
  l.lstart = o; o += L + 1;  // plane factors of each landmark (CSR)
  l.llist = o;  o += F;
  l.pstart = o; o += W + 1;  // plane factors of each pose (CSR)
  l.plist = o;  o += F;
  l.total = o;
  return l;
}

__global__ void __launch_bounds__(kThreads)
    lm_assemble_kernel(Problem q, AsmIO io) {
  extern __shared__ float sm[];
  const int W = q.W, L = q.L, F = q.F, O = q.O, OP = q.O + q.P;
  const int n6 = 6 * W, n3 = 3 * L;
  const AsmLayout ly = asm_layout(W, L, F, O, q.P);
  unsigned long long* obs = (unsigned long long*)(sm + ly.obs);
  float *Rs = sm + ly.Rs, *ts = sm + ly.ts;
  float *freem = sm + ly.freem, *lmv = sm + ly.lmv;
  int *pfp = (int*)(sm + ly.pfp), *pfl = (int*)(sm + ly.pfl);
  int *oi = (int*)(sm + ly.oi), *oj = (int*)(sm + ly.oj);
  float *pr = sm + ly.pr, *pJp = sm + ly.pJp, *pJl = sm + ly.pJl;
  float *orr = sm + ly.orr, *oJi = sm + ly.oJi, *oJj = sm + ly.oJj;
  float *Winv = sm + ly.Winv, *bl = sm + ly.bl, *bp = sm + ly.bp;
  int *lstart = (int*)(sm + ly.lstart), *llist = (int*)(sm + ly.llist);
  int *pstart = (int*)(sm + ly.pstart), *plist = (int*)(sm + ly.plist);
  const int tid = threadIdx.x, nt = blockDim.x;

  // ---- load the poses, the wiring and K5's terms ----
  for (int e = tid; e < 9 * W; e += nt) Rs[e] = q.R[e];
  for (int e = tid; e < 3 * W; e += nt) ts[e] = q.t[e];
  for (int e = tid; e < 3 * F; e += nt) pr[e] = io.r[e];
  for (int e = tid; e < 18 * F; e += nt) pJp[e] = io.Jp[e];
  for (int e = tid; e < 9 * F; e += nt) pJl[e] = io.Jl[e];
  load_wiring(q, pfp, pfl, oi, oj, freem, lmv);
  __syncthreads();
  const float lam = *io.lam;

  // ---- IRLS on the plane terms; the pose factors; the factor lists ----
  const int a1 = round32(F), a2 = a1 + round32(OP), a3 = a2 + round32(L);
  const int a4 = a3 + W;
  for (int e = tid; e < a4; e += nt) {
    if (e < a1) {
      const int f = e;
      if (f >= F) continue;
      float* r = pr + 3 * f;
      float* Jp = pJp + 18 * f;
      float* Jl = pJl + 9 * f;
      float sw = 0.0f;
      if (pfp[f] >= 0) {
        const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
        sw = sqrtf(irls_w(q.k_plane, sq));
      }
      for (int c = 0; c < 3; ++c) r[c] *= sw;
      for (int c = 0; c < 18; ++c) Jp[c] *= sw;
      for (int c = 0; c < 9; ++c) Jl[c] *= sw;
    } else if (e < a2) {
      const int o = e - a1;
      if (o >= OP || oj[o] < 0) continue;
      float* r = orr + 6 * o;
      float* Ji = oJi + 36 * o;
      float* Jj = oJj + 36 * o;
      pose_factor(q, o, oi[o], oj[o], Rs, ts, q.pr_R, q.pr_t, q.pr_A,
                  q.pr_As, true, r, Ji, Jj);
      float sq = 0.0f;
      for (int c = 0; c < 6; ++c) sq += r[c] * r[c];
      const float sw = sqrtf(irls_w(o < O ? q.k_odom : q.k_prior, sq));
      for (int c = 0; c < 6; ++c) r[c] *= sw;
      for (int c = 0; c < 36; ++c) {
        Ji[c] *= sw;
        Jj[c] *= sw;
      }
    } else if (e < a3) {
      // landmark l's plane factors in ascending order, after those of
      // the lower landmarks, and the mask of the poses observing it
      const int l = e - a2;
      if (l >= L) continue;
      int k = 0;
      for (int f = 0; f < F; ++f) k += (pfl[f] >= 0 && pfl[f] < l);
      lstart[l] = k;
      unsigned long long m = 0;
      for (int f = 0; f < F; ++f)
        if (pfl[f] == l) {
          m |= 1ull << pfp[f];
          llist[k++] = f;
        }
      obs[l] = m;
      if (l == L - 1) lstart[L] = k;
    } else {
      const int p = e - a3;
      int k = 0;
      for (int f = 0; f < F; ++f) k += (pfp[f] >= 0 && pfp[f] < p);
      pstart[p] = k;
      for (int f = 0; f < F; ++f)
        if (pfp[f] == p) plist[k++] = f;
      if (p == W - 1) pstart[W] = k;
    }
  }
  __syncthreads();

  // ---- Hpp (every block, one 6-wide row per item), bp and pm, and per
  // landmark Hll, bl and (Hll + lambda I)^-1 (identity where invalid) ----
  // Each entry adds its factors in linearize's order: the odometry's
  // (i, i), (i, j), (j, i), (j, j) terms, the plane factors, the priors.
  const int b1 = round32(6 * W * W), b2 = b1 + round32(n6), b3 = b2 + L;
  for (int e = tid; e < b3; e += nt) {
    if (e < b1) {
      if (e >= 6 * W * W) continue;
      const int blk = e / 6, ra = e - 6 * blk;
      const int p = blk / W, c = blk - W * p;
      float acc[6] = {0, 0, 0, 0, 0, 0};
      for (int side = 0; side < 4; ++side)
        for (int o = 0; o < O; ++o) {
          const int s0 = side < 2 ? oi[o] : oj[o];
          const int s1 = (side & 1) ? oj[o] : oi[o];
          if (s0 != p || s1 != c) continue;
          const float* X = side < 2 ? oJi + 36 * o : oJj + 36 * o;
          const float* Y = (side & 1) ? oJj + 36 * o : oJi + 36 * o;
          for (int b = 0; b < 6; ++b) {
            float s = 0.0f;
            for (int x = 0; x < 6; ++x) s += X[6 * x + ra] * Y[6 * x + b];
            acc[b] += s;
          }
        }
      if (p == c) {
        for (int kf = pstart[p]; kf < pstart[p + 1]; ++kf) {
          const float* Jp = pJp + 18 * plist[kf];
          for (int b = 0; b < 6; ++b)
            acc[b] += Jp[ra] * Jp[b] + Jp[6 + ra] * Jp[6 + b] +
                      Jp[12 + ra] * Jp[12 + b];
        }
        for (int o = O; o < OP; ++o) {
          if (oj[o] != p) continue;
          const float* X = oJj + 36 * o;
          for (int b = 0; b < 6; ++b) {
            float s = 0.0f;
            for (int x = 0; x < 6; ++x) s += X[6 * x + ra] * X[6 * x + b];
            acc[b] += s;
          }
        }
      }
      float* row = io.Hpp + (6 * p + ra) * n6 + 6 * c;
      for (int b = 0; b < 6; ++b) row[b] = acc[b];
    } else if (e < b2) {
      const int k = e - b1;
      if (k >= n6) continue;
      const int p = k / 6, ra = k - 6 * p;
      float acc = 0.0f;
      for (int side = 0; side < 2; ++side)
        for (int o = 0; o < O; ++o) {
          if ((side ? oj[o] : oi[o]) != p) continue;
          const float* J = (side ? oJj : oJi) + 36 * o;
          const float* r = orr + 6 * o;
          float s = 0.0f;
          for (int x = 0; x < 6; ++x) s += J[6 * x + ra] * r[x];
          acc += s;
        }
      for (int kf = pstart[p]; kf < pstart[p + 1]; ++kf) {
        const int f = plist[kf];
        const float* Jp = pJp + 18 * f;
        const float* r = pr + 3 * f;
        acc += Jp[ra] * r[0] + Jp[6 + ra] * r[1] + Jp[12 + ra] * r[2];
      }
      for (int o = O; o < OP; ++o) {
        if (oj[o] != p) continue;
        const float* J = oJj + 36 * o;
        const float* r = orr + 6 * o;
        float s = 0.0f;
        for (int x = 0; x < 6; ++x) s += J[6 * x + ra] * r[x];
        acc += s;
      }
      bp[k] = acc;
      io.pm[k] = freem[p];
    } else {
      const int l = e - b2;
      float H[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
      float g[3] = {0, 0, 0};
      for (int kf = lstart[l]; kf < lstart[l + 1]; ++kf) {
        const int f = llist[kf];
        const float* Jl = pJl + 9 * f;
        const float* r = pr + 3 * f;
        for (int x = 0; x < 3; ++x) {
          for (int y = 0; y < 3; ++y)
            H[3 * x + y] += Jl[x] * Jl[y] + Jl[3 + x] * Jl[3 + y] +
                            Jl[6 + x] * Jl[6 + y];
          g[x] += Jl[x] * r[0] + Jl[3 + x] * r[1] + Jl[6 + x] * r[2];
        }
      }
      for (int x = 0; x < 3; ++x) {
        bl[3 * l + x] = g[x];
        io.bl[3 * l + x] = g[x];
      }
      float Hd[9];
      for (int x = 0; x < 9; ++x)
        Hd[x] = lmv[l] > 0.5f ? H[x] + (x % 4 == 0 ? lam : 0.0f)
                              : (x % 4 == 0 ? 1.0f : 0.0f);
      float* wi = Winv + 9 * l;
      lie::inv3(Hd, wi);
      for (int x = 0; x < 9; ++x) io.Hll_inv[9 * l + x] = wi[x];
    }
  }
  __syncthreads();

  // ---- G = Hpl and B = Hpl Hll^-1, one (pose, landmark) block an item,
  // written whole (zeros where the pose does not observe the landmark) ----
  for (int e = tid; e < W * L; e += nt) {
    const int p = e / L, l = e - L * p;
    float acc[18];
    for (int c = 0; c < 18; ++c) acc[c] = 0.0f;
    if ((obs[l] >> p) & 1ull) {
      for (int kf = lstart[l]; kf < lstart[l + 1]; ++kf) {
        const int f = llist[kf];
        if (pfp[f] != p) continue;
        const float* Jp = pJp + 18 * f;
        const float* Jl = pJl + 9 * f;
        for (int ra = 0; ra < 6; ++ra)
          for (int c = 0; c < 3; ++c)
            acc[3 * ra + c] += Jp[ra] * Jl[c] + Jp[6 + ra] * Jl[3 + c] +
                               Jp[12 + ra] * Jl[6 + c];
      }
    }
    const float* wi = Winv + 9 * l;
    for (int ra = 0; ra < 6; ++ra) {
      const float* h = acc + 3 * ra;
      const int at = (6 * p + ra) * n3 + 3 * l;
      for (int c = 0; c < 3; ++c) {
        io.G[at + c] = h[c];
        io.B[at + c] = h[0] * wi[c] + h[1] * wi[3 + c] + h[2] * wi[6 + c];
      }
    }
  }
  __syncthreads();  // B's rows, written above, are read below

  // ---- rhs = -(bp - B bl): each row over the landmarks its pose
  // observes (the other terms are exact zeros), in column order ----
  for (int row = tid; row < n6; row += nt) {
    const unsigned long long bit = 1ull << (row / 6);
    const float* x = io.B + row * n3;
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      if (!(obs[l] & bit)) continue;
      for (int c = 0; c < 3; ++c) acc += x[3 * l + c] * bl[3 * l + c];
    }
    io.rhs[row] = -(bp[row] - acc);
  }
}

// ---------------------------------------------------------------------
// K7: back-substitution, step, retraction, trial cost, accept/reject
// ---------------------------------------------------------------------

struct TrialIO {
  const float *x, *G, *Hll_inv, *bl;  // x null: the cost of the window only
  float *costs, *lams, *norms;        // SolveStats buffers, (K+1,) (K+1,) (K,)
  uint8_t* accepted;                  // (K,)
  float *R_out, *t_out, *planes_out;
  int k;
  float lam0, lam_up, lam_down;
};

struct TrialLayout {
  int Rs, ts, pls, Rt, tt, plt, freem, lmv, pfp, pfl, oi, oj, dxp, dxl;
  int rf, ro, scal, total;
};

__host__ __device__ inline TrialLayout trial_layout(int W, int L, int F,
                                                    int O, int P) {
  const int OP = O + P;
  TrialLayout l;
  int o = 0;
  l.Rs = o;    o += 9 * W;
  l.ts = o;    o += 3 * W;
  l.pls = o;   o += 4 * L;
  l.Rt = o;    o += 9 * W;
  l.tt = o;    o += 3 * W;
  l.plt = o;   o += 4 * L;
  l.freem = o; o += W;
  l.lmv = o;   o += L;
  l.pfp = o;   o += F;
  l.pfl = o;   o += F;
  l.oi = o;    o += OP;
  l.oj = o;    o += OP;
  l.dxp = o;   o += 6 * W;
  l.dxl = o;   o += 3 * L;
  l.rf = o;    o += F;
  l.ro = o;    o += OP;
  l.scal = o;  o += 8;
  l.total = o;
  return l;
}

__global__ void __launch_bounds__(kThreads)
    lm_trial_kernel(Problem q, TrialIO io) {
  extern __shared__ float sm[];
  const int W = q.W, L = q.L, F = q.F, O = q.O, OP = q.O + q.P;
  const int n6 = 6 * W, n3 = 3 * L;
  const TrialLayout ly = trial_layout(W, L, F, O, q.P);
  float *Rs = sm + ly.Rs, *ts = sm + ly.ts, *pls = sm + ly.pls;
  float *Rt = sm + ly.Rt, *tt = sm + ly.tt, *plt = sm + ly.plt;
  float *freem = sm + ly.freem, *lmv = sm + ly.lmv;
  int *pfp = (int*)(sm + ly.pfp), *pfl = (int*)(sm + ly.pfl);
  int *oi = (int*)(sm + ly.oi), *oj = (int*)(sm + ly.oj);
  float *dxp = sm + ly.dxp, *dxl = sm + ly.dxl;
  float *rf = sm + ly.rf, *ro = sm + ly.ro, *scal = sm + ly.scal;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool step = io.x != nullptr;

  for (int e = tid; e < 9 * W; e += nt) Rs[e] = q.R[e];
  for (int e = tid; e < 3 * W; e += nt) ts[e] = q.t[e];
  for (int e = tid; e < 4 * L; e += nt) pls[e] = q.planes[e];
  load_wiring(q, pfp, pfl, oi, oj, freem, lmv);
  __syncthreads();

  const float *Re = Rs, *te = ts, *ple = pls;  // where the cost is taken
  if (step) {
    // ---- dxp = x pm; dxl = -Hll^-1 (bl + Hpl^T dxp), masked ----
    for (int e = tid; e < n6; e += nt) dxp[e] = io.x[e] * freem[e / 6];
    __syncthreads();
    for (int l = tid; l < L; l += nt) {
      float s[3] = {0.0f, 0.0f, 0.0f};
      for (int row = 0; row < n6; ++row) {
        const float xr = dxp[row];
        const float* g = io.G + row * n3 + 3 * l;
        for (int c = 0; c < 3; ++c) s[c] += g[c] * xr;
      }
      float v[3];
      for (int c = 0; c < 3; ++c) v[c] = io.bl[3 * l + c] + s[c];
      const float* wi = io.Hll_inv + 9 * l;
      for (int c = 0; c < 3; ++c)
        dxl[3 * l + c] =
            -(wi[3 * c] * v[0] + wi[3 * c + 1] * v[1] + wi[3 * c + 2] * v[2]) *
            lmv[l];
    }
    __syncthreads();

    // ---- the step norm (unsanitized) and sanitize_step ----
    if (tid < 32) {
      float sp = 0.0f, sl = 0.0f;
      for (int e = lane; e < n6; e += 32) sp += dxp[e] * dxp[e];
      for (int e = lane; e < n3; e += 32) sl += dxl[e] * dxl[e];
      const float sq = warp_sum(sp) + warp_sum(sl);
      if (lane == 0) {
        io.norms[io.k] = sqrtf(sq);
        scal[0] = (isfinite(sq) && sq < 1e6f) ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
    const bool ok = scal[0] > 0.5f;

    // ---- retract the free poses and the valid planes ----
    for (int e = tid; e < W + L; e += nt) {
      if (e < W) {
        float* R = Rt + 9 * e;
        float* t = tt + 3 * e;
        if (freem[e] > 0.5f) {
          float rh[3], ph[3], Rd[9], td[3];
          for (int k = 0; k < 3; ++k) {
            rh[k] = ok ? dxp[6 * e + k] : 0.0f;
            ph[k] = ok ? dxp[6 * e + 3 + k] : 0.0f;
          }
          lie::se3_exp(rh, ph, Rd, td);
          lie::se3_compose(Rs + 9 * e, ts + 3 * e, Rd, td, R, t);
        } else {
          for (int k = 0; k < 9; ++k) R[k] = Rs[9 * e + k];
          for (int k = 0; k < 3; ++k) t[k] = ts[3 * e + k];
        }
      } else {
        const int l = e - W;
        const float* pi = pls + 4 * l;
        float* pn = plt + 4 * l;
        if (lmv[l] > 0.5f) {
          float B4[12], d[3];
          for (int c = 0; c < 3; ++c) d[c] = ok ? dxl[3 * l + c] : 0.0f;
          lie::tangent_basis4(pi, B4);
          for (int i = 0; i < 4; ++i)
            pn[i] = pi[i] + (B4[3 * i] * d[0] + B4[3 * i + 1] * d[1] +
                             B4[3 * i + 2] * d[2]);
          lie::plane_normalize(pn);
        } else {
          for (int i = 0; i < 4; ++i) pn[i] = pi[i];
        }
      }
    }
    __syncthreads();
    Re = Rt;
    te = tt;
    ple = plt;
  }

  // ---- every factor's rho at the evaluated window (0 where invalid) ----
  const int c1 = round32(F);
  for (int e = tid; e < c1 + OP; e += nt) {
    if (e < c1) {
      const int f = e;
      if (f >= F) continue;
      float sq = 0.0f;
      if (pfp[f] >= 0) {
        float r[3];
        plane_residual(Re + 9 * pfp[f], te + 3 * pfp[f], ple + 4 * pfl[f],
                       q.pf_pi + 4 * f, q.pf_A + q.pf_As * f, r);
        sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      }
      rf[f] = rho(q.k_plane, sq);
    } else {
      const int o = e - c1;
      float sq = 0.0f;
      if (oj[o] >= 0) {
        float r[6];
        pose_factor(q, o, oi[o], oj[o], Re, te, q.pr_R, q.pr_t, q.pr_A,
                    q.pr_As, false, r, nullptr, nullptr);
        for (int c = 0; c < 6; ++c) sq += r[c] * r[c];
      }
      ro[o] = rho(o < O ? q.k_odom : q.k_prior, sq);
    }
  }
  __syncthreads();

  // ---- the cost, the decision, lambda, SolveStats (one warp) ----
  if (tid < 32) {
    float so = 0.0f, sf = 0.0f, sp = 0.0f;
    for (int o = lane; o < O; o += 32) so += ro[o];
    for (int f = lane; f < F; f += 32) sf += rf[f];
    for (int o = O + lane; o < OP; o += 32) sp += ro[o];
    const float c = 0.5f * ((warp_sum(so) + warp_sum(sf)) + warp_sum(sp));
    if (lane == 0) {
      if (!step) {
        io.costs[0] = c;
        io.lams[0] = io.lam0;
      } else {
        const int k = io.k;
        const float cost = io.costs[k], lam = io.lams[k];
        const bool accept = c < cost;
        const float lam_n = accept ? lam * io.lam_down : lam * io.lam_up;
        io.costs[k + 1] = accept ? c : cost;
        io.lams[k + 1] = fminf(fmaxf(lam_n, 1e-9f), 1e6f);
        io.accepted[k] = accept ? 1 : 0;
        scal[1] = accept ? 1.0f : 0.0f;
      }
    }
  }
  if (!step) return;
  __syncthreads();

  // ---- the selected window, to fresh buffers ----
  const bool accept = scal[1] > 0.5f;
  const float *Rsel = accept ? Rt : Rs, *tsel = accept ? tt : ts;
  const float* psel = accept ? plt : pls;
  for (int e = tid; e < 9 * W; e += nt) io.R_out[e] = Rsel[e];
  for (int e = tid; e < 3 * W; e += nt) io.t_out[e] = tsel[e];
  for (int e = tid; e < 4 * L; e += nt) io.planes_out[e] = psel[e];
}

}  // namespace

// Shared memory of K6 (which 0) or K7 (which 1) at these sizes (bytes)
extern "C" int popup_lm_smem_bytes(int W, int L, int F, int O, int P,
                                   int which) {
  const int words = which == 0 ? asm_layout(W, L, F, O, P).total
                               : trial_layout(W, L, F, O, P).total;
  return (int)sizeof(float) * words;
}

// p: the shared slots (make_problem), then r, Jp, Jl, lam, Hpp, B, G,
// rhs, pm, Hll_inv, bl; n and x: the shared ints and floats.
extern "C" int popup_lm_assemble(void* const* p, const int* n, const float* x,
                                 void* stream) {
  const Problem q = make_problem(p, n, x);
  void* const* o = p + kOwn;
  AsmIO io;
  io.r = (const float*)o[0];
  io.Jp = (const float*)o[1];
  io.Jl = (const float*)o[2];
  io.lam = (const float*)o[3];
  io.Hpp = (float*)o[4];
  io.B = (float*)o[5];
  io.G = (float*)o[6];
  io.rhs = (float*)o[7];
  io.pm = (float*)o[8];
  io.Hll_inv = (float*)o[9];
  io.bl = (float*)o[10];
  return launch_block(lm_assemble_kernel, kThreads,
                      popup_lm_smem_bytes(q.W, q.L, q.F, q.O, q.P, 0), stream,
                      q, io);
}

// p: the shared slots, then x (null: the cost only), G, Hll_inv, bl,
// costs, lams, norms, accepted, R_out, t_out, planes_out; n: the shared
// ints, then k; x: the shared floats, then lam0, lam_up, lam_down.
extern "C" int popup_lm_trial(void* const* p, const int* n, const float* x,
                              void* stream) {
  const Problem q = make_problem(p, n, x);
  void* const* o = p + kOwn;
  TrialIO io;
  io.x = (const float*)o[0];
  io.G = (const float*)o[1];
  io.Hll_inv = (const float*)o[2];
  io.bl = (const float*)o[3];
  io.costs = (float*)o[4];
  io.lams = (float*)o[5];
  io.norms = (float*)o[6];
  io.accepted = (uint8_t*)o[7];
  io.R_out = (float*)o[8];
  io.t_out = (float*)o[9];
  io.planes_out = (float*)o[10];
  io.k = n[kOwnInt];
  io.lam0 = x[kOwnFloat];
  io.lam_up = x[kOwnFloat + 1];
  io.lam_down = x[kOwnFloat + 2];
  return launch_block(lm_trial_kernel, kThreads,
                      popup_lm_smem_bytes(q.W, q.L, q.F, q.O, q.P, 1), stream,
                      q, io);
}
