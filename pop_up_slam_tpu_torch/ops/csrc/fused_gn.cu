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
//
// Hopper design (512 threads; the phase split that chose it is in
// PERF.md): per-landmark and per-pose lists of the plane factors, built
// once from the wiring, so each gathered entry scans only its own
// factors; item kinds in warp-uniform ranges; only the upper blocks of
// Hpp and S are formed (the Cholesky reads only the upper triangle); S
// sums each pose pair over the landmarks both poses observe (64-bit
// observer masks; the skipped terms are exact zeros, so the sum equals the
// dense ordered one); Hpl and B rows have an odd stride, so lanes reading
// different rows hit different banks; the marginal runs on a warp and the
// step norm and cost are warp reductions; the reduced solve is the
// panel-blocked chol.cuh routine.  Optional %globaltimer stamps at the
// phase boundaries (Args::stamps) feed the profile script.  The window and
// factors, their wiring, the robust kernels and the pose factor are
// factor_graph.cuh's (shared with K6 and K7, lm_step.cu); the plane
// factor is plane_factor.cuh's; the marginal is marginal.cuh's (shared
// with K8, marginal.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chol.cuh"
#include "factor_graph.cuh"
#include "marginal.cuh"
#include "plane_factor.cuh"

namespace {

using namespace popup;

constexpr int kThreads = 512;  // measured against 256 (PERF.md)

// Offsets (in 4-byte words) of the shared-memory arrays.
struct Layout {
  int obs, Rs, ts, pls, prR, prt, prA, freem, lmv, pfp, pfl, oi, oj;
  int pr, pJp, pJl, prho, orr, oJi, oJj, orho;
  int Hpp, Hpl, B, Winv, bp, bl, rhs, dxp, dxl, pairs, lstart, llist;
  int pstart, plist, margs, chol, scal, total;
  int ldh;  // row stride of Hpl and B: 3L rounded up to odd (distinct banks)
};

struct Dims {
  int W, L, F, O, P;
};

__host__ __device__ inline Layout make_layout(Dims d) {
  const int n6 = 6 * d.W, n3 = 3 * d.L, OP = d.O + d.P;
  Layout l;
  l.ldh = n3 | 1;
  int o = 0;
  l.obs = o;   o += 2 * d.L;   // uint64 per landmark, 8-byte aligned
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
  l.Hpl = o;   o += n6 * l.ldh;
  l.B = o;     o += n6 * l.ldh;
  l.Winv = o;  o += 9 * d.L;
  l.bp = o;    o += n6;
  l.bl = o;    o += n3;
  l.rhs = o;   o += n6;
  l.dxp = o;   o += n6;
  l.dxl = o;   o += n3;
  l.pairs = o; o += d.W * (d.W + 1) / 2;
  l.lstart = o; o += d.L + 1;  // plane factors of each landmark (CSR)
  l.llist = o; o += d.F;
  l.pstart = o; o += d.W + 1;  // plane factors of each pose (CSR)
  l.plist = o; o += d.F;
  l.margs = o; o += kMargScratch;
  l.chol = o;  o += popup::kPanel;
  l.scal = o;  o += 8;
  l.total = o;
  return l;
}

struct Args {
  Problem q;
  const float* marg;  // (8, 16) or null
  float lam;
  int iters;
  int fuse_marg;
  float adiag[6];
  float eps_m, floor_m;
  float *R_out, *t_out, *planes_out, *costs_out, *msqrt_out;
  unsigned long long* stamps;  // phase stamps (profiling) or null
};

// Thread 0 writes %globaltimer (ns) into slot i of the optional stamp
// buffer, right after the barrier that ends a phase.  Slots: 0 start,
// 1 load, 2 marginal, then per iteration it, 3 + 8 it + (0 linearize,
// 1 gather, 2 B, 3 S, 4 Cholesky, 5 back-substitution, 6 sanitize,
// 7 retract).
__device__ inline void stamp(const Args& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[i] = t;
  }
}

// ---------------------------------------------------------------------
// per-factor linearization (one thread per factor)
// ---------------------------------------------------------------------

// plane factor f (pose p, landmark l; p < 0: unwired, zero) with its IRLS
// weight folded in
__device__ void plane_factor(const Problem& q, int f, int p, int l,
                             const float* Rs, const float* ts,
                             const float* pls, float* r_out, float* Jp_out,
                             float* Jl_out, float* rho_out) {
  if (p < 0) {
    for (int e = 0; e < 3; ++e) r_out[e] = 0.0f;
    for (int e = 0; e < 18; ++e) Jp_out[e] = 0.0f;
    for (int e = 0; e < 9; ++e) Jl_out[e] = 0.0f;
    *rho_out = rho(q.k_plane, 0.0f);
    return;
  }
  plane_terms_one(Rs + 9 * p, ts + 3 * p, pls + 4 * l, q.pf_pi + 4 * f,
                  q.pf_A + q.pf_As * f, r_out, Jp_out, Jl_out);
  const float sq = lie::dot3(r_out, r_out);
  *rho_out = rho(q.k_plane, sq);
  const float sw = sqrtf(irls_w(q.k_plane, sq));
  for (int e = 0; e < 3; ++e) r_out[e] *= sw;
  for (int e = 0; e < 18; ++e) Jp_out[e] *= sw;
  for (int e = 0; e < 9; ++e) Jl_out[e] *= sw;
}

// odometry (o < O) or prior (o >= O) factor o (j < 0: unwired, zero)
// with its IRLS weight folded in, the priors read from shared memory
// (prR, prt, prA), where the marginal may have replaced them; a prior
// leaves Ji_out unwritten.  The linearization runs in registers and each
// output is stored once: one thread carries a pose factor, on the phase's
// critical path.
__device__ void weighted_pose_factor(const Problem& q, int o, int i, int j,
                                     const float* Rs, const float* ts,
                                     const float* prR, const float* prt,
                                     const float* prA, float* r_out,
                                     float* Ji_out, float* Jj_out,
                                     float* rho_out) {
  const Robust k = o < q.O ? q.k_odom : q.k_prior;
  if (j < 0) {
    for (int e = 0; e < 6; ++e) r_out[e] = 0.0f;
    for (int e = 0; e < 36; ++e) { Ji_out[e] = 0.0f; Jj_out[e] = 0.0f; }
    *rho_out = rho(k, 0.0f);
    return;
  }
  float r[6], Ji[36], Jj[36];
  pose_factor(q, o, i, j, Rs, ts, prR, prt, prA, 36, true, r, Ji, Jj);
  float sq = 0.0f;
  for (int e = 0; e < 6; ++e) sq += r[e] * r[e];
  *rho_out = rho(k, sq);
  const float sw = sqrtf(irls_w(k, sq));
  for (int e = 0; e < 6; ++e) r_out[e] = r[e] * sw;
  for (int e = 0; e < 36; ++e) Jj_out[e] = Jj[e] * sw;
  if (o < q.O)
    for (int e = 0; e < 36; ++e) Ji_out[e] = Ji[e] * sw;
}

// the exiting keyframe's marginal from the MARG block, by warp 0
// (marginal.cuh, shared with K8); overrides the prior factor when the
// window is full.  sc: kMargScratch floats.
__device__ void k1_marginal(const Args& a, float* prR, float* prt,
                            float* prA, float* sc) {
  const int lane = threadIdx.x & 31;
  const float* M = a.marg;
  const float *R1 = M + 16, *t1 = M + 25;
  const float ov0 = M[48], full = M[49];
  const float *prRo = M + 64, *prto = M + 73, *prAo = M + 80;
  const MargIn in{M, M + 9, R1, t1, M + 32, M + 41, prRo, prto, prAo};
  marginal_warp(in, ov0 > 0.5f, a.adiag, a.eps_m, a.floor_m, sc,
                [&](int e, float s) {
                  a.msqrt_out[e] = s;
                  prA[e] = full * s + (1.0f - full) * prAo[e];
                });
  if (lane < 9) prR[lane] = full * R1[lane] + (1.0f - full) * prRo[lane];
  if (lane < 3) prt[lane] = full * t1[lane] + (1.0f - full) * prto[lane];
}

__global__ void __launch_bounds__(kThreads) fused_gn_kernel(Args a) {
  extern __shared__ float sm[];
  const int W = a.q.W, L = a.q.L, F = a.q.F, O = a.q.O, P = a.q.P;
  const int OP = O + P, n6 = 6 * W, n3 = 3 * L;
  const Layout ly = make_layout(Dims{W, L, F, O, P});
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
  float *chol = sm + ly.chol, *scal = sm + ly.scal;
  unsigned long long* obs = (unsigned long long*)(sm + ly.obs);
  int* pairs = (int*)(sm + ly.pairs);
  int *lstart = (int*)(sm + ly.lstart), *llist = (int*)(sm + ly.llist);
  int *pstart = (int*)(sm + ly.pstart), *plist = (int*)(sm + ly.plist);
  const int ldh = ly.ldh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;

  stamp(a, 0);

  // ---- load the state, the prior and the static factor wiring ----
  for (int e = tid; e < 9 * W; e += nt) Rs[e] = a.q.R[e];
  for (int e = tid; e < 3 * W; e += nt) ts[e] = a.q.t[e];
  for (int e = tid; e < 4 * L; e += nt) pls[e] = a.q.planes[e];
  for (int e = tid; e < 9 * P; e += nt) prR[e] = a.q.pr_R[e];
  for (int e = tid; e < 3 * P; e += nt) prt[e] = a.q.pr_t[e];
  for (int e = tid; e < 36 * P; e += nt)
    prA[e] = a.q.pr_A[a.q.pr_As * (e / 36) + e % 36];
  load_wiring(a.q, pfp, pfl, oi, oj, freem, lmv);
  __syncthreads();
  stamp(a, 1);
  // warp 0: the marginal; the other warps: each landmark's mask of the
  // poses observing it and the table of upper pose pairs (p <= q), both
  // fixed by the wiring for every iteration
  const int nPair = W * (W + 1) / 2;
  if (tid < 32) {
    if (a.fuse_marg) k1_marginal(a, prR, prt, prA, sm + ly.margs);
  } else {
    // per landmark (and per pose) its plane factors in ascending order,
    // as a list after those of the lower indices: what the gather scans
    for (int l = tid - 32; l < L; l += nt - 32) {
      unsigned long long m = 0;
      int start = 0;
      for (int f = 0; f < F; ++f) start += (pfl[f] >= 0 && pfl[f] < l);
      int k = start;
      for (int f = 0; f < F; ++f)
        if (pfl[f] == l) {
          m |= 1ull << pfp[f];
          llist[k++] = f;
        }
      obs[l] = m;
      lstart[l] = start;
      if (l == L - 1) lstart[L] = k;
    }
    for (int p = tid - 32; p < W; p += nt - 32) {
      int k = 0;
      for (int f = 0; f < F; ++f) k += (pfp[f] >= 0 && pfp[f] < p);
      pstart[p] = k;
      for (int f = 0; f < F; ++f)
        if (pfp[f] == p) plist[k++] = f;
      if (p == W - 1) pstart[W] = k;
    }
    for (int p = tid - 32; p < W; p += nt - 32) {
      const int base = p * W - p * (p - 1) / 2;  // pairs of rows < p
      for (int q = p; q < W; ++q) pairs[base + q - p] = p | (q << 16);
    }
  }
  __syncthreads();
  stamp(a, 2);

  const int pbase = round32(F);  // pose factors start on a warp
  const int nHpl = W * L;
  for (int it = 0; it < a.iters; ++it) {
    // ---- linearize every factor ----
    for (int e = tid; e < pbase + OP; e += nt) {
      if (e < F) {
        plane_factor(a.q, e, pfp[e], pfl[e], Rs, ts, pls, pr + 3 * e,
                     pJp + 18 * e, pJl + 9 * e, prho + e);
      } else if (e >= pbase) {
        const int o = e - pbase;
        weighted_pose_factor(a.q, o, oi[o], oj[o], Rs, ts, prR, prt, prA,
                             orr + 6 * o, oJi + 36 * o, oJj + 36 * o,
                             orho + o);
      }
    }
    __syncthreads();
    stamp(a, 3 + 8 * it + 0);

    // ---- normal equations by gathering (no atomics), Hll^-1, cost ----
    // Item kinds in warp-uniform ranges (each starts on a warp): the
    // 6-wide rows of the upper Hpp blocks (8 items per pair, 6 used), the
    // (p, l) blocks of Hpl, bp, the landmarks, and one warp for the cost.
    // Only the upper blocks of Hpp are formed: the Cholesky reads only
    // the upper triangle.
    const int r1 = round32(8 * nPair), r2 = r1 + round32(nHpl);
    const int r3 = r2 + round32(n6), r4 = r3 + round32(L), r5 = r4 + 32;
    for (int e = tid; e < r5; e += nt) {
      if (e < r1) {  // one 6-wide row of block (p, q), p <= q
        const int k = e >> 3, ra = e & 7;
        if (k >= nPair || ra >= 6) continue;
        const int p = pairs[k] & 0xffff, q = pairs[k] >> 16;
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
          for (int kf = pstart[p]; kf < pstart[p + 1]; ++kf) {
            const float* Jp = pJp + 18 * plist[kf];
            for (int b = 0; b < 6; ++b)
              acc[b] += Jp[ra] * Jp[b] + Jp[6 + ra] * Jp[6 + b] +
                        Jp[12 + ra] * Jp[12 + b];
          }
        }
        for (int b = 0; b < 6; ++b) Hpp[(6 * p + ra) * n6 + 6 * q + b] = acc[b];
      } else if (e < r2) {  // block (p, l) of Hpl
        const int k = e - r1;
        if (k >= nHpl) continue;
        const int p = k / L, l = k - p * L;
        float acc[18];
        for (int c = 0; c < 18; ++c) acc[c] = 0.0f;
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
        for (int ra = 0; ra < 6; ++ra)
          for (int c = 0; c < 3; ++c)
            Hpl[(6 * p + ra) * ldh + 3 * l + c] = acc[3 * ra + c];
      } else if (e < r3) {  // bp entry
        const int k = e - r2;
        if (k >= n6) continue;
        const int p = k / 6, ra = k - 6 * p;
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
        for (int kf = pstart[p]; kf < pstart[p + 1]; ++kf) {
          const int f = plist[kf];
          const float* Jp = pJp + 18 * f;
          const float* r = pr + 3 * f;
          acc += Jp[ra] * r[0] + Jp[6 + ra] * r[1] + Jp[12 + ra] * r[2];
        }
        bp[k] = acc;
      } else if (e < r4) {  // landmark: Hll, bl, Hll^-1
        const int l = e - r3;
        if (l >= L) continue;
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
        for (int x = 0; x < 3; ++x) bl[3 * l + x] = g[x];
        float Hd[9];
        for (int x = 0; x < 9; ++x)
          Hd[x] = lmv[l] > 0.5f ? H[x] + (x % 4 == 0 ? a.lam : 0.0f)
                                : (x % 4 == 0 ? 1.0f : 0.0f);
        lie::inv3(Hd, Winv + 9 * l);
      } else {  // robustified cost at this linearization point (one warp)
        float c = 0.0f;
        for (int f = lane; f < F; f += 32) c += prho[f];
        for (int o = lane; o < OP; o += 32) c += orho[o];
        c = warp_sum(c);
        if (lane == 0) scal[1] = 0.5f * c;
      }
    }
    __syncthreads();
    stamp(a, 3 + 8 * it + 1);

    // ---- B = Hpl Hll^-1 ----
    for (int e = tid; e < n6 * L; e += nt) {
      const int ra = e / L, l = e % L;
      const float* h = Hpl + ra * ldh + 3 * l;
      const float* wi = Winv + 9 * l;
      for (int c = 0; c < 3; ++c)
        Bm[ra * ldh + 3 * l + c] = h[0] * wi[c] + h[1] * wi[3 + c] + h[2] * wi[6 + c];
    }
    __syncthreads();
    stamp(a, 3 + 8 * it + 2);

    // ---- reduced system S = Hpp - B Hpl^T (damped, gauge-masked), rhs ----
    // Upper blocks (p <= q) only, one 6-wide row per item.  Entry (i, j)
    // sums over the landmarks observed by both poses, in landmark order:
    // every skipped term is an exact zero (Hpl and B vanish for a pose
    // that does not observe the landmark), so the sum equals the dense
    // ordered one.  Rows of Hpl and B have an odd stride: lanes reading
    // different rows hit different banks.
    const int s1 = round32(8 * nPair), s2 = s1 + round32(n6);
    for (int e = tid; e < s2; e += nt) {
      if (e < s1) {
        const int k = e >> 3, ra = e & 7;
        if (k >= nPair || ra >= 6) continue;
        const int p = pairs[k] & 0xffff, q = pairs[k] >> 16;
        const unsigned long long both = (1ull << p) | (1ull << q);
        const float* x = Bm + (6 * p + ra) * ldh;
        const float* y = Hpl + 6 * q * ldh;
        float acc[6] = {0, 0, 0, 0, 0, 0};
        for (int l = 0; l < L; ++l) {
          if ((obs[l] & both) != both) continue;
          for (int c = 0; c < 3; ++c) {
            const float xv = x[3 * l + c];
#pragma unroll
            for (int cb = 0; cb < 6; ++cb)
              acc[cb] = fmaf(xv, y[cb * ldh + 3 * l + c], acc[cb]);
          }
        }
        const int row = 6 * p + ra;
        const float pa = freem[p], pb = freem[q];
        for (int cb = 0; cb < 6; ++cb) {
          const int col = 6 * q + cb;
          float v = (Hpp[row * n6 + col] - acc[cb] + (row == col ? a.lam : 0.0f)) * pa * pb;
          if (row == col) v += 1.0f - pa;
          Hpp[row * n6 + col] = v;
        }
      } else {
        const int ra = e - s1;
        if (ra >= n6) continue;
        const unsigned long long bit = 1ull << (ra / 6);
        const float* x = Bm + ra * ldh;
        float acc = 0.0f;
        for (int l = 0; l < L; ++l) {
          if (!(obs[l] & bit)) continue;
          for (int c = 0; c < 3; ++c) acc = fmaf(bl[3 * l + c], x[3 * l + c], acc);
        }
        rhs[ra] = -(bp[ra] - acc) * freem[ra / 6];
      }
    }
    __syncthreads();
    stamp(a, 3 + 8 * it + 3);

    popup::chol_solve_shared(Hpp, n6, rhs, n6, chol);
    stamp(a, 3 + 8 * it + 4);

    // ---- pose step; landmark back-substitution ----
    for (int e = tid; e < n6 + L; e += nt) {
      if (e < n6) {
        dxp[e] = rhs[e] * freem[e / 6];
      } else {
        // rows of poses that do not observe l add exact zeros: skipped
        const int l = e - n6;
        const unsigned long long m = obs[l];
        float s[3] = {0.0f, 0.0f, 0.0f};
        for (int p = 0; p < W; ++p) {
          if (!((m >> p) & 1ull)) continue;
          for (int ra = 6 * p; ra < 6 * p + 6; ++ra) {
            const float xr = rhs[ra] * freem[p];
            for (int c = 0; c < 3; ++c)
              s[c] += xr * Hpl[ra * ldh + 3 * l + c];
          }
        }
        float v[3];
        for (int c = 0; c < 3; ++c) v[c] = bl[3 * l + c] + s[c];
        const float* wi = Winv + 9 * l;
        for (int c = 0; c < 3; ++c)
          dxl[3 * l + c] =
              -(wi[3 * c] * v[0] + wi[3 * c + 1] * v[1] + wi[3 * c + 2] * v[2]) *
              lmv[l];
      }
    }
    __syncthreads();
    stamp(a, 3 + 8 * it + 5);

    // ---- sanitize_step: zero a non-finite or divergent step ----
    if (tid < 32) {
      float sq = 0.0f;
      for (int e = lane; e < n6; e += 32) sq += dxp[e] * dxp[e];
      for (int e = lane; e < n3; e += 32) sq += dxl[e] * dxl[e];
      sq = warp_sum(sq);
      if (lane == 0) {
        scal[2] = (isfinite(sq) && sq < 1e6f) ? 1.0f : 0.0f;
        a.costs_out[it] = scal[1];
      }
    }
    __syncthreads();
    stamp(a, 3 + 8 * it + 6);
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
    stamp(a, 3 + 8 * it + 7);
  }

  for (int e = tid; e < 9 * W; e += nt) a.R_out[e] = Rs[e];
  for (int e = tid; e < 3 * W; e += nt) a.t_out[e] = ts[e];
  for (int e = tid; e < 4 * L; e += nt) a.planes_out[e] = pls[e];
}

}  // namespace

extern "C" int popup_fused_gn_smem_bytes(int W, int L, int F, int O, int P) {
  return (int)sizeof(float) * make_layout(Dims{W, L, F, O, P}).total;
}

// p: the shared slots (make_problem), then the MARG block (null: no
// marginal), R_out, t_out, planes_out, costs_out, msqrt_out and the phase
// stamps (null: none); n: the shared ints, then iters; x: the shared
// floats, then the damping and the marginal's static constants (the
// odometry sqrt-info diagonal (6), the H00 regularizer, the floor).
extern "C" int popup_fused_gn(void* const* p, const int* n, const float* x,
                              void* stream) {
  Args a;
  a.q = make_problem(p, n, x);
  void* const* o = p + kOwn;
  a.marg = (const float*)o[0];
  a.R_out = (float*)o[1];
  a.t_out = (float*)o[2];
  a.planes_out = (float*)o[3];
  a.costs_out = (float*)o[4];
  a.msqrt_out = (float*)o[5];
  a.stamps = (unsigned long long*)o[6];
  a.iters = n[kOwnInt];
  a.fuse_marg = a.marg != nullptr;
  const float* c = x + kOwnFloat;
  a.lam = c[0];
  for (int k = 0; k < 6; ++k) a.adiag[k] = c[1 + k];
  a.eps_m = c[7];
  a.floor_m = c[8];
  // the wrapper's shape gate (fused_gn_supported) keeps smem within the
  // block limit
  const Problem& q = a.q;
  return launch_block(fused_gn_kernel, kThreads,
                      popup_fused_gn_smem_bytes(q.W, q.L, q.F, q.O, q.P),
                      stream, a);
}
