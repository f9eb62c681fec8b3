"""Plane-based visual odometry: ego-motion from frame-to-frame plane
alignment.

Port of ``pop_up_slam_tpu/odometry/plane_vo.py``.  The popped-up
camera-frame planes of two consecutive frames are matched (gated,
mutual nearest neighbour) and aligned in closed form: with the relative
pose (R, t) mapping current-frame points into the previous frame
(x_a = R x_b + t), a plane observed in both frames obeys n_a = R n_b and
d_a = d_b - n_a . t.  Rotation is a Wahba problem over matched normals,
translation a 3x3 linear least squares over the distance offsets; both
are damped toward a motion prior, which fills the subspace that a
degenerate plane set (a corridor, the ground alone) leaves unobserved.

Everything is fixed-shape and branch-free, and nothing reads a value
back to the host: the Wahba rotation is taken by Davenport's q-method
(the top eigenvector of a 4x4 symmetric matrix, by repeated squaring)
instead of an SVD, and the translation by a closed-form 3x3 solve,
because ``torch.linalg.svd`` and ``torch.linalg.solve`` check their
results on the host.  Both are the reference's values to f32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import plane as plane_mod
from ..geometry import se3

# squarings of the shifted Davenport matrix: its top eigenvector is
# resolved once (lambda_2 / lambda_1) ** (2 ** n) is below f32 rounding,
# down to a relative gap of ~1e-6
_WAHBA_SQUARINGS = 24


class PlaneVOConfig(NamedTuple):
    max_angle: float = 0.35      # rad — normal-angle gate for matching
    max_dist: float = 1.2        # m — |d_a - d_b| gate on the first pass
    refine_dist: float = 0.3     # m — gate on refine passes (post-align)
    iters: int = 2               # match/align passes (ICP-style)
    lam_rot: float = 0.05        # prior damping weight, rotation (Wahba)
    lam_trans: float = 0.05      # prior damping weight, translation
    min_matches: int = 1         # below this, fall back to the prior


class PlaneVOResult(NamedTuple):
    R: torch.Tensor              # (3, 3) relative rotation (a<-b)
    t: torch.Tensor              # (3,)   relative translation
    n_matches: torch.Tensor      # ()     int32 matched plane pairs
    used_prior: torch.Tensor     # ()     bool — too few matches, prior kept


def match_planes(planes_a: torch.Tensor, valid_a: torch.Tensor,
                 planes_b: torch.Tensor, valid_b: torch.Tensor,
                 prior_R: torch.Tensor, prior_t: torch.Tensor,
                 cfg: PlaneVOConfig = PlaneVOConfig()):
    """Gate + mutual-nearest matching of two camera-frame plane sets
    (D, 4), frame b warped into frame a through the prior.  Returns
    (match_idx (D,) int32: the matched b-slot of each a-slot or -1,
    weight (D,) f32 in {0, 1}).  Ties go to the first index, as
    ``jnp.argmin``'s do."""
    pb_in_a = plane_mod.transform_to_world(planes_b, prior_R, prior_t)
    ang = plane_mod.normal_angle(planes_a[:, None, :], pb_in_a[None, :, :])
    na, da = plane_mod.to_hessian_normal(planes_a)
    nb, db = plane_mod.to_hessian_normal(pb_in_a)
    s = torch.where(na @ nb.T >= 0.0, 1.0, -1.0)
    dd = torch.abs(da[:, None] - s * db[None, :])
    ok = ((ang < cfg.max_angle) & (dd < cfg.max_dist) & valid_a[:, None]
          & valid_b[None, :])
    big = 1e9
    score = torch.where(ok, ang + dd, torch.full_like(ang, big))

    best_b = torch.argmin(score, dim=1)                    # (D,) per a
    best_a = torch.argmin(score, dim=0)                    # (D,) per b
    idx = torch.arange(score.shape[0], device=score.device)
    mutual = best_a[best_b] == idx
    has = torch.gather(score, 1, best_b[:, None])[:, 0] < big
    match = torch.where(mutual & has, best_b, -1).to(torch.int32)
    return match, (match >= 0).to(planes_a.dtype)


def _wahba(B: torch.Tensor) -> torch.Tensor:
    """The rotation R maximizing tr(R^T B), which is U diag(1, 1,
    det(U V^T)) V^T of the SVD B = U S V^T: Davenport's q-method.  The
    optimal quaternion (w, x, y, z) is the top eigenvector of
    N = [[tr B, z^T], [z, B + B^T - tr(B) I]], z = vee(B - B^T); it is
    read off (N + ||N||_F I)^(2^k), which is positive semi-definite,
    normalized by its trace after each squaring."""
    tr = torch.diagonal(B).sum()
    z = se3.vee(B - B.T)
    eye3 = torch.eye(3, dtype=B.dtype, device=B.device)
    N = torch.cat([torch.cat([tr[None], z])[None],
                   torch.cat([z[:, None], B + B.T - tr * eye3], dim=1)])
    M = N + torch.linalg.norm(N) * torch.eye(4, dtype=B.dtype,
                                             device=B.device)
    for _ in range(_WAHBA_SQUARINGS):
        M = M @ M
        M = M / torch.clamp(torch.diagonal(M).sum(), min=1e-30)
    j = torch.argmax(torch.diagonal(M))
    q = torch.index_select(M, 1, j[None])[:, 0]
    q = q / torch.clamp(torch.linalg.norm(q), min=1e-30)
    return se3.quat_to_rotmat(q)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for one 3x3 system by its adjugate: rows of the cofactor
    matrix are cross products of A's rows."""
    cof = torch.linalg.cross(torch.roll(A, -1, 0), torch.roll(A, -2, 0))
    det = torch.sum(A[0] * cof[0])
    return torch.sum(cof * b[:, None], dim=0) / det


def align_planes(planes_a: torch.Tensor, planes_b: torch.Tensor,
                 weight: torch.Tensor, prior_R: torch.Tensor,
                 prior_t: torch.Tensor, lam_rot: float = 0.05,
                 lam_trans: float = 0.05):
    """Closed-form weighted plane-to-plane SE(3) alignment with a prior.

    planes_a/b: (M, 4) matched camera-frame planes (row i of a matches
    row i of b); weight (M,) >= 0.  Returns (R, t) with x_a = R x_b + t:
    R maximizes sum_i w_i n_a_i . R n_b_i + lam_rot tr(R^T prior_R), t
    solves (A^T W A + lam I) t = A^T W r + lam t_prior with A = n_a,
    r = d_b - d_a."""
    na, da = plane_mod.to_hessian_normal(planes_a)
    nb, db = plane_mod.to_hessian_normal(planes_b)
    # antipodal sign alignment per pair (after the prior rotation warp)
    nb_w = (prior_R @ nb[..., None])[..., 0]
    s = torch.where(torch.sum(na * nb_w, dim=-1) >= 0.0, 1.0, -1.0)
    nb = s[:, None] * nb
    db = s * db

    w = weight[:, None]
    B = torch.einsum("mi,mj->ij", na * w, nb) + lam_rot * prior_R
    R = _wahba(B)

    r = db - da
    AtA = torch.einsum("mi,mj->ij", na * w, na) + lam_trans * torch.eye(
        3, dtype=na.dtype, device=na.device)
    Atb = torch.einsum("mi,m->i", na * w, r)
    return R, _solve3(AtA, Atb + lam_trans * prior_t)


def plane_vo_step(planes_prev: torch.Tensor, valid_prev: torch.Tensor,
                  planes_cur: torch.Tensor, valid_cur: torch.Tensor,
                  prior_R: torch.Tensor, prior_t: torch.Tensor,
                  cfg: PlaneVOConfig = PlaneVOConfig(),
                  support_prev: torch.Tensor | None = None,
                  support_cur: torch.Tensor | None = None) -> PlaneVOResult:
    """One VO step: match the previous frame's planes against the
    current frame's (each in its own camera frame) and align, iterated
    ICP-style: the first pass gates the distance innovation at
    ``cfg.max_dist``, refine passes re-warp through the estimate and
    gate at ``cfg.refine_dist``; damping always pulls toward the
    original prior.  With ``support_prev``/``support_cur`` each match is
    weighted by the smaller of its planes' supports, normalized to mean
    1 over the matched set.  Falls back to the prior when fewer than
    ``cfg.min_matches`` pairs survive."""
    R_est, t_est = prior_R, prior_t
    n = torch.zeros((), dtype=torch.int32, device=planes_prev.device)
    for k in range(max(cfg.iters, 1)):
        gate = cfg.max_dist if k == 0 else cfg.refine_dist
        match, _ = match_planes(planes_prev, valid_prev, planes_cur,
                                valid_cur, R_est, t_est,
                                cfg._replace(max_dist=gate))
        matched = match >= 0
        idx = torch.clamp(match, 0, planes_cur.shape[0] - 1).long()
        pb = planes_cur[idx]
        w = matched.to(planes_prev.dtype)
        if support_prev is not None and support_cur is not None:
            sup = torch.minimum(support_prev, support_cur[idx])
            w = w * sup
            w = w / torch.clamp(
                torch.sum(w) / torch.clamp(torch.sum(matched), min=1),
                min=1e-9)
        R_new, t_new = align_planes(planes_prev, pb, w, prior_R, prior_t,
                                    cfg.lam_rot, cfg.lam_trans)
        n_new = torch.sum(matched.to(torch.int32)).to(torch.int32)
        # keep the previous pass's result if this pass lost all matches;
        # n counts the matches of the kept estimate
        keep = n_new < cfg.min_matches
        R_est = torch.where(keep, R_est, R_new)
        t_est = torch.where(keep, t_est, t_new)
        n = torch.where(keep, n, n_new)
    use_prior = n < cfg.min_matches
    return PlaneVOResult(R=torch.where(use_prior, prior_R, R_est),
                         t=torch.where(use_prior, prior_t, t_est),
                         n_matches=n, used_prior=use_prior)
