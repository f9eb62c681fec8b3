"""Canonical synthetic solver problems (the corridor BA problem).

Port of ``pop_up_slam_tpu/io/problems.py``: a sliding window of poses
down the synthetic corridor with odometry factors (noisy, whitened by
the true sigmas) and plane factors whose detection->landmark association
is the ground-truth oracle.

The reference draws its noise from ``jax.random`` keys; the port takes
the draws themselves (tensors, as :mod:`.synthetic` does) or draws them
from a ``torch.Generator``.  The two frameworks give different numbers
from one seed, so a test hands both the same draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..factors.graph import (
    Factors,
    OdomFactors,
    PlaneFactors,
    PosePriors,
    Window,
)
from ..geometry import plane, se3
from . import synthetic


class CorridorDraws(NamedTuple):
    """The standard-normal draws of one corridor problem: ``odom`` (W-1,
    6) for the odometry noise, ``obs`` (W, M, 3) for each frame's plane
    noise (M = ``max_walls``), ``lm`` (M+1, 3) for the landmark
    perturbation.  The reference's keys give ``normal(k_odom, (W-1, 6))``,
    ``normal(split(k_obs, W)[f], (M, 3))`` and ``normal(k_lm, (M+1, 3))``
    with ``k_odom, k_obs, k_lm = split(PRNGKey(seed), 3)``."""

    odom: torch.Tensor
    obs: torch.Tensor
    lm: torch.Tensor


def draw_corridor_noise(window: int = 6, max_walls: int = 8,
                        generator: torch.Generator | None = None
                        ) -> CorridorDraws:
    """The draws of :func:`build_corridor_problem` from ``generator``
    (on the CPU)."""
    return CorridorDraws(
        odom=torch.randn((window - 1, 6), generator=generator),
        obs=torch.randn((window, max_walls, 3), generator=generator),
        lm=torch.randn((max_walls + 1, 3), generator=generator))


def build_corridor_problem(
    noise_odom_t: float = 0.0,
    noise_odom_r: float = 0.0,
    noise_plane: float = 0.0,
    seed: int = 0,
    lm_perturb: float = 0.0,
    window: int = 6,
    max_walls: int = 8,
    max_det: int = 6,
    draws: CorridorDraws | None = None,
    device=None,
):
    """Oracle-associated corridor problem.

    Returns (window_init, factors, gt_R, gt_t) on ``device``: the window
    is initialized by integrating the noisy odometry from the true first
    pose; landmarks are the true world planes (optionally perturbed in
    their 3-DOF tangent); plane factors carry the oracle association
    wall k -> landmark k, ground -> the last landmark slot.  The noise
    comes from ``draws``, or from a ``torch.Generator`` seeded with
    ``seed`` when none are given.
    """
    dev = resolve_device(device)
    W, MAXW, MAX_DET = window, max_walls, max_det
    L = MAXW + 1
    CAP_PF = W * MAX_DET
    if draws is None:
        draws = draw_corridor_noise(W, MAXW,
                                    torch.Generator().manual_seed(seed))
    f32 = torch.float32

    world = synthetic.corridor_world(max_walls=MAXW, device=dev)
    gt_R, gt_t = synthetic.corridor_trajectory(W, sway=0.3, device=dev)
    obs = [synthetic.observe_frame(world, gt_R[f], gt_t[f],
                                   noise=draws.obs[f], max_det=MAX_DET,
                                   noise_plane=noise_plane)
           for f in range(W)]

    # odometry factors between consecutive poses, whitened by the true
    # noise sigmas (floor at 0.01 to keep zero-noise cases bounded)
    Rrel, trel = synthetic.noisy_odometry(gt_R, gt_t, xi=draws.odom,
                                          sigma_t=noise_odom_t,
                                          sigma_r=noise_odom_r)
    st = max(noise_odom_t, 0.01)
    sr = max(noise_odom_r, 0.01)
    odom_sqrt = torch.diag(torch.tensor([1 / st] * 3 + [1 / sr] * 3,
                                        dtype=f32, device=dev))
    odom = OdomFactors(
        i=torch.arange(W - 1, dtype=torch.int32, device=dev),
        j=torch.arange(1, W, dtype=torch.int32, device=dev),
        R_meas=Rrel, t_meas=trel,
        sqrt_info=odom_sqrt.expand(W - 1, 6, 6).contiguous(),
        valid=torch.ones((W - 1,), dtype=torch.bool, device=dev))

    # plane factors with oracle association: wall k -> landmark k,
    # ground -> landmark L-1 (read on the host once: a build step)
    wid = torch.stack([o.wall_id for o in obs]).cpu()
    ovalid = torch.stack([o.valid for o in obs]).cpu()
    lm = torch.where(wid == -2, torch.full_like(wid, L - 1), wid)
    pf_valid = (ovalid & (wid != -1)).reshape(-1)
    sp = max(noise_plane, 0.01)
    pf = PlaneFactors(
        pose_idx=torch.arange(W, dtype=torch.int32).repeat_interleave(
            MAX_DET).to(dev),
        lm_idx=torch.clamp(lm, min=0).reshape(-1).to(dev),
        pi_meas=torch.cat([o.planes_c for o in obs]),
        sqrt_info=((1 / sp) * torch.eye(3, dtype=f32, device=dev)).expand(
            CAP_PF, 3, 3).contiguous(),
        valid=pf_valid.to(dev))

    # initialization: integrate the noisy odometry from gt pose 0
    Rs, ts = [gt_R[0]], [gt_t[0]]
    for k in range(W - 1):
        Rn, tn = se3.se3_compose(Rs[-1], ts[-1], Rrel[k], trel[k])
        Rs.append(Rn)
        ts.append(tn)

    # landmark init: gt planes (optionally perturbed)
    ground = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=f32, device=dev)
    lms = torch.cat([world.planes(), ground[None]])
    if lm_perturb > 0:
        lms = plane.retract(lms, lm_perturb * draws.lm.to(dev))
    lm_valid = torch.zeros((L,), dtype=torch.bool)
    lm_valid[lm.reshape(-1)[pf_valid].long()] = True

    window_init = Window(
        R=torch.stack(Rs), t=torch.stack(ts), planes=plane.normalize(lms),
        pose_valid=torch.ones((W,), dtype=torch.bool, device=dev),
        pose_fixed=torch.arange(W, device=dev) == 0,
        lm_valid=lm_valid.to(dev))
    priors = PosePriors(
        idx=torch.zeros((1,), dtype=torch.int32, device=dev),
        R=torch.eye(3, dtype=f32, device=dev)[None],
        t=torch.zeros((1, 3), dtype=f32, device=dev),
        sqrt_info=torch.eye(6, dtype=f32, device=dev)[None],
        valid=torch.zeros((1,), dtype=torch.bool, device=dev))
    factors = Factors(odom=odom, planes=pf, priors=priors)
    return window_init, factors, gt_R, gt_t
