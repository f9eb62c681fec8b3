"""Shared inputs and fixtures for the PyTorch-port parity tests
(``tests/test_torch_*.py``).

Inputs are made with numpy (from a seed, or from the committed corridor
masks) and handed to both the JAX reference and the port on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def corridor_inputs(step: int = 1):
    """The committed corridor sequence: masks (N, H/step, W/step) bool,
    odometry, R0, t0; masks subsampled every ``step`` pixels."""
    z = np.load(os.path.join(REPO, "bench_data", "corridor_inputs.npz"))
    n, h, w = z["shape"]
    masks = np.unpackbits(z["masks_packed"], axis=-1)[..., :w].astype(bool)
    return (masks[:, ::step, ::step], z["odom_R"], z["odom_t"], z["R0"],
            z["t0"])


def corridor_K(step: int = 1):
    """Corridor intrinsics (320, 320, 320, 240) scaled by 1/step."""
    return tuple(v / step for v in (320.0, 320.0, 320.0, 240.0))


def port_corridor(n: int, sway: float = 0.0, H: int = 96, W: int = 128):
    """``n`` poses down the synthetic corridor (the reference tests'
    ``corridor_trajectory(n, sway)``), the ground masks seen from them at
    HxW with focal length 64 (rendered by the port, whose renderer is held
    against the reference's) and the odometry between them, as numpy."""
    from pop_up_slam_tpu_torch.geometry import se3
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.io import synthetic

    K = Intrinsics.create(64.0, 64.0, W / 2, H / 2, device=CPU)
    world = synthetic.corridor_world(device=CPU)
    Rs, ts = synthetic.corridor_trajectory(n, sway=sway, device=CPU)
    masks = torch.stack([synthetic.render_frame(K, Rs[i], ts[i], world, H,
                                                W)[0]
                         for i in range(n)]) == synthetic.LABEL_GROUND
    oR, ot = se3.se3_between(Rs[:-1], ts[:-1], Rs[1:], ts[1:])
    return tuple(x.numpy() for x in (Rs, ts, masks, oR, ot))


def spd_system(n: int, seed: int):
    """A well-conditioned SPD system (A A^T + n I, b), f32."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    S = (A @ A.T + n * np.eye(n)).astype(np.float32)
    return S, rng.normal(size=(n,)).astype(np.float32)


def salt(mask: np.ndarray, rate: float, seed: int) -> np.ndarray:
    """Flip a ``rate`` fraction of pixels."""
    rng = np.random.default_rng(seed)
    return mask ^ (rng.random(mask.shape) < rate)


def np_tree(x):
    """A (nested) NamedTuple of arrays/tensors as numpy."""
    if isinstance(x, tuple):
        vals = [np_tree(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(a, b, atol, rtol=0.0, what=""):
    """Port output ``a`` vs reference ``b``: finite, same shape, within
    tolerance (nested tuples compared leaf by leaf)."""
    a, b = np_tree(a), np_tree(b)
    if isinstance(a, tuple):
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            assert_close(x, y, atol, rtol, f"{what}.{name}")
        return
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    assert np.isfinite(a).all(), f"{what}: non-finite port output"
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=what)


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def ba_problem(seed: int, W: int = 6, L: int = 9, prior_gauge: bool = False,
               noise: float = 1.0):
    """A seeded windowed-BA problem in a corridor, as numpy arrays:
    (window, factors) dicts of the reference's field names.

    W poses walking down a corridor (camera looking along +y, yaw sway),
    L planes (the two side walls, the end wall, the ground and L-4
    random vertical walls), every pose observing every plane (10% of
    the observations invalid), noisy odometry and plane measurements,
    and an initial estimate perturbed from the truth.  Gauge: slot 0
    fixed, or (``prior_gauge``) free under a strong prior."""
    from pop_up_slam_tpu_torch.geometry import plane, se3

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def t_(x):
        return torch.as_tensor(np.asarray(x, f32))

    R0 = t_([[1, 0, 0], [0, 0, 1], [0, -1, 0]])
    yaw = 0.15 * np.sin(np.arange(W) * 0.7)
    xi_yaw = np.zeros((W, 6), f32)
    xi_yaw[:, 5] = yaw
    Rz, _ = se3.se3_exp(t_(xi_yaw))
    gt_R = Rz @ R0
    gt_t = t_(np.stack([0.2 * np.sin(np.arange(W)), 0.4 * np.arange(W),
                        np.full(W, 1.4)], -1))

    walls = [[1, 0, 0, -1.0], [1, 0, 0, 1.0], [0, 1, 0, -10.0],
             [0, 0, 1, 0.0]]
    for _ in range(L - 4):
        a = rng.uniform(0, np.pi)
        walls.append([np.cos(a), np.sin(a), 0.0, rng.uniform(-6, 6)])
    gt_pl = plane.normalize(t_(walls))

    def perturb_pose(R, t, s):
        xi = t_(rng.normal(size=(R.shape[0], 6)) * s)
        return se3.se3_retract(R, t, xi)

    # odometry between consecutive poses, with noise
    oR, ot = se3.se3_between(gt_R[:-1], gt_t[:-1], gt_R[1:], gt_t[1:])
    oR, ot = perturb_pose(oR, ot, 0.01 * noise)
    # plane measurements in each camera frame, with noise
    pose_idx = np.repeat(np.arange(W), L).astype(np.int32)
    lm_idx = np.tile(np.arange(L), W).astype(np.int32)
    R_cw, t_cw = se3.se3_inverse(gt_R[pose_idx], gt_t[pose_idx])
    pi_c = plane.transform(gt_pl[lm_idx], R_cw, t_cw)
    pi_c = plane.normalize(pi_c + t_(rng.normal(size=pi_c.shape)
                                     * 0.005 * noise))
    valid = rng.random(W * L) > 0.1
    # initial estimate: slot 0 exact, the rest perturbed
    iR, it = perturb_pose(gt_R, gt_t, 0.03 * noise)
    iR[0], it[0] = gt_R[0], gt_t[0]
    ipl = plane.retract(gt_pl, t_(rng.normal(size=(L, 3)) * 0.02 * noise))

    window = dict(
        R=iR.numpy(), t=it.numpy(), planes=ipl.numpy(),
        pose_valid=np.ones(W, bool),
        pose_fixed=(np.arange(W) == 0) & (not prior_gauge),
        lm_valid=np.ones(L, bool),
    )
    odom = dict(
        i=np.arange(W - 1, dtype=np.int32),
        j=np.arange(1, W, dtype=np.int32),
        R_meas=oR.numpy(), t_meas=ot.numpy(),
        sqrt_info=np.broadcast_to(
            np.diag([1 / 0.03] * 3 + [1 / 0.01] * 3).astype(f32),
            (W - 1, 6, 6)).copy(),
        valid=np.ones(W - 1, bool),
    )
    planes = dict(
        pose_idx=pose_idx, lm_idx=lm_idx, pi_meas=pi_c.numpy(),
        sqrt_info=np.broadcast_to(
            np.diag([1 / 0.015, 1 / 0.015, 1 / 0.02]).astype(f32),
            (W * L, 3, 3)).copy(),
        valid=valid,
    )
    priors = dict(
        idx=np.zeros(1, np.int32), R=gt_R[:1].numpy(), t=gt_t[:1].numpy(),
        sqrt_info=(1e2 * np.eye(6, dtype=f32))[None],
        valid=np.full(1, prior_gauge),
    )
    return window, dict(odom=odom, planes=planes, priors=priors)


def random_problem(seed: int, W: int = 6, L: int = 10, F: int = 24):
    """Random poses and planes, F plane factors on random (pose, landmark)
    pairs with noisy measurements, sqrt-info diag(20, 20, 10), ~15% of the
    factors and the last two landmarks invalid, pose 0 fixed: numpy
    (window, plane-factor) dicts (``tests/test_ops.py::_random_problem``
    drawn with numpy)."""
    from pop_up_slam_tpu_torch.geometry import plane, se3

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def t_(x):
        return torch.as_tensor(np.asarray(x, f32))

    R = se3.so3_exp(t_(0.3 * rng.normal(size=(W, 3))))
    t = t_(rng.normal(size=(W, 3)))
    planes = plane.normalize(t_(rng.normal(size=(L, 4))))
    pose_idx = rng.integers(0, W, size=F).astype(np.int32)
    lm_idx = rng.integers(0, L - 2, size=F).astype(np.int32)
    R_cw, t_cw = se3.se3_inverse(R[pose_idx], t[pose_idx])
    pi_c = plane.transform(planes[lm_idx], R_cw, t_cw)
    pi_meas = plane.retract(pi_c, t_(0.05 * rng.normal(size=(F, 3))))
    window = dict(R=R.numpy(), t=t.numpy(), planes=planes.numpy(),
                  pose_valid=np.ones(W, bool),
                  pose_fixed=np.arange(W) == 0,
                  lm_valid=np.arange(L) < L - 2)
    pf = dict(pose_idx=pose_idx, lm_idx=lm_idx, pi_meas=pi_meas.numpy(),
              sqrt_info=np.broadcast_to(np.diag([20.0, 20.0, 10.0]).astype(
                  f32), (F, 3, 3)).copy(),
              valid=rng.random(F) < 0.85)
    return window, pf


def random_system(seed: int, W: int = 5, L: int = 9, F: int = 40):
    """:func:`random_problem` plus an odometry chain with random
    measurements and a prior on pose 0: numpy (window, factors) dicts
    whose normal equations are SPD (``tests/test_ops.py::
    _random_spd_system`` drawn with numpy)."""
    from pop_up_slam_tpu_torch.geometry import se3

    window, pf = random_problem(seed, W, L, F)
    rng = np.random.default_rng(seed + 1000)
    f32 = np.float32
    eye6 = np.broadcast_to(np.eye(6, dtype=f32), (W - 1, 6, 6)).copy()
    odom = dict(
        i=np.arange(W - 1, dtype=np.int32), j=np.arange(1, W, dtype=np.int32),
        R_meas=se3.so3_exp(torch.as_tensor(
            0.1 * rng.normal(size=(W - 1, 3)).astype(f32))).numpy(),
        t_meas=rng.normal(size=(W - 1, 3)).astype(f32), sqrt_info=eye6,
        valid=np.ones(W - 1, bool))
    priors = dict(idx=np.zeros(1, np.int32), R=window["R"][:1],
                  t=window["t"][:1], sqrt_info=np.eye(6, dtype=f32)[None],
                  valid=np.ones(1, bool))
    return window, dict(odom=odom, planes=pf, priors=priors)


def indefinite(lin, p: int = 2):
    """``lin`` with direction 0 of free pose ``p`` decoupled and given
    negative curvature: its reduced pivot is indefinite."""
    Hpp, Hpl = lin.Hpp.clone(), lin.Hpl.clone()
    Hpp[p, :, 0, :] = 0.0
    Hpp[:, p, :, 0] = 0.0
    Hpp[p, p, 0, 0] = -1.0
    Hpl[p, :, 0, :] = 0.0
    return lin._replace(Hpp=Hpp, Hpl=Hpl)


def to_jax(cls, d):
    """A numpy dict (or nested dicts) -> the reference's NamedTuple."""
    import jax.numpy as jnp

    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def ground_mask_ties(rgb8: np.ndarray, band: float) -> np.ndarray:
    """The pixels of an 8-bit RGB frame (H, W, 3) where two f32
    evaluations of ``classical_ground_mask`` may decide differently: its
    model evaluated in f64 puts the pixel's squared Mahalanobis distance
    within ``band`` of the threshold 9 (a tie), or a tie lies among the
    three pixels below it (the column cleanup reads those).  Raises if the
    seed/top separation test itself is within ``band`` of its threshold."""
    rgb = rgb8.astype(np.float64) / 255.0
    h, w, _ = rgb.shape
    rows = max(int(h * 0.12), 4)

    def fit(pix, wt):
        ws = max(wt.sum(), 1.0)
        mu = (pix * wt[:, None]).sum(0) / ws
        c = (pix - mu) * np.sqrt(wt)[:, None]
        return mu, np.linalg.inv(c.T @ c / ws + 1e-4 * np.eye(3))

    def dist(mu, prec):
        d = rgb - mu
        return np.einsum("hwi,ij,hwj->hw", d, prec, d)

    seed = rgb[h - rows:, w // 4:(3 * w) // 4].reshape(-1, 3)
    mu, prec = fit(seed, np.ones(len(seed)))
    inlier = (dist(mu, prec) < 9.0) & (np.arange(h)[:, None] >= h // 2)
    mu, prec = fit(rgb.reshape(-1, 3), inlier.reshape(-1).astype(float))
    top = rgb[:rows].reshape(-1, 3)
    dmu = mu - fit(top, np.ones(len(top)))[0]
    if abs(dmu @ prec @ dmu - 4.0) <= band:
        raise ValueError("the separation test is itself a tie")
    near = np.abs(dist(mu, prec) - 9.0) < band
    ties = near.copy()
    for s in (1, 2, 3):
        ties[:-s] |= near[s:]
    return ties
