"""Frozen copy of the port's ``factors/robust.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

Robust loss functions (IRLS reweighting) for factor residuals.

Port of ``pop_up_slam_tpu/factors/robust.py``: every whitened residual r
is reweighted as sqrt(w(||r||^2)) * r, and so are its Jacobians.

- ``none``   : rho(s) = s,                 w = 1
- ``huber``  : quadratic inside k, linear, w = min(1, k/||r||)
- ``cauchy`` : rho(s) = k^2 log(1 + s/k^2), w = 1/(1 + s/k^2)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

class RobustKernel(NamedTuple):
    kind: str = "none"
    scale: float = 1.0


class RobustConfig(NamedTuple):
    """Per-factor-family robust kernels (odometry / plane / prior)."""

    odom: RobustKernel = RobustKernel()
    plane: RobustKernel = RobustKernel()
    prior: RobustKernel = RobustKernel()


def irls_weight(kernel: RobustKernel, sq_norm: torch.Tensor) -> torch.Tensor:
    if kernel.kind == "none":
        return torch.ones_like(sq_norm)
    k = float(kernel.scale)
    if kernel.kind == "huber":
        nrm = torch.sqrt(torch.clamp(sq_norm, min=1e-20))
        return torch.clamp(k / nrm, max=1.0)
    if kernel.kind == "cauchy":
        return 1.0 / (1.0 + sq_norm / (k * k))
    raise ValueError(f"unknown robust kernel '{kernel.kind}'")


def rho(kernel: RobustKernel, sq_norm: torch.Tensor) -> torch.Tensor:
    if kernel.kind == "none":
        return sq_norm
    k = float(kernel.scale)
    if kernel.kind == "huber":
        nrm = torch.sqrt(torch.clamp(sq_norm, min=1e-20))
        return torch.where(nrm <= k, sq_norm, 2.0 * k * nrm - k * k)
    if kernel.kind == "cauchy":
        return k * k * torch.log1p(sq_norm / (k * k))
    raise ValueError(f"unknown robust kernel '{kernel.kind}'")


def apply_weights(kernel: RobustKernel, r: torch.Tensor, *jacobians):
    """Scale residuals (F, d) and Jacobians (F, d, ...) by sqrt(w).
    Returns (r_weighted, *jacobians_weighted, rho_s)."""
    s = torch.sum(r * r, dim=-1)
    sw = torch.sqrt(irls_weight(kernel, s))
    out = [r * sw[:, None]]
    for J in jacobians:
        out.append(J * sw[:, None, None])
    out.append(rho(kernel, s))
    return tuple(out)
