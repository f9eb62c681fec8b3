"""K5's work on the inputs of one launch: operations and bytes.

Frozen copy of ``chip_smoke.py``'s ``k5_work``: the whitened residuals
and Jacobians of every plane factor of a window
(``ops/plane_jacobians.py::plane_terms``), whatever kernel implements
them.
"""

from __future__ import annotations

from .k1 import _PLANE_TERMS


def k5_ops(W: int, L: int, valid, pose_idx, lm_idx) -> float:
    """``k1._PLANE_TERMS`` per valid factor whose pose and landmark
    indices lie in the window."""
    p, lm = pose_idx.cpu().numpy(), lm_idx.cpu().numpy()
    ok = valid.cpu().numpy() & (p >= 0) & (p < W) & (lm >= 0) & (lm < L)
    return float(int(ok.sum()) * _PLANE_TERMS)


def k5_bytes(W: int, L: int, F: int, one_sqrt_info: bool) -> float:
    """The window and each factor's inputs read once (a sqrt-info
    broadcast over the factors, which the wrapper passes as one matrix,
    once); r, Jp and Jl (30 floats a factor) written once."""
    a_bytes = 36 if one_sqrt_info else 36 * F
    return (4 * (12 * W + 4 * L) + F * (4 + 4 + 16 + 1) + a_bytes
            + F * 4 * 30)
