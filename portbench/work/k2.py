"""K2's work on the inputs of one launch: operations and bytes.

Frozen copy of ``chip_smoke.py``'s ``k2_ops`` and of its byte count in
``check_k2``: the dense depth render of one frame's pop-up, whatever
kernel implements it.
"""

from __future__ import annotations


def k2_ops(H: int, W: int, n_walls: int) -> float:
    """Per pixel the ray, its rotation and the ground hit (21); per valid
    wall the hit, its extent and height tests (19); per wall once the
    staged terms (14)."""
    return H * W * (21 + 19 * n_walls) + 14 * n_walls


def k2_bytes(H: int, W: int, S: int) -> float:
    """The mask read and the depth written once; camera, pose and ground;
    each wall slot's plane, endpoints and flags."""
    return H * W * (1 + 4) + 4 * (4 + 9 + 3 + 4) + S * (4 * 4 + 4 * 6 + 3)
