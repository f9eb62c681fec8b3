"""Frozen copy of the port's ``assoc/data_association.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

Masked fixed-capacity plane data association.

Port of ``pop_up_slam_tpu/assoc/data_association.py``: a dense gated
D x L score matrix (normal angle, point-to-plane distance, 1-D extent
overlap along the landmark's ground line) plus D unrolled steps of
greedy assignment, each claiming the current global best pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import plane as plane_mod

_BIG = 1e9


class AssocConfig(NamedTuple):
    max_angle: float = 0.35
    max_dist: float = 0.35
    min_overlap: float = -2.0
    w_angle: float = 1.0
    w_dist: float = 1.0


class AssocResult(NamedTuple):
    match_lm: torch.Tensor   # (D,) int32, -1 = unmatched
    is_new: torch.Tensor     # (D,) bool
    scores: torch.Tensor     # (D, L)


def _segment_overlap_1d(a0, a1, b0, b1):
    alo, ahi = torch.minimum(a0, a1), torch.maximum(a0, a1)
    blo, bhi = torch.minimum(b0, b1), torch.maximum(b0, b1)
    return torch.minimum(ahi, bhi) - torch.maximum(alo, blo)


def landmark_scores(det_planes_w, det_centroid_w, det_endpoints_w, det_valid,
                    lm_planes_w, lm_endpoints_w, lm_valid,
                    cfg: AssocConfig = AssocConfig()):
    """Dense gated score matrix (D, L); _BIG where gated out."""
    ang = plane_mod.normal_angle(det_planes_w[:, None, :],
                                 lm_planes_w[None, :, :])
    dist = torch.abs(plane_mod.point_to_plane_distance(
        lm_planes_w[None, :, :], det_centroid_w[:, None, :]))

    horiz_ok, d_unit = plane_mod.line_direction(lm_planes_w[:, :3])
    de = torch.einsum("dei,li->dle", det_endpoints_w, d_unit)
    le = torch.einsum("lei,li->le", lm_endpoints_w, d_unit)
    ovl = _segment_overlap_1d(de[..., 0], de[..., 1],
                              le[None, :, 0], le[None, :, 1])
    ovl_ok = (~horiz_ok[None, :]) | (ovl > cfg.min_overlap)

    ok = (det_valid[:, None] & lm_valid[None, :] & (ang < cfg.max_angle)
          & (dist < cfg.max_dist) & ovl_ok)
    score = cfg.w_angle * ang + cfg.w_dist * dist
    return torch.where(ok, score, torch.full_like(score, _BIG))


def associate_detections(det_planes_w, det_centroid_w, det_endpoints_w,
                         det_valid, lm_planes_w, lm_endpoints_w, lm_valid,
                         cfg: AssocConfig = AssocConfig()) -> AssocResult:
    """Greedy globally-ordered assignment on the gated score matrix.

    D unrolled steps; each takes the first minimum of the flattened
    (D, L) matrix (``torch.argmin`` keeps the first index, as
    ``jnp.argmin`` does) and masks its row and column.  No host sync."""
    scores = landmark_scores(det_planes_w, det_centroid_w, det_endpoints_w,
                             det_valid, lm_planes_w, lm_endpoints_w,
                             lm_valid, cfg)
    D, L = scores.shape
    dev = scores.device
    rows = torch.arange(D, device=dev)
    cols = torch.arange(L, device=dev)
    s = scores
    match = torch.full((D,), -1, dtype=torch.int32, device=dev)
    for _ in range(D):
        flat = torch.argmin(s.reshape(-1))
        d, l = flat // L, flat % L
        take = torch.amin(s) < _BIG          # s at the argmin, on the device
        row_d = rows == d
        match = torch.where(take & row_d, l.to(torch.int32), match)
        hit = row_d[:, None] | (cols == l)[None, :]
        s = torch.where(take & hit, torch.full_like(s, _BIG), s)
    is_new = det_valid & (match < 0)
    return AssocResult(match_lm=match, is_new=is_new, scores=scores)
