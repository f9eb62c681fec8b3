"""Ground/wall segmentation: the classical floor-color model.

Port of ``classical_ground_mask`` from
``pop_up_slam_tpu/models/segmentation.py``.  The learned segmenter
(``SegNetLite``) and its loader are not ported yet (``ROADMAP.md``
queue 1).
"""

from __future__ import annotations

import torch


def classical_ground_mask(
    rgb: torch.Tensor,
    seed_frac: float = 0.12,
    mahalanobis_thresh: float = 9.0,
    min_col_run: int = 3,
) -> torch.Tensor:
    """Floor-color segmentation without a CNN.

    rgb: (H, W, 3) float in [0, 1] (or uint8).  Fits a Gaussian color
    model to the bottom-center patch (bottom ``seed_frac`` of rows,
    central half of columns), refines it once on the inliers of the
    lower image half, and labels pixels within a Mahalanobis radius;
    an empty mask when the seed color is not separable from the top
    rows'.  A per-column cleanup keeps a ground pixel only while fewer
    than ``min_col_run`` non-ground pixels lie between it and the ground
    pixel below it (or the bottom edge), as the reference's bottom-up
    scan does.  Returns (H, W) bool, on ``rgb``'s device, without a host
    sync (the 3x3 inverses are ``inv_ex``'s).
    """
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) / 255.0
    H, W, _ = rgb.shape
    dev = rgb.device
    seed_rows = max(int(H * seed_frac), 4)
    seed = rgb[H - seed_rows:, W // 4: (3 * W) // 4, :].reshape(-1, 3)
    eye3 = torch.eye(3, dtype=rgb.dtype, device=dev)

    def fit(pix, w):
        wsum = torch.clamp(w.sum(), min=1.0)
        mu = (pix * w[:, None]).sum(dim=0) / wsum
        centered = (pix - mu) * torch.sqrt(w)[:, None]
        cov = centered.T @ centered / wsum + 1e-4 * eye3
        return mu, torch.linalg.inv_ex(cov)[0]

    def mdist(mu, prec):
        diff = rgb - mu
        return torch.einsum("hwi,ij,hwj->hw", diff, prec, diff)

    mu, prec = fit(seed, torch.ones((seed.shape[0],), device=dev))
    # one robust refit on lower-half inliers of the initial model
    rows = torch.arange(H, device=dev)[:, None]
    inlier = (mdist(mu, prec) < mahalanobis_thresh) & (rows >= H // 2)
    mu, prec = fit(rgb.reshape(-1, 3), inlier.reshape(-1).to(rgb.dtype))
    raw = mdist(mu, prec) < mahalanobis_thresh

    # degeneracy guard: the seed color must separate from the top rows'
    top = rgb[:seed_rows].reshape(-1, 3)
    mu_top, _ = fit(top, torch.ones((top.shape[0],), device=dev))
    dmu = mu - mu_top
    raw = raw & (dmu @ prec @ dmu > 4.0)

    # column cleanup, bottom-up: row k (from the bottom) is kept when it
    # is ground and the run of non-ground rows just below it is shorter
    # than min_col_run; that run is k - 1 - (the last ground row below
    # k), with -1 for none, from a cumulative max
    up = torch.flip(raw, dims=(0,))
    k = torch.arange(H, device=dev)[:, None]
    last = torch.cummax(torch.where(up, k, torch.full_like(k, -1)),
                        dim=0).values
    below = torch.cat([torch.full_like(last[:1], -1), last[:-1]])
    keep = up & (k - 1 - below < min_col_run)
    return torch.flip(keep, dims=(0,))
