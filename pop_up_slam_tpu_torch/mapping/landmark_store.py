"""Fixed-capacity plane-landmark store.

Port of ``pop_up_slam_tpu/mapping/landmark_store.py``: a capacity-L
struct of tensors with a validity mask; slot allocation, eviction,
merging and extent accumulation are branch-free masked ops.

The reference writes through a sentinel index with ``mode="drop"``.
``index_put_`` raises on an out-of-range index, so every such write here
goes into an L+1 buffer whose last row takes the dropped writes and is
sliced off.  Indices are never clipped: a clipped duplicate would race
with a real write at the same slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import plane as plane_mod


class LandmarkStore(NamedTuple):
    """endpoints_w (L,2,3); n_obs (L,) int32; created_kf (L,) int32
    (-1 = free); valid (L,) bool."""

    endpoints_w: torch.Tensor
    n_obs: torch.Tensor
    created_kf: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(capacity: int, device) -> "LandmarkStore":
        return LandmarkStore(
            endpoints_w=torch.zeros((capacity, 2, 3), dtype=torch.float32,
                                    device=device),
            n_obs=torch.zeros((capacity,), dtype=torch.int32, device=device),
            created_kf=torch.full((capacity,), -1, dtype=torch.int32,
                                  device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.n_obs.shape[0]


def _values(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    shape = (idx.shape[0],) + x.shape[1:]
    if isinstance(values, torch.Tensor):
        return values.to(x.dtype).expand(shape)
    return torch.full(shape, values, dtype=x.dtype, device=x.device)


def _drop_set(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """x.at[idx].set(values, mode="drop") with idx == len(x) as the
    sentinel; the real indices must be unique."""
    buf = torch.cat([x, torch.zeros_like(x[:1])])
    buf.index_put_((idx.long(),), _values(x, idx, values))
    return buf[:-1]


def _drop_add(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """x.at[idx].add(values, mode="drop") with idx == len(x) as the
    sentinel."""
    buf = torch.cat([x, torch.zeros_like(x[:1])])
    buf.index_put_((idx.long(),), _values(x, idx, values), accumulate=True)
    return buf[:-1]


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0, dtype=torch.int32)


def insert_landmarks(store: LandmarkStore, new_mask: torch.Tensor,
                     det_endpoints_w: torch.Tensor, kf_index: torch.Tensor):
    """Allocate free slots for new detections: detection d takes the
    (rank-of-d)-th free slot.  Returns (store, slot_idx (D,) int32, -1
    where not inserted)."""
    L = store.capacity
    free = ~store.valid
    free_i = free.to(torch.int32)
    free_rank = _cumsum_i32(free_i) - free_i
    new_i = new_mask.to(torch.int32)
    det_rank = _cumsum_i32(new_i) - new_i
    n_free = free_i.sum()

    match = free[:, None] & (free_rank[:, None] == det_rank[None, :])
    slot = torch.argmax(match.to(torch.int32), dim=0).to(torch.int32)
    ok = new_mask & (det_rank < n_free)
    slot_idx = torch.where(ok, slot, torch.full_like(slot, -1))

    drop_slot = torch.where(ok, slot, torch.full_like(slot, L))
    store = store._replace(
        endpoints_w=_drop_set(store.endpoints_w, drop_slot, det_endpoints_w),
        n_obs=_drop_add(store.n_obs, drop_slot, 1),
        created_kf=_drop_set(store.created_kf, drop_slot, kf_index),
        valid=_drop_set(store.valid, drop_slot, True),
    )
    return store, slot_idx


def evict_landmarks(store: LandmarkStore, in_window: torch.Tensor,
                    need: torch.Tensor):
    """Free slots for incoming landmarks when the store is short: evict
    the lowest-key valid landmarks not referenced by a window factor.

    The key is ``n_obs * 1e6 + created_kf`` in f32 and the rank a stable
    ``argsort(argsort(key))``, exactly as the reference: the f32 key
    loses the ``created_kf`` tie-break once ``n_obs`` reaches ~17, and
    keeping that flaw is what keeps parity.  Returns (store, evicted)."""
    L = store.capacity
    evictable = store.valid & (~in_window)
    key = (store.n_obs.to(torch.float32) * 1e6
           + store.created_kf.to(torch.float32))
    key = torch.where(evictable, key, torch.full_like(key, float("inf")))
    rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
    n_free = (~store.valid).sum()
    deficit = torch.clamp(need - n_free, 0, L)
    evicted = evictable & (rank < deficit)
    store = store._replace(
        valid=store.valid & (~evicted),
        n_obs=torch.where(evicted, torch.zeros_like(store.n_obs),
                          store.n_obs),
        created_kf=torch.where(evicted, torch.full_like(store.created_kf, -1),
                               store.created_kf),
    )
    return store, evicted


def _extreme_endpoints(cand: torch.Tensor, d_unit: torch.Tensor):
    """Min/max-projection points of cand (N, 4, 3) along d_unit (N, 3)
    (first index on ties)."""
    proj = torch.einsum("bkc,bc->bk", cand, d_unit)
    i_min = torch.argmin(proj, dim=-1)
    i_max = torch.argmax(proj, dim=-1)

    def take(i):
        return torch.gather(cand, 1, i[:, None, None].expand(-1, 1, 3))[:, 0]

    return torch.stack([take(i_min), take(i_max)], dim=1)


def merge_landmarks(store: LandmarkStore, lm_planes_w: torch.Tensor,
                    lm_valid: torch.Tensor, max_angle: float, max_dist: float,
                    min_overlap: float):
    """Fold duplicate co-planar landmarks, weaker b into stronger a.

    Returns (store, lm_valid, remap (L,) int32, merged (L,) bool).  When
    several sources fold into one target the extent union keeps the
    last source (the reference's last-write-wins scatter); here only
    that last source writes, so the result does not depend on the order
    a scatter applies duplicates in."""
    L = store.capacity
    dev = lm_planes_w.device
    n, d = plane_mod.to_hessian_normal(lm_planes_w)
    mid = store.endpoints_w.mean(dim=1)

    cosang = torch.abs(torch.einsum("ac,bc->ab", n, n))
    cos_max = torch.cos(torch.full((), max_angle, dtype=torch.float32,
                                   device=dev))
    ang_ok = cosang >= cos_max
    dist = torch.abs(torch.einsum("ac,bc->ab", n, mid) + d[:, None])
    dist_ok = dist < max_dist

    wall_like, d_unit = plane_mod.line_direction(n)
    proj = torch.einsum("ac,bkc->abk", d_unit, store.endpoints_w)
    lo = torch.minimum(proj[..., 0], proj[..., 1])
    hi = torch.maximum(proj[..., 0], proj[..., 1])
    diag = torch.arange(L, device=dev)
    own_lo = lo[diag, diag][:, None]
    own_hi = hi[diag, diag][:, None]
    ovl = torch.minimum(own_hi, hi) - torch.maximum(own_lo, lo)
    ovl_ok = ovl > min_overlap

    both = (lm_valid[:, None] & lm_valid[None, :] & store.valid[:, None]
            & store.valid[None, :])
    walls = wall_like[:, None] & wall_like[None, :]
    not_self = diag[:, None] != diag[None, :]
    skey = store.n_obs * L + (L - 1 - diag).to(torch.int32)
    stronger = skey[:, None] > skey[None, :]
    elig = both & walls & not_self & ang_ok & dist_ok & ovl_ok & stronger

    score = torch.where(elig, skey[:, None], torch.full_like(elig, -1,
                                                             dtype=skey.dtype))
    tgt = torch.argmax(score, dim=0).to(torch.int32)
    has = torch.amax(score, dim=0) >= 0
    merged = has & (~has[tgt.long()])

    drop_tgt = torch.where(merged, tgt, torch.full_like(tgt, L))
    add_obs = torch.where(merged, store.n_obs, torch.zeros_like(store.n_obs))
    n_obs = _drop_add(store.n_obs, drop_tgt, add_obs)
    n_obs = torch.where(merged, torch.zeros_like(n_obs), n_obs)

    tgt_l = tgt.long()
    cand = torch.cat([store.endpoints_w[tgt_l], store.endpoints_w], dim=1)
    e_new = _extreme_endpoints(cand, d_unit[tgt_l])
    # the last (highest-index) source of each target writes its union
    src_of = merged[:, None] & (tgt_l[:, None] == diag[None, :])   # (b, t)
    last_src = torch.amax(torch.where(src_of, diag[:, None],
                                      torch.full_like(src_of, -1,
                                                      dtype=diag.dtype)),
                          dim=0)
    writer = merged & (last_src[tgt_l] == diag)
    endpoints = _drop_set(store.endpoints_w,
                          torch.where(writer, tgt, torch.full_like(tgt, L)),
                          e_new)

    store = store._replace(
        endpoints_w=endpoints,
        n_obs=n_obs,
        created_kf=torch.where(merged, torch.full_like(store.created_kf, -1),
                               store.created_kf),
        valid=store.valid & (~merged),
    )
    lm_valid = lm_valid & (~merged)
    remap = torch.where(merged, tgt, diag.to(torch.int32))
    return store, lm_valid, remap, merged


def update_extents(store: LandmarkStore, lm_idx: torch.Tensor,
                   det_endpoints_w: torch.Tensor, match_mask: torch.Tensor,
                   lm_planes_w: torch.Tensor):
    """Extend matched landmarks' ground-line extents by the observation
    (union along the landmark's line direction; near-horizontal
    landmarks keep theirs) and count the observation."""
    L = store.capacity
    safe = torch.clamp(lm_idx, 0, L - 1)
    safe_l = safe.long()
    old = store.endpoints_w[safe_l]
    horiz_ok, d_unit = plane_mod.line_direction(lm_planes_w[safe_l, :3])
    cand = torch.cat([old, det_endpoints_w], dim=1)
    e_new = _extreme_endpoints(cand, d_unit)
    upd = match_mask & horiz_ok
    sentinel = torch.full_like(safe, L)
    return store._replace(
        endpoints_w=_drop_set(store.endpoints_w,
                              torch.where(upd, safe, sentinel), e_new),
        n_obs=_drop_add(store.n_obs, torch.where(match_mask, safe, sentinel),
                        1),
    )
