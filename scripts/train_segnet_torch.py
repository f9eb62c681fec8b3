#!/usr/bin/env python3
"""Train the port's SegNetLite on synthetic renders (on the GPU by default).

The counterpart of ``scripts/train_segnet.py``: each step draws one of
three worlds (a corridor of random length and width with a swaying walk,
a room with an orbit, a room with a short walk), renders 8 frames at
96x128 (intrinsics 64, 64, 64, 48) with the port's ``io/synthetic.py``
and colors them with per-wall tints and pixel noise, and takes one Adam
step (lr 3e-3) of the mean sigmoid binary cross-entropy; 400 steps by
default.  The held-out IoU is measured on 5 batches drawn from their own
seeds, and the weights are written to ``--out`` in the committed
checkpoint's layout (``models.load_pretrained_segnet(path)`` reads it).
Every draw comes from a ``torch.Generator`` seeded by ``--seed``.  It
never writes ``models_data/segnet_lite.npz``.

    python scripts/train_segnet_torch.py --out segnet_torch.npz \
        [--steps 400] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import torch  # noqa: E402

from pop_up_slam_tpu_torch.geometry.camera import Intrinsics  # noqa: E402
from pop_up_slam_tpu_torch.io import synthetic  # noqa: E402
from pop_up_slam_tpu_torch.models import (  # noqa: E402
    create_train_state,
    predict_mask,
    save_segnet,
    train_step,
)

H, W = 96, 128
BATCH = 8
LR = 3e-3
STEPS = 400
HOLDOUT = 5
HOLDOUT_SEED = 10_000
COMMITTED = os.path.join(_REPO, "models_data", "segnet_lite.npz")


def _uniform(gen, lo, hi) -> float:
    return float(lo + (hi - lo) * torch.rand((), generator=gen))


def make_batch(gen: torch.Generator, device, n: int = BATCH):
    """A random world and trajectory, n frames: (rgb (n,H,W,3) f32,
    ground (n,H,W) bool) on ``device``."""
    pick = int(torch.randint(0, 3, (), generator=gen))
    if pick == 0:
        world = synthetic.corridor_world(length=_uniform(gen, 6, 14),
                                         width=_uniform(gen, 1.5, 3.0),
                                         device=device)
        R, t = synthetic.corridor_trajectory(
            n, length=10.0, sway=_uniform(gen, 0, 0.4), device=device)
    elif pick == 1:
        world = synthetic.room_world(size=_uniform(gen, 4, 8), device=device)
        R, t = synthetic.orbit_trajectory(n, radius=_uniform(gen, 1.0, 2.0),
                                          device=device)
    else:
        world = synthetic.room_world(size=_uniform(gen, 5, 7), device=device)
        R, t = synthetic.corridor_trajectory(
            n, length=4.0, sway=_uniform(gen, 0, 0.3), device=device)
    K = Intrinsics.create(64.0, 64.0, 64.0, 48.0, device=device)
    labels = torch.stack([synthetic.render_frame(K, R[i], t[i], world, H,
                                                 W)[0] for i in range(n)])
    rgb = torch.stack([synthetic.render_rgb(labels[i], generator=gen)
                       for i in range(n)])
    return rgb, labels == synthetic.LABEL_GROUND


def iou(pred: torch.Tensor, gt: torch.Tensor) -> float:
    union = int((pred | gt).sum())
    return 1.0 if union == 0 else int((pred & gt).sum()) / union


def train(steps: int = STEPS, device="cuda", seed: int = 0, log_every=50):
    """Train from ``seed``: returns (model, params, tx, losses (steps,) on
    the device, ms a step over the steps after the first, the first
    batch)."""
    gen = torch.Generator().manual_seed(seed)
    model, params, tx = create_train_state(gen, lr=LR, image_hw=(H, W),
                                           device=device)
    losses = []
    t_second = None
    t0 = time.perf_counter()
    batch0 = None
    for it in range(steps):
        rgb, gt = make_batch(gen, device)
        if it == 0:
            batch0 = (rgb, gt)
        losses.append(train_step(model, params, tx, rgb, gt))
        if it == 0:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            t_second = time.perf_counter()
        if log_every and (it % log_every == 0 or it == steps - 1):
            print(f"step {it:4d} loss {float(losses[-1]):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    ms = ((time.perf_counter() - t_second) * 1e3 / (steps - 1)
          if steps > 1 else float("nan"))
    return model, params, tx, torch.stack(losses), ms, batch0


def holdout_ious(model, params, device, n: int = HOLDOUT) -> list:
    """IoU of the predicted ground on ``n`` held-out batches."""
    out = []
    for s in range(n):
        rgb, gt = make_batch(torch.Generator().manual_seed(HOLDOUT_SEED + s),
                             device)
        out.append(iou(predict_mask(model, params, rgb), gt))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="checkpoint to write (.npz)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(COMMITTED):
        raise SystemExit(f"refusing to overwrite {COMMITTED}")
    model, params, _, _, ms, _ = train(args.steps, args.device, args.seed)
    ious = holdout_ious(model, params, args.device)
    print(f"held-out IoU: {['%.3f' % v for v in ious]} min {min(ious):.3f}; "
          f"{ms:.2f} ms a step")
    save_segnet(args.out, params, meta={
        "image_hw": [H, W], "steps": args.steps,
        "min_holdout_iou": float(min(ious))})
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
