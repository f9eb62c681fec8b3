"""CLI entry point: ``python -m pop_up_slam_tpu_torch.cli run --config
<preset>``.

Port of ``pop_up_slam_tpu/cli.py``: runs one of the five presets end to
end, prints the summary as JSON, optionally writes a TUM-format
trajectory and a metrics JSONL.  Modes: ``popup_demo`` (one rendered
frame popped up, its depth rendered), ``synthetic`` (the ``corridor``
preset: the SLAM step over simulated plane observations) and ``tum`` (a
TUM sequence, ``runners.tum_runner``) and ``distributed``
(``single_host``, ``multi_host``: the sharded runner,
``pipeline/sharded.py``, over a rendered corridor, one process per
device: alone as a world of one, or under ``torchrun --nproc_per_node=N
-m pop_up_slam_tpu_torch.cli run --config single_host``).

Everything runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _run_popup_demo(cfg, args, dev):
    import numpy as np
    import torch

    from .geometry.camera import Intrinsics
    from .io import synthetic
    from .popup import popup as pp

    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device=dev)
    world = synthetic.corridor_world(device=dev)
    R, t = synthetic.corridor_trajectory(1, device=dev)
    labels, depth_gt = synthetic.render_frame(K, R[0], t[0], world,
                                              cfg.height, cfg.width)
    mask = labels == synthetic.LABEL_GROUND
    t0 = time.perf_counter()
    res = pp.pop_up(K, mask, R[0], t[0], cfg.popup)
    depth = pp.render_depth(K, res, mask, R[0], t[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    gt = depth_gt.cpu().numpy()
    d = depth.cpu().numpy()
    m = gt < 40
    rel = np.abs(d[m] - gt[m]) / gt[m]
    print(json.dumps({
        "config": cfg.name,
        "n_wall_planes": int(res.valid.sum()),
        "depth_median_rel_err": float(np.median(rel)),
        "depth_p95_rel_err": float(np.percentile(rel, 95)),
        "wall_s_first_frame": round(dt, 3),
    }, indent=2))
    return 0


def _run_synthetic(cfg, args, dev):
    import numpy as np
    import torch

    from .evaluation import ate_rmse
    from .io import synthetic
    from .pipeline import FrameDetections, slam_init, slam_step
    from .utils import MetricsLogger

    scfg = cfg.slam
    world = synthetic.corridor_world(device=dev)
    gt_R, gt_t = synthetic.corridor_trajectory(cfg.n_frames, sway=0.3,
                                               device=dev)
    # the noise is drawn on the host from a generator seeded by cfg.seed
    # (the reference draws from jax.random: the numbers differ)
    gen = torch.Generator().manual_seed(cfg.seed)
    Rrel, trel = synthetic.noisy_odometry(
        gt_R, gt_t, generator=gen, sigma_t=cfg.odom_sigma_t,
        sigma_r=cfg.odom_sigma_r)

    state = slam_init(scfg, gt_R[0], gt_t[0], device=dev)
    logger = MetricsLogger(cfg.metrics_path or None)
    est = [gt_t[0].cpu().numpy()]
    stamps = [0.0]
    t_start = time.perf_counter()
    for i in range(1, cfg.n_frames):
        o = synthetic.observe_frame(world, gt_R[i], gt_t[i],
                                    max_det=scfg.max_det)
        det = FrameDetections(o.planes_c, o.centroid_c, o.endpoints_c,
                              o.valid)
        state, (R, t) = slam_step(state, det, Rrel[i - 1], trel[i - 1],
                                  scfg)
        est.append(t.cpu().numpy())
        stamps.append(i / 30.0)
        logger.log(frame=i, n_kf=int(state.n_kf),
                   n_landmarks=int(state.window.lm_valid.sum()))
    wall = time.perf_counter() - t_start

    ate, _, _ = ate_rmse(gt_t.cpu().numpy(), np.stack(est))
    summary = {
        "config": cfg.name,
        "frames": cfg.n_frames,
        "ate_rmse_m": round(float(ate), 4),
        "n_keyframes": int(state.n_kf),
        "n_landmarks": int(state.window.lm_valid.sum()),
        "frames_per_s": round((cfg.n_frames - 1) / wall, 2),
    }
    print(json.dumps(summary, indent=2))
    if cfg.out_trajectory:
        from .io import tum

        R_eye = np.broadcast_to(np.eye(3), (len(est), 3, 3))
        tum.write_trajectory(cfg.out_trajectory, stamps, R_eye,
                             np.stack(est))
    logger.close()
    return 0


def _run_tum(cfg, args, dev):
    if not os.path.isdir(cfg.sequence_dir):
        print(
            f"TUM sequence not found at '{cfg.sequence_dir}'.\n"
            "Download rgbd_dataset_freiburg3_structure_notexture_far "
            "from the TUM RGB-D benchmark and point --sequence-dir at it.",
            file=sys.stderr,
        )
        return 2
    from .runners import tum_runner

    summary = tum_runner.run_tum_sequence(
        cfg, odometry=args.odometry, smooth=not args.no_smooth,
        device=dev)
    print(json.dumps(summary, indent=2))
    return 0


def _sharded_corridor(cfg, dev):
    """The body of :func:`_run_distributed`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .evaluation import ate_rmse
    from .geometry.camera import Intrinsics
    from .io import synthetic
    from .parallel import flat_mesh_axis, make_host_mesh, make_mesh
    from .pipeline import run_sequence_sharded, slam_init

    n_ask = cfg.n_devices or None
    mesh = make_mesh(n_ask, device=dev)
    if cfg.name == "multi_host":
        make_host_mesh()
        mesh = flat_mesh_axis()
    n_dev = dist.get_world_size()
    # block = frames per dispatch; every rank pops up block / n of them
    block = max(n_dev, (16 // n_dev) * n_dev)

    scfg = cfg.slam
    H, W = cfg.height, cfg.width
    K = Intrinsics.create(0.5 * W, 0.5 * W, 0.5 * W, 0.5 * H, device=dev)
    world = synthetic.corridor_world(device=dev)
    n = (cfg.n_frames // block) * block + 1
    gt_R, gt_t = synthetic.corridor_trajectory(n, device=dev)
    masks = torch.stack([
        synthetic.render_frame(K, gt_R[i], gt_t[i], world, H, W)[0]
        for i in range(1, n)]) == synthetic.LABEL_GROUND
    # the noise is drawn on the host from a generator seeded by cfg.seed
    # (the reference draws from jax.random: the numbers differ)
    gen = torch.Generator().manual_seed(cfg.seed)
    oR, ot = synthetic.noisy_odometry(gt_R, gt_t, generator=gen,
                                      sigma_t=cfg.odom_sigma_t,
                                      sigma_r=cfg.odom_sigma_r)

    state = slam_init(scfg, gt_R[0], gt_t[0], device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    state, (R_est, t_est) = run_sequence_sharded(
        state, masks, oR, ot, K, cfg.popup, scfg, mesh, block=block)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start

    t_np = t_est.cpu().numpy()
    ate, _, _ = ate_rmse(gt_t[1:len(t_np) + 1].cpu().numpy(), t_np)
    summary = {
        "config": cfg.name,
        "mode": "distributed",
        "n_devices": n_dev,
        "block": block,
        "frames": int(t_np.shape[0]),
        "ate_rmse_m": round(float(ate), 4),
        "n_keyframes": int(state.n_kf),
        "n_landmarks": int(state.window.lm_valid.sum()),
        "frames_per_s": round(t_np.shape[0] / wall, 2),
        "finite": bool(np.isfinite(t_np).all()),
    }
    if dist.get_rank() == 0:
        print(json.dumps(summary, indent=2))
        if cfg.out_trajectory:
            from .io import tum

            tum.write_trajectory(cfg.out_trajectory,
                                 [i / 30.0 for i in range(t_np.shape[0])],
                                 R_est.cpu().numpy(), t_np)
    return 0 if summary["finite"] else 1


def _run_distributed(cfg, args, dev):
    """The distributed runner (``pipeline/sharded.py``) over a rendered
    480x640 synthetic corridor: the pop-up data-parallel across the
    ranks, the factor-sharded BA summed by one ``all_reduce`` a GN
    iteration.  Every rank runs the same frames; rank 0 prints the
    summary and writes the trajectory.  ``multi_host`` brings the group
    up as ``single_host`` does (``make_mesh``: ``init_distributed`` on
    ``torchrun``'s environment), builds the (hosts, ranks per host) mesh
    and runs over its flattened axis; without a launcher either preset
    runs as a world of one."""
    import torch.distributed as dist

    from .parallel.multihost import rank_device

    started_here = not dist.is_initialized()
    try:
        return _sharded_corridor(cfg, rank_device(dev))
    finally:
        # a process group this call started ends with it
        if started_here and dist.is_initialized():
            dist.destroy_process_group()


_MODES = {
    "popup_demo": _run_popup_demo,
    "synthetic": _run_synthetic,
    "tum": _run_tum,
    "distributed": _run_distributed,
}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="pop_up_slam_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run a preset end-to-end")
    runp.add_argument("--config", default="corridor",
                      help="preset: popup_demo|corridor|tum_fr3|"
                           "single_host|multi_host")
    runp.add_argument("--device", default="cuda",
                      help="torch device to run on (cuda, cuda:1, cpu)")
    runp.add_argument("--frames", type=int, default=0)
    runp.add_argument("--height", type=int, default=0)
    runp.add_argument("--width", type=int, default=0)
    runp.add_argument("--intrinsics", type=float, nargs=4, default=None,
                      metavar=("FX", "FY", "CX", "CY"),
                      help="camera intrinsics (default: the preset's)")
    runp.add_argument("--devices", type=int, default=0,
                      help="mesh size for distributed mode (0 = all)")
    runp.add_argument("--sequence-dir", default="")
    runp.add_argument("--out-trajectory", default="")
    runp.add_argument("--metrics", default="")
    runp.add_argument("--profile-dir", default="",
                      help="write a torch.profiler trace (chrome JSON) "
                           "of the run here")
    runp.add_argument("--checkpoint", default="",
                      help="snapshot solver state to this .npz")
    runp.add_argument("--checkpoint-every", type=int, default=0,
                      help="also snapshot every N frames (0 = end only)")
    runp.add_argument("--resume", default="",
                      help="restore a --checkpoint snapshot and continue")
    runp.add_argument("--odometry", default="gt_perturb",
                      choices=["gt_perturb", "constant_velocity",
                               "plane_vo"],
                      help="pose-prior source for TUM runs "
                           "(plane_vo = fully monocular)")
    runp.add_argument("--no-smooth", action="store_true",
                      help="skip the final full-trajectory smoothing "
                           "(publish the filtering path)")
    args = parser.parse_args(argv)

    from ._device import resolve_device
    from .config import get_config

    overrides = {}
    for flag, field in (("frames", "n_frames"), ("height", "height"),
                        ("width", "width"), ("devices", "n_devices"),
                        ("sequence_dir", "sequence_dir"),
                        ("out_trajectory", "out_trajectory"),
                        ("metrics", "metrics_path"),
                        ("profile_dir", "profile_dir"),
                        ("checkpoint", "checkpoint_path"),
                        ("checkpoint_every", "checkpoint_every"),
                        ("resume", "resume")):
        if getattr(args, flag):
            overrides[field] = getattr(args, flag)
    if args.intrinsics:
        overrides.update(zip(("fx", "fy", "cx", "cy"), args.intrinsics))
    cfg = get_config(args.config, **overrides)
    run = _MODES.get(cfg.mode)
    if run is None:
        raise SystemExit(f"unknown mode {cfg.mode}")
    dev = resolve_device(args.device)
    if not cfg.profile_dir:
        return run(cfg, args, dev)

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(cfg.profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        rc = run(cfg, args, dev)
    prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
