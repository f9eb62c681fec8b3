"""Profile the PyTorch port's main path (or a solver path) on one GPU.

    python3 scripts/profile_torch_port.py [--frames 32] [--repeats 3]
        [--solver gn|lm|dogleg] [--window 8]

Runs a path of ``chip_smoke.py``: 480x640 corridor masks, ``SlamConfig()``
widths (``--window`` poses), every frame a keyframe, chunks of 16; with
``--solver gn`` (the main path) depth is rendered per frame, with ``lm``
or ``dogleg`` it is not, as in ``chip_smoke.py``:

1. ``--repeats`` untraced passes over all 144 frames: frames/s on the
   host clock (each pass ends in ``torch.cuda.synchronize()``);
2. one ``torch.profiler`` pass over ``--frames`` frames: device busy
   share (union of kernel intervals over the window), kernels per frame,
   host syncs per frame (``cudaStreamSynchronize`` calls and
   ``aten::_local_scalar_dense`` reads), the host time of each stage
   (pop-up, detections, slam_step, depth render), and the device time
   per launch of the port's own kernels;
3. where the host syncs come from: the source line of every
   synchronizing call over 4 frames (``torch.cuda.set_sync_debug_mode``);
4. the standalone Cholesky kernel's device time at n=48.

Prints one JSON object per line; the card's ``nvidia-smi`` name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OWN_KERNELS = ("fused_gn_kernel", "depth_render_kernel", "chol_solve_kernel",
               "schur_small_kernel", "schur_gemm_kernel",
               "plane_terms_kernel")


def _device_events(prof):
    """Kernels and copies on the device (not the stage annotations the
    profiler mirrors onto the device timeline)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("stage:")]


def _busy_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--solver", choices=("gn", "lm", "dogleg"), default="gn")
    ap.add_argument("--window", type=int, default=8)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pop_up_slam_tpu_torch  # noqa: F401
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.ops import _build, cholesky
    from pop_up_slam_tpu_torch.pipeline import (
        SlamConfig, offline, run_sequence_chunked, slam_init,
    )
    from pop_up_slam_tpu_torch.popup import popup as pp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.library()

    z = np.load(os.path.join(REPO, "bench_data", "corridor_inputs.npz"))
    n, h, w = z["shape"]
    masks = np.unpackbits(z["masks_packed"], axis=-1)[..., :w].astype(bool)
    masks_d = torch.as_tensor(masks, device="cuda")
    oR, ot = z["odom_R"], z["odom_t"]
    pcfg = pp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0, solver=args.solver,
                      window_size=args.window)
    depth = args.solver == "gn"
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cuda")
    print(json.dumps({"solver": args.solver, "window_size": args.window,
                      "depth": depth}))

    def run(frames):
        st = slam_init(scfg, z["R0"], z["t0"])
        out = run_sequence_chunked(st, masks_d[:frames], oR[:frames],
                                   ot[:frames], K, pcfg, scfg, depth=depth)
        torch.cuda.synchronize()
        return out

    run(16)                                   # warm-up
    fps = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run(n)
        fps.append(n / (time.perf_counter() - t0))
    print(json.dumps({"untraced_passes": len(fps), "frames": int(n),
                      "frames_per_s": fps}))

    # stage ranges around what the frame function calls
    def ranged(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            with record_function("stage:" + name):
                return fn(*a, **k)
        setattr(mod, name, wrapper)
        return fn

    originals = [(offline.pp, "pop_up", ranged(offline.pp, "pop_up")),
                 (offline.pp, "render_depth",
                  ranged(offline.pp, "render_depth")),
                 (offline, "detections_from_popup",
                  ranged(offline, "detections_from_popup")),
                 (offline, "slam_step", ranged(offline, "slam_step"))]
    f = args.frames
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(f)
        wall_s = time.perf_counter() - t0
    for mod, name, fn in originals:
        setattr(mod, name, fn)

    dev = _device_events(prof)
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    first = min(e.time_range.start for e in prof.events())
    last = max(e.time_range.end for e in prof.events())
    cpu = [e for e in prof.events() if e.device_type.name == "CPU"]
    n_sync = sum(e.name == "cudaStreamSynchronize" for e in cpu)
    n_item = sum(e.name == "aten::_local_scalar_dense" for e in cpu)
    stage_us = {}
    for e in cpu:
        if e.name.startswith("stage:"):
            stage_us[e.name[6:]] = stage_us.get(e.name[6:], 0.0) + (
                e.time_range.end - e.time_range.start)
    own = {}
    for e in dev:
        for k in OWN_KERNELS:
            if k in e.name:
                own.setdefault(k, []).append(
                    e.time_range.end - e.time_range.start)
    top = {}
    for e in dev:
        top[e.name] = top.get(e.name, 0.0) + (e.time_range.end
                                              - e.time_range.start)
    top = sorted(top.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "profiled_frames": f,
        "wall_ms_per_frame": wall_s * 1e3 / f,
        "trace_window_ms": (last - first) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / max(last - first, 1e-9),
        "kernels_per_frame": len(dev) / f,
        "stream_syncs_per_frame": n_sync / f,
        "scalar_reads_per_frame": n_item / f,
        "stage_host_ms_per_frame": {k: v / 1e3 / f
                                    for k, v in stage_us.items()},
        "own_kernel_device_ms": {k: float(np.mean(v)) / 1e3
                                 for k, v in own.items()},
        "own_kernel_launches_per_frame": {k: len(v) / f
                                          for k, v in own.items()},
        "top_device_kernels_ms_per_frame": [[k[:80], v / 1e3 / f]
                                            for k, v in top],
    }))

    # where the host syncs come from: PyTorch's sync debug mode warns at
    # every synchronizing call, attributed to the calling source line
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(4)
    torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for wrn in caught:
        if "synchroniz" not in str(wrn.message):
            continue
        key = f"{os.path.relpath(wrn.filename, REPO)}:{wrn.lineno}"
        sites[key] = sites.get(key, 0) + 1
    print(json.dumps({"sync_sites_per_frame": sorted(
        [[k, c / 4] for k, c in sites.items()], key=lambda x: -x[1])}))

    # the standalone Cholesky kernel at the main path's n = 6W = 48
    rng = np.random.default_rng(0)
    A = rng.normal(size=(48, 48)).astype(np.float32)
    S = torch.as_tensor(A @ A.T + 48 * np.eye(48, dtype=np.float32),
                        device="cuda")
    b = torch.as_tensor(rng.normal(size=48).astype(np.float32), device="cuda")
    cholesky.chol_solve(S, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            cholesky.chol_solve(S, b)
        torch.cuda.synchronize()
    ch = [e.time_range.end - e.time_range.start for e in _device_events(prof)
          if "chol_solve_kernel" in e.name]
    print(json.dumps({"chol_solve_kernel_device_ms_n48":
                      float(np.mean(ch)) / 1e3 if ch else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
