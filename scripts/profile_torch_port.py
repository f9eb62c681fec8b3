"""Profile the PyTorch port's main path (or a solver path) on one GPU.

    python3 scripts/profile_torch_port.py [--frames 32] [--repeats 3]
        [--solver gn|lm|dogleg] [--window 8] [--path odom|vo|fused_vo]

Runs a path of ``chip_smoke.py``: 480x640 corridor masks, ``SlamConfig()``
widths (``--window`` poses), every frame a keyframe, chunks of 16; with
``--solver gn`` (the main path) depth is rendered per frame, with ``lm``
or ``dogleg`` it is not, as in ``chip_smoke.py``.  ``--path vo`` and
``--path fused_vo`` run the monocular runners instead (no odometry input:
``make_chunked_vo_runner`` / ``make_chunked_fused_vo_runner`` through
``run_masks_chunked``, GN), with the plane-VO step and the fusion
functions as stages of their own:

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
4. the kernel section (``--kernels-only`` runs it alone; not after a
   ``--path vo|fused_vo`` profile): K1's phase
   split on the chip-smoke state (24 frames in, window full, marginal
   on), from the kernel's ``%globaltimer`` stamps averaged over
   ``--launches`` launches; K1's CUDA-event time per launch; K3a's phase
   split (observer sets, product, damping and mask, Cholesky) from its
   stamps on that state's LM system (lambda 1e-5), its CUDA-event and
   device time; K2's CUDA-event and device time per launch on the
   480x640 frames 0, 40, 80, 120; K5's phase split (loads, compute,
   stores) from its stamps on that state's 72 plane factors; then the
   library section: the launch floor (the device time of a 1-element
   ``add_``), K3b beside
   ``torch.addmm(Hpp, B, G.T, alpha=-1)`` and K5 on
   ``chip_smoke.random_system`` at W=24 and W=40 (L=64), and K4
   (``--chol-n``, default 48,144,384) beside ``torch.linalg.cholesky`` +
   ``cholesky_solve`` and ``cholesky_ex`` + ``cholesky_solve``.  Every
   call there gets its device time (every device activity of the call,
   kernels, copies and memsets, summed per call by the profiler), each
   activity's share, and its CUDA-event time (the mean of ``--launches`` back-to-back calls, which
   is host-bound for calls this small).

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
               "plane_terms_kernel", "lm_assemble_kernel", "lm_trial_kernel",
               "marginal_kernel")


def _device_events(prof):
    """Kernels and copies on the device (not the stage annotations the
    profiler mirrors onto the device timeline)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("stage:")]


K1_PHASES = ("linearize", "gather", "B", "S", "cholesky",
             "back_substitution", "sanitize", "retract")


def _event_ms(torch, fn, n: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def kernel_section(args, torch, z, masks, gpu: str) -> None:
    """The kernels' phase splits and device times, and the library
    section (see above)."""
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.ops import fused_gn
    from pop_up_slam_tpu_torch.pipeline import (
        SlamConfig, run_sequence_chunked, slam_init,
    )
    from pop_up_slam_tpu_torch.pipeline import slam as slam_mod
    from pop_up_slam_tpu_torch.popup import popup as pp

    def to(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple):
            return type(x)(*(to(v, dev) for v in x))
        return x

    pcfg = pp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0)
    st = slam_init(scfg, z["R0"], z["t0"], device="cpu")
    st, _ = run_sequence_chunked(
        st, masks[:24], z["odom_R"][:24], z["odom_t"][:24],
        Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cpu"), pcfg,
        scfg)
    st = to(st, "cuda")
    factors = slam_mod._build_factors(st, scfg)
    w0 = st.window
    marg = fused_gn.pack_marg(
        w0.R[0], w0.t[0], w0.R[1], w0.t[1], st.odom_R[0], st.odom_t[0],
        st.odom_valid[0], st.mprior_R, st.mprior_t, st.mprior_sqrt,
        st.n_kf >= scfg.window_size)
    kw = dict(iters=scfg.gn_iters, damping=scfg.damping, robust=scfg.robust,
              marg=marg, marg_static=slam_mod._marg_static(scfg))
    n_l = args.launches
    k1_split(torch, fused_gn, w0, factors, kw, n_l, scfg)
    k3a_split(torch, st, factors, scfg, n_l)
    k2_device(torch, z, masks, n_l)
    k5_split(torch, w0, factors.planes, n_l, gpu)
    library_section(torch, [int(v) for v in args.chol_n.split(",") if v],
                    n_l, gpu)


def _kernels_us(torch, fn, n: int) -> dict:
    """Device time (us) per call of each device activity of ``fn``
    (kernels, copies, memsets), by name, from the profiler over ``n``
    calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in _device_events(prof):
        out[e.name] = out.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / n
    return out


def _device_us(torch, fn, n: int, name: str) -> float:
    """Mean device time (us) per call of the kernels whose name holds
    ``name`` ("" for all)."""
    return float(sum(v for k, v in _kernels_us(torch, fn, n).items()
                     if name in k))


def _call_row(torch, what: str, fn, n_l: int, gpu: str, **shape) -> dict:
    """One call's device time (all its device activities, summed), each
    activity's share and its CUDA-event time."""
    by_kernel = _kernels_us(torch, fn, 50)
    return {"call": what, **shape, "device_us": float(sum(by_kernel.values())),
            "device_us_by_kernel": {k[:60]: v for k, v in by_kernel.items()},
            "event_ms": _event_ms(torch, fn, n_l), "card": gpu}


def library_section(torch, chol_ns, n_l: int, gpu: str) -> None:
    """The launch floor; K3b against ``addmm`` and K5 on random systems at W=24 and W=40; K4
    against the two Cholesky library routes."""
    from chip_smoke import random_system
    from pop_up_slam_tpu_torch.factors import graph
    from pop_up_slam_tpu_torch.ops import cholesky, schur
    from pop_up_slam_tpu_torch.ops import plane_jacobians as pj

    x = torch.zeros(1, device="cuda")
    print(json.dumps(_call_row(torch, "launch floor: 1-element add_",
                               lambda: x.add_(1.0), n_l, gpu)))
    for W, L, F in ((24, 64, 216), (40, 64, 240)):
        window, factors = random_system(torch, W, L, F, 11, "cuda")
        lin = graph.linearize(window, factors, analytic_planes=True)
        lam = torch.full((), 1e-3, device="cuda")
        _, B, G, Hpp, _, _ = schur.reduce_operands(lin, window, lam)
        n, C = B.shape
        for what, fn in (
                ("K3b schur_gemm", lambda: schur.schur_gemm(Hpp, B, G)),
                ("addmm(Hpp, B, G.T, alpha=-1)",
                 lambda: torch.addmm(Hpp, B, G.T, alpha=-1)),
                ("K5 plane_terms",
                 lambda: pj.plane_terms(window, factors.planes))):
            print(json.dumps(_call_row(torch, what, fn, n_l, gpu, W=W, L=L,
                                       n=n, C=C, F=F)))
    rng = np.random.default_rng(0)
    for n in chol_ns:
        A = rng.normal(size=(n, n)).astype(np.float32)
        S = torch.as_tensor(A @ A.T + n * np.eye(n, dtype=np.float32),
                            device="cuda")
        b = torch.as_tensor(rng.normal(size=n).astype(np.float32),
                            device="cuda")
        for what, fn in (
                ("K4 chol_solve", lambda: cholesky.chol_solve(S, b)),
                ("cholesky + cholesky_solve", lambda: torch.cholesky_solve(
                    b[:, None], torch.linalg.cholesky(S))),
                ("cholesky_ex + cholesky_solve",
                 lambda: torch.cholesky_solve(
                     b[:, None], torch.linalg.cholesky_ex(S)[0]))):
            print(json.dumps(_call_row(torch, what, fn, n_l, gpu, n=n)))


K5_PHASES = ("loads", "compute", "stores")


def k5_split(torch, window, pf, n_l, gpu: str) -> None:
    """K5's phase split (stamps), CUDA-event and device time on the
    state's plane factors."""
    from pop_up_slam_tpu_torch.ops import plane_jacobians as pj

    stamps = torch.zeros((n_l, pj.N_STAMPS), dtype=torch.int64,
                         device="cuda")
    pj.plane_terms(window, pf)
    for r in range(n_l):
        pj.plane_terms(window, pf, stamps=stamps[r])
    torch.cuda.synchronize()
    d = stamps.diff(dim=1).double().mean(0).cpu().numpy() / 1e3
    row = _call_row(torch, "K5 plane_terms",
                    lambda: pj.plane_terms(window, pf), n_l, gpu,
                    F=int(pf.valid.shape[0]))
    row.update(k5_phase_us=dict(zip(K5_PHASES, map(float, d))),
               k5_stamped_total_us=float(d.sum()))
    print(json.dumps(row))


K3A_PHASES = ("observer_sets", "product", "damp_mask", "cholesky")


def k3a_split(torch, st, factors, scfg, n_l) -> None:
    """K3a's phase split (stamps), CUDA-event and device time on the LM
    path's system at this state."""
    from pop_up_slam_tpu_torch.factors import graph
    from pop_up_slam_tpu_torch.ops import schur

    lin = graph.linearize(st.window, factors, analytic_planes=True,
                          robust=scfg.robust)
    lam = torch.full((), 1e-5, device="cuda")
    _, B, G, Hpp, pm, rp = schur.reduce_operands(lin, st.window, lam)
    rhs = -rp
    n, C = B.shape

    def launch(stamp=None):
        schur.schur_reduce_small(Hpp, B, G, rhs, pm, lam, stamps=stamp)
    stamps = torch.zeros((n_l, schur.N_SMALL_STAMPS), dtype=torch.int64,
                         device="cuda")
    launch()
    for r in range(n_l):
        launch(stamps[r])
    torch.cuda.synchronize()
    d = stamps.diff(dim=1).double().mean(0).cpu().numpy() / 1e3
    print(json.dumps({
        "n": n, "C": C,
        "k3a_phase_us": dict(zip(K3A_PHASES, map(float, d))),
        "k3a_stamped_total_us": float(d.sum()),
        "k3a_event_ms": _event_ms(torch, launch, n_l),
        "k3a_device_us": _device_us(torch, launch, 50,
                                    "schur_small_kernel")}))


def k2_device(torch, z, masks, n_l) -> None:
    """K2's CUDA-event time and device time per launch on the 480x640
    pop-ups of frames 0, 40, 80, 120 at the reference poses."""
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.ops import depth_render
    from pop_up_slam_tpu_torch.popup import popup as pp

    ref = np.load(os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                               "corridor_ref.npz"))
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cuda")
    for i in (0, 40, 80, 120):
        m = torch.as_tensor(masks[i], device="cuda")
        R = torch.as_tensor(ref["R"][i], device="cuda")
        t = torch.as_tensor(ref["t"][i], device="cuda")
        res = pp.pop_up(K, m, R, t, pp.PopupConfig())

        def launch():
            return depth_render.depth_render(K, res, m, R, t)
        print(json.dumps({
            "k2_frame": i, "k2_event_ms": _event_ms(torch, launch, n_l),
            "k2_device_us": _device_us(torch, launch, 50,
                                       "depth_render_kernel")}))


def k1_split(torch, fused_gn, w0, factors, kw, n_l, scfg) -> None:
    """K1's phase split and CUDA-event time."""
    stamps = torch.zeros((n_l, fused_gn.n_stamps(scfg.gn_iters)),
                         dtype=torch.int64, device="cuda")
    fused_gn.fused_gn_solve(w0, factors, **kw)
    for r in range(n_l):
        fused_gn.fused_gn_solve(w0, factors, **kw, stamps=stamps[r])
    torch.cuda.synchronize()
    d = stamps.diff(dim=1).double().mean(0).cpu().numpy() / 1e3   # us
    phases = {"load": float(d[0]), "marginal": float(d[1])}
    for it in range(scfg.gn_iters):
        for k, name in enumerate(K1_PHASES):
            phases[f"it{it}_{name}"] = float(d[2 + 8 * it + k])
    per_kind = {name: float(sum(d[2 + 8 * it + k]
                                for it in range(scfg.gn_iters)))
                for k, name in enumerate(K1_PHASES)}
    print(json.dumps({
        "k1_phase_us": phases, "k1_phase_us_all_iters": per_kind,
        "k1_stamped_total_us": float(stamps[:, -1].sub(stamps[:, 0])
                                     .double().mean()) / 1e3,
        "k1_event_ms": _event_ms(torch, lambda: fused_gn.fused_gn_solve(
            w0, factors, **kw), n_l),
        "launches": n_l, "W": scfg.window_size,
        "L": int(w0.max_landmarks)}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--solver", choices=("gn", "lm", "dogleg"), default="gn")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--chol-n", default="48,144,384")
    ap.add_argument("--path", choices=("odom", "vo", "fused_vo"),
                    default="odom")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pop_up_slam_tpu_torch  # noqa: F401
    from pop_up_slam_tpu_torch import fusion
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.ops import _build
    from pop_up_slam_tpu_torch.pipeline import (
        SlamConfig, offline, run_sequence_chunked, slam_init,
    )
    from pop_up_slam_tpu_torch.popup import popup as pp

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
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
    depth = args.solver == "gn" and args.path != "vo"
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cuda")
    if args.kernels_only:
        kernel_section(args, torch, z, masks, gpu)
        return 0
    print(json.dumps({"path": args.path, "solver": args.solver,
                      "window_size": args.window, "depth": depth}))

    def run(frames):
        st = slam_init(scfg, z["R0"], z["t0"])
        if args.path == "odom":
            out = run_sequence_chunked(st, masks_d[:frames], oR[:frames],
                                       ot[:frames], K, pcfg, scfg,
                                       depth=depth)
        elif args.path == "vo":
            out = offline.run_masks_chunked(
                offline.make_chunked_vo_runner(K, pcfg, scfg),
                offline.vo_init(st, scfg.max_det), masks_d[:frames])
        else:
            out = offline.run_masks_chunked(
                offline.make_chunked_fused_vo_runner(K, pcfg, scfg),
                offline.fused_vo_init(st, scfg.max_det, h, w),
                masks_d[:frames])
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
                 (offline, "slam_step", ranged(offline, "slam_step")),
                 (offline, "plane_vo_step",
                  ranged(offline, "plane_vo_step"))]
    originals += [(fusion, name, ranged(fusion, name))
                  for name in ("propagate_to_frame", "init_from_popup",
                               "fuse_observation")]
    f = args.frames
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(f)
        wall_s = time.perf_counter() - t0
    for mod, name, fn in originals:
        setattr(mod, name, fn)

    from portbench.trace import busy_us

    dev = _device_events(prof)
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
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
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / max(last - first, 1e-9),
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

    if args.path == "odom":     # the monocular paths run the same kernels
        kernel_section(args, torch, z, masks, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
