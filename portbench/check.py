"""The comparison that decides ``correct``.

The plain reference (``portbench/reference/``) works each checked frame
out again from the same inputs and the program's state before the
frame: the SLAM state carries the whole past, so a free run of the
reference parts from the program where the pop-up flips its branch under
1e-6 m of pose noise; the reference therefore follows the program step
by step.  Each stage is judged by itself:

- pop-up: the reference's pop-up at the pose the program popped up at,
  on the benchmark's own mask, against the program's result;
- frame step (association, store, factors, the windowed solve, the
  marginal): the reference's step from the program's state before the
  frame, on detections made from the program's pop-up and the
  benchmark's own odometry, against the program's state after it and
  its pose;
- depth: the reference's render of the program's pop-up against the
  program's depth map;
- the start: the program's first state against the reference's
  ``slam_init``; the carry: each checked frame step started from the
  state the previous frame step returned.

Every gap is a widest gap over the checked frames.  A number's limit is
in the cell's workload file.
"""

from __future__ import annotations

import contextlib
import math

import torch

from .reference.factors import graph as rgraph
from .reference.factors.robust import RobustConfig, RobustKernel
from .reference.assoc import AssocConfig
from .reference.geometry.camera import Intrinsics
from .reference.mapping import landmark_store as rstore
from .reference.pipeline import slam as rslam
from .reference.popup import popup as rpp

# the depth kernel's tolerance against its plain version (chip_smoke.py)
DEPTH_RTOL, DEPTH_ATOL = 1e-4, 1e-3
# numbers reported beside the compared ones, not held to a limit: a
# rounding tie moves the first two on sound runs, and the control moves
# them no more; the third is what a smoother that returned its input
# would read as ``smooth_gap`` (PERF.md)
INFO = ("popup_columns_moved", "depth_gap", "smooth_unmoved")

REF_TYPES = {
    "SlamState": rslam.SlamState,
    "Window": rgraph.Window,
    "LandmarkStore": rstore.LandmarkStore,
    "PopupPlanes": rpp.PopupPlanes,
    "FrameDetections": rslam.FrameDetections,
    "Intrinsics": Intrinsics,
}


def to_ref(x, dev):
    """A program tensor or NamedTuple of tensors as the reference's type
    on ``dev`` (read only: the reference never writes the program's
    tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        vals = [to_ref(v, dev) for v in x]
        cls = REF_TYPES.get(type(x).__name__)
        return cls(*vals) if cls is not None else type(x)(*vals)
    return x


def slam_config(d: dict) -> rslam.SlamConfig:
    """The reference's SlamConfig from a configuration file's ``slam``."""
    d = dict(d)
    d["assoc"] = AssocConfig(**d["assoc"])
    d["robust"] = RobustConfig(**{k: RobustKernel(**v)
                                  for k, v in d["robust"].items()})
    return rslam.SlamConfig(**d)


def popup_config(d: dict) -> rpp.PopupConfig:
    return rpp.PopupConfig(**d)


def intrinsics(config: dict, dev) -> Intrinsics:
    fx, fy, cx, cy = config["intrinsics"]
    return Intrinsics.create(fx, fy, cx, cy, device=dev)


def _gap(a, b, mask=None) -> float:
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[mask]
    if d.numel() and not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max()) if d.numel() else 0.0


def reference_frame(fr: dict, mask, odom_R, odom_t, K, cfg, pcfg, dev,
                    res_for_backend=None, depth_kw=None) -> dict:
    """The reference's outputs for one frame on ``dev``: its predicted
    pose, its pop-up at the program's pose, its state after the frame
    step from the program's state before it and its pose; the depth map
    when ``depth_kw`` is given.  The frame step's detections and the
    depth come from ``res_for_backend`` (the program's pop-up, as a
    reference type) when given, else from the reference's own pop-up."""
    state_in = to_ref(fr["state_in"], dev)
    pred_R = fr["pred_R"].detach().to(dev)
    pred_t = fr["pred_t"].detach().to(dev)
    mask = mask.to(dev)
    own_R, own_t = rslam.current_pose(state_in)
    res = rpp.pop_up(K, mask, pred_R, pred_t, pcfg)
    use = res if res_for_backend is None else res_for_backend
    det = rslam.detections_from_popup(use, pred_R, pred_t, cfg.max_det)
    state_out, (R, t) = rslam.slam_step(state_in, det, odom_R.to(dev),
                                        odom_t.to(dev), cfg)
    out = {"pred_R": own_R, "pred_t": own_t, "res": res,
           "state_out": state_out, "R": R, "t": t}
    if depth_kw is not None:
        out["depth"] = rpp.depth_from_popup(K, use, mask, pred_R, pred_t,
                                            **depth_kw)
    return out


def program_frame(fr: dict, dev) -> dict:
    """The program's outputs for one frame, as the reference's types."""
    out = {"pred_R": fr["pred_R"], "pred_t": fr["pred_t"],
           "res": fr["res"], "state_out": fr["state_out"], "R": fr["R"],
           "t": fr["t"]}
    if "depth" in fr:
        out["depth"] = fr["depth"]
    return {k: to_ref(v, dev) for k, v in out.items()}


def frame_gaps(p: dict, r: dict) -> dict:
    """Per-frame gaps of the program's (or the control's) outputs ``p``
    from the reference's ``r``."""
    g = {}
    pr, rr = p["res"], r["res"]
    # boundary columns that another wall (or none) took: a column at a
    # corner goes to either wall on a rounding tie (reported, not held)
    g["popup_columns_moved"] = float((pr.seg_id != rr.seg_id).sum())
    # walls that hold the same columns on both sides: their valid flags
    # exactly; where valid on both, their planes, centroids and endpoints
    # (an unordered pair: which end of a wall square to the walk comes
    # first is a tie)
    S = pr.valid.shape[0]
    slots = torch.arange(S, dtype=pr.seg_id.dtype, device=pr.seg_id.device)
    same_cols = ((pr.seg_id[None, :] == slots[:, None])
                 == (rr.seg_id[None, :] == slots[:, None])).all(1)
    g["popup_walls_differ"] = float(bool(
        (same_cols & (pr.valid != rr.valid)).any()))
    both = pr.valid & rr.valid & same_cols
    ends = 0.0
    for k in torch.nonzero(both).flatten().tolist():
        ends = max(ends, min(_gap(pr.endpoints_w[k], rr.endpoints_w[k]),
                             _gap(pr.endpoints_w[k],
                                  rr.endpoints_w[k].flip(0))))
    g["popup_gap"] = max(
        _gap(pr.planes_c, rr.planes_c, both),
        _gap(pr.planes_w, rr.planes_w, both),
        _gap(pr.centroid_c, rr.centroid_c, both), ends,
        _gap(pr.ground_c, rr.ground_c))
    ps, rs = p["state_out"], r["state_out"]
    same = all(torch.equal(a, b) for a, b in (
        (ps.n_kf, rs.n_kf), (ps.frame, rs.frame),
        (ps.n_overflow, rs.n_overflow), (ps.pf_valid, rs.pf_valid),
        (ps.store.valid, rs.store.valid), (ps.store.n_obs, rs.store.n_obs),
        (ps.store.created_kf, rs.store.created_kf),
        (ps.window.lm_valid, rs.window.lm_valid),
        (ps.window.pose_valid, rs.window.pose_valid),
        (ps.odom_valid, rs.odom_valid)))
    same = same and torch.equal(ps.pf_lm[rs.pf_valid], rs.pf_lm[rs.pf_valid])
    g["decisions_differ"] = float(not same)
    pv = rs.window.pose_valid
    g["pose_gap"] = max(
        _gap(p["pred_R"], r["pred_R"]), _gap(p["pred_t"], r["pred_t"]),
        _gap(ps.window.R, rs.window.R, pv), _gap(ps.window.t, rs.window.t, pv),
        _gap(p["R"], r["R"]), _gap(p["t"], r["t"]),
        _gap(ps.acc_R, rs.acc_R), _gap(ps.acc_t, rs.acc_t),
        _gap(ps.mprior_R, rs.mprior_R), _gap(ps.mprior_t, rs.mprior_t))
    lv = rs.window.lm_valid
    sv = rs.store.valid
    g["map_gap"] = max(_gap(ps.window.planes, rs.window.planes, lv),
                       _gap(ps.store.endpoints_w, rs.store.endpoints_w, sv),
                       _gap(ps.pf_pi, rs.pf_pi, rs.pf_valid))
    scale = rs.mprior_sqrt.abs().max().clamp(min=1.0)
    g["marginal_gap"] = _gap(ps.mprior_sqrt / scale, rs.mprior_sqrt / scale)
    if "depth" in r and "depth" in p:
        # pixels off by more than the depth kernel's own tolerance: a
        # pixel on a wall's edge flips between the wall and what lies
        # behind it on a rounding tie
        d = (p["depth"].double() - r["depth"].double()).abs()
        off = ~(d <= DEPTH_ATOL + DEPTH_RTOL * r["depth"].double().abs())
        g["depth_pixels_off"] = float(off.sum())
        g["depth_gap"] = _gap(p["depth"], r["depth"])
    return g


def start_gap(state, R0, t0, cfg, dev) -> float:
    """Widest gap of the program's first state from the reference's
    ``slam_init`` (booleans and integers count as 0 or inf)."""
    ref = rslam.slam_init(cfg, R0.to(dev), t0.to(dev), device=dev)
    prog = to_ref(state, dev)
    worst = 0.0
    for a, b in zip(_leaves(prog), _leaves(ref)):
        if a.dtype.is_floating_point:
            worst = max(worst, _gap(a, b))
        elif not torch.equal(a, b):
            worst = math.inf
    return worst


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for v in x:
        out += _leaves(v)
    return out


def merge(per_frame: list) -> dict:
    """Per-frame gaps -> the run's numbers: the widest gap, or the count
    of frames for the ``*_differ`` flags."""
    out = {}
    for g in per_frame:
        for k, v in g.items():
            if k.endswith("_differ"):
                out[k] = out.get(k, 0.0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


@contextlib.contextmanager
def tf32():
    """The control's precision: float32 matmuls and convolutions in
    TF32, the nearest precision below the configuration's float32 with
    TF32 off."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    b.cuda.matmul.allow_tf32 = True
    b.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def cpu_outputs(out: dict) -> dict:
    return {k: to_ref(v, torch.device("cpu")) for k, v in out.items()}


def carry_differs(prev_out, state_in) -> bool:
    """Whether a frame step started from anything but the state the
    previous frame step returned (compared leaf by leaf, exactly)."""
    a, b = _leaves(prev_out), _leaves(state_in)
    return len(a) != len(b) or not all(
        x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(a, b))
