"""The port's TUM entry point against the JAX package on the CPU: the
evaluation, the TUM I/O and its PNG codec, the synthetic world, the
fixture writer, the classical segmenter, checkpoints, the presets, the
runner and the CLI.

Inputs: the reference's own ``write_tum_fixture`` tree (120x160, 12
frames) and ``tests/test_tum_runner.py``'s runner widths (W=4, L=32,
``gn_iters=3``, ``kf_trans = kf_rot = 0.05``).

- ``ate_rmse`` / ``horn_align`` (with and without scale) at 1e-6,
  ``associate`` and ``rpe`` exactly / at 1e-6;
- the TUM index parse and ``gt_poses_at`` exactly; every PNG of the
  tree decodes to the reference loader's array exactly; the codec
  round-trips 8-bit gray, 8-bit RGB and 16-bit gray exactly and reads
  each of the five row filters;
- ``render_frame`` labels exactly and depth at 1e-5 relative on the
  same poses; the trajectories at 1e-6 (``jnp.linspace``'s XLA division
  parts from IEEE in the last bit); ``render_rgb``, ``observe_frame``
  and ``noisy_odometry`` given the reference's ``jax.random`` draws at
  1e-6;
- ``classical_ground_mask`` on the tree's RGB frames;
- the runner, ``gt_perturb`` (smoothed) and ``constant_velocity``: the
  summary's ``n_keyframes``, ``lm_overflow``, ``frames`` and both ATEs
  equal as printed (4 decimals), the marginal standard deviations within
  1e-3 relative (the port forms them in f64, the reference in f32), the
  written trajectory within 1e-3 m, the metrics stream one line a frame;
  resuming from a mid-run checkpoint gives the uninterrupted run's
  trajectory exactly (the port against itself);
- the presets field by field; the CLI's ``popup_demo`` mode against the
  reference CLI's summary (recorded in ``corridor_ref_tum.npz``), its
  ``tum`` mode, and the ``distributed`` presets refusing more devices
  than the process group has.

The reference runner is run once per odometry mode in a module fixture,
with its linearization, marginals and smoother solve compiled by
``jax.jit`` (it calls them eagerly: minutes of per-op dispatch here).
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, REPO, assert_close, ground_mask_ties
from pop_up_slam_tpu import config as jconfig
from pop_up_slam_tpu import solver as jsolver
from pop_up_slam_tpu.evaluation import ate as jate
from pop_up_slam_tpu.factors import graph as jgraph
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.io import synthetic as jsyn
from pop_up_slam_tpu.io import tum as jtum
from pop_up_slam_tpu.io.tum_fixture import write_tum_fixture as jfixture
from pop_up_slam_tpu.models import segmentation as jseg
from pop_up_slam_tpu.pipeline import smoothing as jsm
from pop_up_slam_tpu.popup.popup import PopupConfig as JPC
from pop_up_slam_tpu.runners import tum_runner as jrunner
from pop_up_slam_tpu_torch import cli as tcli
from pop_up_slam_tpu_torch import config as tconfig
from pop_up_slam_tpu_torch.evaluation import ate as tate
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.io import png
from pop_up_slam_tpu_torch.io import synthetic as tsyn
from pop_up_slam_tpu_torch.io import tum as ttum
from pop_up_slam_tpu_torch.io.tum_fixture import write_tum_fixture
from pop_up_slam_tpu_torch.models import classical_ground_mask
from pop_up_slam_tpu_torch.pipeline import SlamConfig, slam_init
from pop_up_slam_tpu_torch.popup.popup import PopupConfig as TPC
from pop_up_slam_tpu_torch.runners import tum_runner as trunner
from pop_up_slam_tpu_torch.utils import load_state, save_state

N_FRAMES = 12
H, W = 120, 160
TRAJ_TOL = 1e-3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tum_tree"))
    return root, jfixture(root, n_frames=N_FRAMES)


def _cfg(get, popup_cls, root, meta, out_dir):
    cfg = get("tum_fr3", sequence_dir=root, fx=meta["fx"], fy=meta["fy"],
              cx=meta["cx"], cy=meta["cy"], height=meta["height"],
              width=meta["width"])
    slam = cfg.slam._replace(window_size=4, max_landmarks=32,
                             kf_trans=0.05, kf_rot=0.05, gn_iters=3)
    return cfg._replace(
        slam=slam, popup=popup_cls(min_cols=6, smooth_radius=2,
                                   nms_radius=4),
        out_trajectory=os.path.join(out_dir, "traj.txt"),
        metrics_path=os.path.join(out_dir, "metrics.jsonl"))


def _jax_cfg(tree, out_dir):
    return _cfg(jconfig.get_config, JPC, tree[0], tree[1], out_dir)


def _port_cfg(tree, out_dir):
    return _cfg(tconfig.get_config, TPC, tree[0], tree[1], out_dir)


ODOMETRY = ("gt_perturb", "constant_velocity")


@pytest.fixture(scope="module")
def reference_runs(tree, tmp_path_factory):
    """The reference runner's summary, trajectory and metrics per mode."""
    patched = [(jgraph, "linearize", jax.jit(jgraph.linearize)),
               (jsolver, "recover_marginals",
                jax.jit(jsolver.recover_marginals)),
               (jsm, "gn_solve", jax.jit(jsm.gn_solve, static_argnames=(
                   "iters", "solve_fn", "analytic_planes", "robust")))]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patched]
    runs = {}
    try:
        for m, name, f in patched:
            setattr(m, name, f)
        for odo in ODOMETRY:
            out = str(tmp_path_factory.mktemp(f"ref_{odo}"))
            cfg = _jax_cfg(tree, out)
            summary = jrunner.run_tum_sequence(cfg, odometry=odo)
            with open(cfg.metrics_path) as f:
                metrics = [json.loads(line) for line in f]
            runs[odo] = (summary, jtum.read_trajectory(cfg.out_trajectory),
                         metrics)
    finally:
        for m, name, f in saved:
            setattr(m, name, f)
    return runs


# ---- evaluation ----

@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_matches_reference(with_scale):
    rng = np.random.default_rng(3)
    gt = rng.normal(size=(50, 3))
    est = 0.9 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.01 * \
        rng.normal(size=(50, 3)) + 1.0
    a = tate.ate_rmse(gt, est, with_scale=with_scale)
    b = jate.ate_rmse(gt, est, with_scale=with_scale)
    assert np.isfinite(a[0])
    np.testing.assert_allclose(a[0], b[0], atol=1e-6)
    np.testing.assert_allclose(a[1], b[1], atol=1e-6)
    for x, y in zip(tate.horn_align(est, gt, with_scale),
                    jate.horn_align(est, gt, with_scale)):
        np.testing.assert_allclose(x, y, atol=1e-6)


def test_associate_and_rpe_match_reference():
    rng = np.random.default_rng(4)
    sa = np.sort(rng.uniform(0, 2, 40))
    sb = np.sort(sa + rng.normal(0, 0.01, 40))
    assert tate.associate(sa, sb, 0.015) == jate.associate(sa, sb, 0.015)
    T = np.tile(np.eye(4), (10, 1, 1))
    T[:, :3, 3] = rng.normal(size=(10, 3))
    T2 = T.copy()
    T2[:, :3, 3] += 0.01 * rng.normal(size=(10, 3))
    np.testing.assert_allclose(tate.rpe(T, T2, 2), jate.rpe(T, T2, 2),
                               atol=1e-6)


# ---- TUM I/O and PNG ----

def test_load_sequence_and_gt_poses_exact(tree):
    t_seq, j_seq = ttum.load_sequence(tree[0]), jtum.load_sequence(tree[0])
    for name in ("root", "rgb_files", "depth_files", "seg_files"):
        assert getattr(t_seq, name) == getattr(j_seq, name), name
    for name in ("rgb_stamps", "depth_stamps"):
        np.testing.assert_array_equal(getattr(t_seq, name),
                                      getattr(j_seq, name))
    for a, b in zip(t_seq.gt, j_seq.gt):
        np.testing.assert_array_equal(a, b)
    pt, Rt, tt = ttum.gt_poses_at(t_seq, t_seq.rgb_stamps)
    pj, Rj, tj = jtum.gt_poses_at(j_seq, j_seq.rgb_stamps)
    assert pt == pj and len(pt) == N_FRAMES
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)
    q = ttum.rotmat_to_quat_np(Rt)
    np.testing.assert_array_equal(q, jtum.rotmat_to_quat_np(Rj))
    np.testing.assert_array_equal(ttum.quat_to_rotmat_np(q),
                                  jtum.quat_to_rotmat_np(q))


def test_png_reads_the_reference_tree(tree):
    t_seq, j_seq = ttum.load_sequence(tree[0]), jtum.load_sequence(tree[0])
    for files in (t_seq.rgb_files, t_seq.depth_files, t_seq.seg_files):
        for f in files[:4]:
            a, b = ttum.load_image(t_seq, f), jtum.load_image(j_seq, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(
        ttum.load_depth(t_seq, t_seq.depth_files[0]),
        jtum.load_depth(j_seq, j_seq.depth_files[0]))


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_roundtrip_exact(kind, tmp_path):
    rng = np.random.default_rng(7)
    img = {"gray8": lambda: rng.integers(0, 256, (33, 47), np.uint8),
           "rgb8": lambda: rng.integers(0, 256, (33, 47, 3), np.uint8),
           "gray16": lambda: rng.integers(0, 65536, (33, 47), np.uint16),
           }[kind]()
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    out = png.read_png(path)
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


def _filtered_png(img: np.ndarray, kind: int) -> bytes:
    """An 8-bit RGB PNG whose rows all use row filter ``kind``, written
    with the filter definitions of the PNG specification."""
    import struct
    import zlib

    h, w, _ = img.shape
    x = img.reshape(h, -1).astype(np.int64)
    rows = []
    for r in range(h):
        up = x[r - 1] if r else np.zeros_like(x[r])
        a = np.concatenate([np.zeros(3, np.int64), x[r][:-3]])
        c = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if kind == 0:
            pred = np.zeros_like(x[r])
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (a + up) // 2
        else:
            p = a + up - c
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, c))
        rows.append(bytes([kind]) + ((x[r] - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", range(5))
def test_png_reads_every_row_filter(kind):
    img = np.random.default_rng(kind).integers(0, 256, (9, 13, 3), np.uint8)
    np.testing.assert_array_equal(png.decode_png(_filtered_png(img, kind)),
                                  img)


# ---- the synthetic world ----

_render = jax.jit(jsyn.render_frame, static_argnames=("h", "w"))
_render_rgb = jax.jit(jsyn.render_rgb)
_odometry = jax.jit(jsyn.noisy_odometry)
_observe = jax.jit(jsyn.observe_frame,
                   static_argnames=("max_det", "noise_plane"))


def test_render_frame_matches_reference():
    Rj, tj = jsyn.corridor_trajectory(N_FRAMES, sway=0.3)
    Rt, tt = tsyn.corridor_trajectory(N_FRAMES, sway=0.3, device=CPU)
    assert_close(tt, np.asarray(tj), 1e-6, what="t")
    assert_close(Rt, np.asarray(Rj), 1e-6, what="R")
    Ro, to = tsyn.orbit_trajectory(9, radius=0.8, device=CPU)
    Roj, toj = jsyn.orbit_trajectory(9, radius=0.8)
    assert_close(to, np.asarray(toj), 1e-6, what="orbit t")
    assert_close(Ro, np.asarray(Roj), 1e-6, what="orbit R")
    wj, wt = jsyn.corridor_world(), tsyn.corridor_world(device=CPU)
    assert_close(wt.planes(), np.asarray(wj.planes()), 1e-6, what="planes")
    Kj = JK.create(120.0, 120.0, 80.0, 60.0)
    Kt = TK.create(120.0, 120.0, 80.0, 60.0, device=CPU)
    for i in (0, 5, 11):
        lab_j, dep_j = _render(Kj, Rj[i], tj[i], wj, h=H, w=W)
        lab_t, dep_t = tsyn.render_frame(
            Kt, torch.tensor(np.asarray(Rj[i])),
            torch.tensor(np.asarray(tj[i])), wt, H, W)
        assert lab_t.dtype == torch.int32
        np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
        assert_close(dep_t, np.asarray(dep_j), 0.0, rtol=1e-5, what="depth")


def test_random_draws_match_reference():
    key = jax.random.PRNGKey(11)
    labels = np.asarray(_render(JK.create(120.0, 120.0, 80.0, 60.0),
                                *(x[3] for x in jsyn.corridor_trajectory(6)),
                                jsyn.corridor_world(), h=H, w=W)[0])
    tint_key, noise_key = jax.random.split(key)
    rgb_t = tsyn.render_rgb(
        torch.tensor(labels),
        tint_u=torch.tensor(np.asarray(jax.random.uniform(tint_key,
                                                          (64, 3)))),
        noise_n=torch.tensor(np.asarray(jax.random.normal(noise_key,
                                                          (H, W, 3)))))
    assert_close(rgb_t, np.asarray(_render_rgb(jnp.asarray(labels), key)),
                 1e-6, what="rgb")

    R, t = jsyn.corridor_trajectory(8, sway=0.3)
    xi = np.asarray(jax.random.normal(key, (7, 6)))
    oR_j, ot_j = _odometry(R, t, key, sigma_t=0.02, sigma_r=0.005)
    oR_t, ot_t = tsyn.noisy_odometry(
        torch.tensor(np.asarray(R)), torch.tensor(np.asarray(t)),
        xi=torch.tensor(xi), sigma_t=0.02, sigma_r=0.005)
    assert_close(ot_t, np.asarray(ot_j), 1e-6, what="odom t")
    assert_close(oR_t, np.asarray(oR_j), 1e-6, what="odom R")

    world_j, world_t = jsyn.room_world(), tsyn.room_world(device=CPU)
    noise = np.asarray(jax.random.normal(key, (16, 3)))
    for i in (0, 4):
        o_j = _observe(world_j, R[i], t[i], key=key, max_det=9,
                       noise_plane=0.01)
        o_t = tsyn.observe_frame(
            world_t, torch.tensor(np.asarray(R[i])),
            torch.tensor(np.asarray(t[i])), noise=torch.tensor(noise),
            max_det=9, noise_plane=0.01)
        assert_close(o_t, jax.tree.map(np.asarray, o_j), 1e-6,
                     what=f"observe {i}")


def test_fixture_writer_writes_a_readable_tree(tree, tmp_path):
    root = str(tmp_path / "port_tree")
    meta = write_tum_fixture(root, n_frames=3, device=CPU)
    seq = ttum.load_sequence(root)
    assert len(seq.rgb_files) == len(seq.depth_files) == 3
    _, R, t = ttum.gt_poses_at(seq, seq.rgb_stamps)
    np.testing.assert_allclose(t, meta["t_wc"], atol=1e-6)   # 6 decimals
    np.testing.assert_allclose(R, meta["R_wc"], atol=1e-5)
    np.testing.assert_allclose(meta["t_wc"], jsyn.corridor_trajectory(
        3, sway=0.3)[1], atol=1e-6)
    Kt = TK.create(120.0, 120.0, 80.0, 60.0, device=CPU)
    wt = tsyn.corridor_world(device=CPU)
    for i, f in enumerate(seq.seg_files):
        lab, _ = tsyn.render_frame(Kt, torch.tensor(meta["R_wc"][i]),
                                   torch.tensor(meta["t_wc"][i]), wt, H, W)
        np.testing.assert_array_equal(
            ttum.load_image(seq, f) > 127,
            lab.numpy() == tsyn.LABEL_GROUND)
        assert ttum.load_image(seq, seq.rgb_files[i]).shape == (H, W, 3)


# ---- segmentation ----

_mask = jax.jit(jseg.classical_ground_mask)

# A pixel whose squared Mahalanobis distance (the f64 evaluation of the
# model) lies within TIE_BAND of the threshold 9 is a tie: the two f32
# evaluations of it part by up to 0.018 on these frames (the 3x3 color
# covariance of 8-bit pixels is ill-conditioned, and XLA sums in its own
# order), so either side may call it ground; the column cleanup carries a
# tie to the three pixels above it (``_torch_parity.ground_mask_ties``).
TIE_BAND = 0.02


def test_classical_ground_mask_matches_reference(tree):
    """Exact on every pixel but the ties (``TIE_BAND``) and the three
    pixels above each."""
    seq = jtum.load_sequence(tree[0])
    n_ground = n_tie = 0
    for f in seq.rgb_files:
        rgb = jtum.load_image(seq, f)
        ref = np.asarray(_mask(jnp.asarray(rgb)))
        out = classical_ground_mask(torch.tensor(rgb)).numpy()
        assert out.dtype == bool and out.shape == (H, W)
        tie = ground_mask_ties(rgb, TIE_BAND)
        np.testing.assert_array_equal(out[~tie], ref[~tie], err_msg=f)
        n_ground += int(ref.sum())
        n_tie += int(tie.sum())
    assert n_ground > 0 and n_tie <= 0.01 * N_FRAMES * H * W


# ---- checkpoints, presets ----

def test_checkpoint_roundtrip_state(tmp_path):
    cfg = SlamConfig(window_size=4, max_landmarks=16, max_det=5)
    state = slam_init(cfg, np.eye(3, dtype=np.float32),
                      np.array([1.0, 2.0, 3.0], np.float32), device=CPU)
    tree_ = {"state": state, "x": np.arange(3.0), "z": [np.zeros(2)]}
    path = str(tmp_path / "state.npz")
    save_state(path, tree_, meta={"frame": 7})
    like = {"state": slam_init(cfg, np.eye(3, dtype=np.float32),
                               np.zeros(3, np.float32), device=CPU),
            "x": np.zeros(3), "z": [np.ones(2)]}
    restored, meta = load_state(path, like)
    assert meta == {"frame": 7}
    assert type(restored["state"]) is type(state)
    assert_close(restored["state"], state, 0.0, what="state")
    np.testing.assert_array_equal(restored["x"], np.arange(3.0))


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_config_presets_match_reference(name):
    def fields(x):
        if hasattr(x, "_fields"):
            return {k: fields(v) for k, v in zip(x._fields, x)}
        return x

    assert tconfig.PRESETS.keys() == jconfig.PRESETS.keys()
    assert fields(tconfig.get_config(name)) == fields(jconfig.get_config(
        name))
    assert fields(tconfig.get_config(name, seed=3, fx=1.0)) == fields(
        jconfig.get_config(name, seed=3, fx=1.0))


# ---- the runner and the CLI ----

def _run_port(tree, out_dir, **kwargs):
    cfg = _port_cfg(tree, out_dir)
    out = {}
    summary = trunner.run_tum_sequence(cfg, device=CPU, out=out, **kwargs)
    return cfg, summary, out


_SAME = ("config", "sequence", "frames", "odometry", "smoothed",
         "ate_rmse_m", "ate_filter_rmse_m", "n_keyframes", "lm_overflow")
# the marginal standard deviations: the two f32 inverses of the reduced
# system part by ~1e-4 relative (tests/test_torch_smoothing.py)
STD_RTOL = 1e-3


@pytest.mark.parametrize("odometry", ODOMETRY)
def test_runner_matches_reference(odometry, tree, reference_runs,
                                  tmp_path):
    ref, ref_traj, ref_metrics = reference_runs[odometry]
    cfg, summary, out = _run_port(tree, str(tmp_path), odometry=odometry)
    assert {k: summary[k] for k in _SAME} == {k: ref[k] for k in _SAME}
    for k in ("pose_trans_std_m", "pose_rot_std_rad"):
        assert np.isfinite(summary[k]) and summary[k] > 0
        np.testing.assert_allclose(summary[k], ref[k], rtol=STD_RTOL,
                                   atol=1e-5, err_msg=k)
    assert summary["stage_timing"].keys() == ref["stage_timing"].keys()
    traj = ttum.read_trajectory(cfg.out_trajectory)
    np.testing.assert_array_equal(traj.stamps, ref_traj.stamps)
    assert np.isfinite(traj.t).all() and np.isfinite(traj.q).all()
    np.testing.assert_allclose(traj.t, ref_traj.t, atol=TRAJ_TOL)
    np.testing.assert_allclose(traj.q, ref_traj.q, atol=TRAJ_TOL)
    with open(cfg.metrics_path) as f:
        metrics = [json.loads(line) for line in f]
    assert [(m["frame"], m["n_kf"]) for m in metrics] == [
        (m["frame"], m["n_kf"]) for m in ref_metrics]
    for k in ("est_t", "est_R"):
        assert np.isfinite(out[k]).all(), k
    for x in out["marginals"]:
        assert torch.isfinite(x).all()


def test_resume_matches_uninterrupted(tree, tmp_path):
    ck = str(tmp_path / "ck.npz")
    full_cfg, full, _ = _run_port(tree, str(tmp_path))
    half = N_FRAMES // 2
    cfg_a = full_cfg._replace(out_trajectory="", metrics_path="",
                              checkpoint_path=ck, checkpoint_every=half)
    trunner.run_tum_sequence(cfg_a, device=CPU, max_frames=half + 1)
    cfg_b = full_cfg._replace(out_trajectory=str(tmp_path / "resumed.txt"),
                              metrics_path="", resume=ck)
    resumed = trunner.run_tum_sequence(cfg_b, device=CPU)
    a = ttum.read_trajectory(full_cfg.out_trajectory)
    b = ttum.read_trajectory(cfg_b.out_trajectory)
    np.testing.assert_array_equal(b.t, a.t)
    np.testing.assert_array_equal(b.q, a.q)
    assert resumed["ate_rmse_m"] == full["ate_rmse_m"]
    assert resumed["n_keyframes"] == full["n_keyframes"]
    with pytest.raises(ValueError, match="odometry mode"):
        trunner.run_tum_sequence(cfg_b, odometry="constant_velocity",
                                 device=CPU)


def _cli_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue())


def test_cli_popup_demo_matches_reference():
    """At 480x640 against the reference CLI's summary, recorded by
    ``scripts/make_torch_reference.py tum``: the wall count exactly, the
    depth error's median and p95 within 1e-5."""
    rc, out = _cli_json(tcli.main, ["run", "--config", "popup_demo",
                                    "--device", "cpu"])
    ref = np.load(os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                               "corridor_ref_tum.npz"))
    assert rc == 0
    assert out["n_wall_planes"] == int(ref["popup_demo_n_wall_planes"]) > 0
    for k in ("depth_median_rel_err", "depth_p95_rel_err"):
        assert np.isfinite(out[k])
        np.testing.assert_allclose(out[k], float(ref[f"popup_demo_{k}"]),
                                   atol=1e-5)


def test_cli_tum_and_unported_modes(tree, tmp_path):
    fx, fy, cx, cy = (tree[1][k] for k in ("fx", "fy", "cx", "cy"))
    argv = ["run", "--config", "tum_fr3", "--device", "cpu",
            "--sequence-dir", tree[0], "--height", str(H), "--width",
            str(W), "--intrinsics", str(fx), str(fy), str(cx), str(cy),
            "--odometry", "constant_velocity", "--no-smooth"]
    rc, out = _cli_json(tcli.main, argv)
    assert rc == 0 and out["frames"] == N_FRAMES and not out["smoothed"]
    assert np.isfinite(out["ate_rmse_m"])
    assert tcli.main(["run", "--config", "tum_fr3", "--device", "cpu",
                      "--sequence-dir", str(tmp_path / "none")]) == 2
    # the synthetic corridor preset, profiled
    rc, out = _cli_json(tcli.main, [
        "run", "--config", "corridor", "--device", "cpu", "--frames", "6",
        "--profile-dir", str(tmp_path / "prof")])
    assert rc == 0 and out["frames"] == 6 and np.isfinite(out["ate_rmse_m"])
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    # the distributed presets (run in ranks in tests/test_torch_sharded.py)
    # refuse a mesh larger than the process group before starting one
    for preset in ("single_host", "multi_host"):
        with pytest.raises(ValueError, match="no process group"):
            tcli.main(["run", "--config", preset, "--device", "cpu",
                       "--devices", "2"])


def test_entry_points_raise_without_cuda(tree, tmp_path):
    """No device named and no GPU present: the new entry points raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.run_tum_sequence(_port_cfg(tree, str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["run", "--config", "popup_demo"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.corridor_world()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        write_tum_fixture(str(tmp_path / "x"), n_frames=2)
