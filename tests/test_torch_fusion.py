"""The port's depth fusion (``pop_up_slam_tpu_torch/fusion``) and fused
monocular runner against the JAX package on the CPU.

- ``init_from_popup``, ``fuse_observation`` and ``propagate_to_frame``
  on numpy-seeded maps: floats 1e-6 relative, masks exact;
  ``propagate_to_frame`` also under a motion that splats several source
  pixels at one equal depth onto one target (exact z-buffer ties: the
  last source in row-major order wins on both sides);
- ``align_scale``: an even count of valid ratios (the mean of the two
  middle ones, where ``torch.nanmedian`` would take the lower), an odd
  count, a weight mask, and no valid pixel (NaN);
- ``make_chunked_fused_vo_runner`` over 8 synthetic 120x160 corridor
  frames (``io.synthetic.render_frame``), W=4, L=16, through
  ``run_masks_chunked`` in chunks of 3: poses within 5e-3 (the
  reference's fused-vs-per-op bound; a 1e-7 m change of its start moves
  the reference's own monocular run by far more over longer runs,
  PERF.md), ``n_matches`` / ``used_prior`` and the end state's discrete
  fields exact, and the fused depth within 1e-3 relative on at least
  95 % of each frame's pixels;
- the same frames one at a time, each from the reference's own state
  before it: the filter's valid mask exact, ``n_matches`` exact, the pose
  within 1e-3, the fused depth within 1e-2 relative everywhere (the
  pose of two of these frames is ill-conditioned: 1.5e-4 apart from
  equal states) and 1e-4 on at least 99 % of the pixels.

The JAX runner is compiled once (a chunk of one frame, ``donate=False``)
in a module fixture and stepped frame by frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_close, np_tree
from pop_up_slam_tpu.fusion import depth_fusion as jfus
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.io import synthetic
from pop_up_slam_tpu.pipeline import offline as joff
from pop_up_slam_tpu.pipeline import slam as jslam
from pop_up_slam_tpu.popup import popup as jpp
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.fusion import depth_fusion as tfus
from pop_up_slam_tpu_torch.geometry import se3
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.pipeline import offline as toff
from pop_up_slam_tpu_torch.pipeline import slam as tslam
from pop_up_slam_tpu_torch.popup import popup as tpp

H, W = 60, 80
KJ = JK.create(40.0, 40.0, 40.0, 30.0)
KT = TK.create(40.0, 40.0, 40.0, 30.0, device="cpu")


def _filter(seed, depth=None):
    """A seeded filter: a tilted plane with a nearer box, 10 % invalid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    if depth is None:
        depth = (3.0 + 0.02 * xx + 0.01 * yy).astype(np.float32)
        depth[20:40, 30:50] = 2.0
    inv = (1.0 / depth).astype(np.float32)
    var = ((0.05 * inv) ** 2 * rng.uniform(0.5, 2.0, size=(H, W))).astype(
        np.float32)
    valid = rng.random((H, W)) < 0.9
    return dict(inv_mu=np.where(valid, inv, 0.0).astype(np.float32),
                var=np.where(valid, var, 1e6).astype(np.float32),
                valid=valid)


def _both(d):
    return (jfus.DepthFilter(*(jnp.asarray(d[k]) for k in
                               ("inv_mu", "var", "valid"))),
            convert.depth_filter_from_numpy(d, CPU))


def _close(a, b):
    for name, x, y in zip(a._fields, np_tree(a), np_tree(b)):
        assert np.isfinite(x).all(), name
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7,
                                       err_msg=name)


def test_init_and_fuse_match_reference(no_debug_nans):
    rng = np.random.default_rng(1)
    depth = rng.uniform(-1.0, 50.0, size=(H, W)).astype(np.float32)
    depth[0, :4] = [0.0, 1e-3, 40.0, 39.9]
    mask = rng.random((H, W)) < 0.7
    for valid in (None, mask):
        a = tfus.init_from_popup(torch.as_tensor(depth),
                                 None if valid is None else
                                 torch.as_tensor(valid))
        b = jfus.init_from_popup(jnp.asarray(depth), valid)
        _close(a, b)
    fj, ft = _both(_filter(2))
    obs_inv = (1.0 / rng.uniform(1.5, 6.0, size=(H, W))).astype(np.float32)
    obs_inv[:3, :3] = [[np.nan, np.inf, -1.0], [0.0, 0.3, 0.3],
                       [0.3, 0.3, 0.3]]
    obs_var = (rng.uniform(1e-4, 1e-2, size=(H, W))).astype(np.float32)
    obs_var[1, :2] = [0.0, -1.0]
    _close(tfus.fuse_observation(ft, torch.as_tensor(obs_inv),
                                 torch.as_tensor(obs_var)),
           jfus.fuse_observation(fj, jnp.asarray(obs_inv),
                                 jnp.asarray(obs_var)))


@pytest.mark.parametrize("case", range(3))
def test_propagate_matches_reference(case):
    rng = np.random.default_rng(10 + case)
    xi = (rng.normal(size=6) * [0.05, 0.05, 0.1, 0.02, 0.02, 0.02]).astype(
        np.float32)
    R, t = (x.numpy() for x in se3.se3_exp(torch.as_tensor(xi)))
    fj, ft = _both(_filter(case))
    b = jfus.propagate_to_frame(fj, KJ, jnp.asarray(R), jnp.asarray(t))
    a = tfus.propagate_to_frame(ft, KT, torch.as_tensor(R),
                                torch.as_tensor(t))
    _close(a, b)
    assert 0.5 < float(a.valid.float().mean()) < 1.0


def test_propagate_ties_take_the_last_source():
    """A fronto-parallel wall at 3 m seen from 1 m further back: every
    source point lands at z = 4 m exactly and the view shrinks by 3/4,
    so many targets receive two sources at the same depth.  The
    per-pixel variances differ, so the winner shows in ``var``."""
    d = _filter(5, depth=np.full((H, W), 3.0, np.float32))
    d["valid"][:] = True
    d["inv_mu"][:] = np.float32(1.0 / 3.0)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.0, 0.0, -1.0], np.float32)
    fj, ft = _both(d)
    b = jfus.propagate_to_frame(fj, KJ, jnp.asarray(R), jnp.asarray(t))
    a = tfus.propagate_to_frame(ft, KT, torch.as_tensor(R),
                                torch.as_tensor(t))
    _close(a, b)
    # ties happened: fewer targets landed than sources were splatted
    assert int(a.valid.sum()) < 0.7 * H * W
    # and the last source won: each landed target holds the variance of
    # the last source (row-major) that the f32 arithmetic sends there
    f32 = np.float32
    depth = f32(1.0) / np.clip(d["inv_mu"], f32(1e-3), f32(1e3))
    uu, vv = np.meshgrid(np.arange(W, dtype=f32), np.arange(H, dtype=f32))
    z = depth + f32(1.0)
    ui = np.round(f32(40.0) * (((uu - f32(40.0)) / f32(40.0)) * depth) / z
                  + f32(40.0)).astype(int)
    vi = np.round(f32(40.0) * (((vv - f32(30.0)) / f32(40.0)) * depth) / z
                  + f32(30.0)).astype(int)
    last = np.full(H * W, -1)
    flat = (vi * W + ui).reshape(-1)
    for src in range(H * W):
        last[flat[src]] = src
    landed = last >= 0
    np.testing.assert_array_equal(a.valid.numpy().reshape(-1), landed)
    scale2 = (depth.reshape(-1) / z.reshape(-1)) ** 2
    want = d["var"].reshape(-1) * scale2 * scale2 + f32(1e-4)
    np.testing.assert_allclose(a.var.numpy().reshape(-1)[landed],
                               want[last[landed]], rtol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7])
def test_align_scale_median(n_valid, no_debug_nans):
    """Even counts average the two middle ratios, as ``jnp.nanmedian``
    does; no valid pixel gives NaN on both sides.  (Masked ratios are
    NaN by design, hence ``no_debug_nans``.)"""
    rng = np.random.default_rng(n_valid)
    amb = np.zeros((4, 5), np.float32)
    plane = rng.uniform(1.0, 5.0, size=(4, 5)).astype(np.float32)
    idx = rng.permutation(20)[:n_valid]
    amb.reshape(-1)[idx] = rng.uniform(0.1, 2.0, size=n_valid)
    weight = (rng.random((4, 5)) < 0.8).astype(np.float32)
    got = []
    for wt in (None, weight):
        b = float(jfus.align_scale(jnp.asarray(amb), jnp.asarray(plane),
                                   None if wt is None else jnp.asarray(wt)))
        a = float(tfus.align_scale(torch.as_tensor(amb),
                                   torch.as_tensor(plane),
                                   None if wt is None
                                   else torch.as_tensor(wt)))
        if n_valid == 0:
            assert np.isnan(a) and np.isnan(b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6)
        got.append(a)
    if n_valid == 6:
        a = got[0]
        ratio = (1.0 / plane.reshape(-1)[idx]) / amb.reshape(-1)[idx]
        low = float(torch.nanmedian(torch.as_tensor(ratio)))
        assert a != low and np.isclose(a, np.median(ratio), rtol=1e-6)


# ---- the fused runner on synthetic frames ----

SH, SW, N_FRAMES = 120, 160, 9


@pytest.fixture(scope="module")
def fused_run():
    """The reference's fused runner, compiled once for a one-frame chunk
    and stepped over the frames: its state before each frame, its
    outputs, and each frame's n_matches / used_prior."""
    K = JK.create(80.0, 80.0, 80.0, 60.0)
    world = synthetic.corridor_world()
    Rs, ts = synthetic.corridor_trajectory(N_FRAMES)
    labels = np.asarray(jax.jit(jax.vmap(
        lambda R, t: synthetic.render_frame(K, R, t, world, SH, SW)[0]))(
            Rs, ts))
    masks = labels == synthetic.LABEL_GROUND
    pkw = dict(min_cols=6, smooth_radius=2, nms_radius=4)
    skw = dict(max_det=jpp.PopupConfig().max_segments + 1, kf_trans=0.0,
               kf_rot=0.0, window_size=4, max_landmarks=16)
    jsc, jpc = jslam.SlamConfig(**skw), jpp.PopupConfig(**pkw)
    vo_rec = []
    step = joff.plane_vo_step

    def recording(*args, **kwargs):
        res = step(*args, **kwargs)
        jax.debug.callback(lambda m, u: vo_rec.append((int(m), bool(u))),
                           res.n_matches, res.used_prior, ordered=True)
        return res

    joff.plane_vo_step = recording
    try:
        run = joff.make_chunked_fused_vo_runner(K, jpc, jsc, donate=False)
        # strong-typed leaves, so that the second frame reuses the compile
        st = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                          joff.fused_vo_init(jslam.slam_init(jsc, Rs[0],
                                                             ts[0]),
                                             jsc.max_det, SH, SW))
        states, outs = [], []
        for i in range(1, N_FRAMES):
            states.append(jax.tree.map(np.asarray, st))
            st, ((R, t), d) = run(st, masks[i:i + 1])
            outs.append((np.asarray(R[0]), np.asarray(t[0]),
                         np.asarray(d[0])))
        jax.effects_barrier()
    finally:
        joff.plane_vo_step = step
    states.append(jax.tree.map(np.asarray, st))
    return dict(masks=masks[1:], states=states, outs=outs, vo=vo_rec,
                R0=np.asarray(Rs[0]), t0=np.asarray(ts[0]),
                scfg=tslam.SlamConfig(**skw), pcfg=tpp.PopupConfig(**pkw),
                K=TK.create(80.0, 80.0, 80.0, 60.0, device="cpu"))


def _recording_vo(monkeypatch):
    rec = []
    step = toff.plane_vo_step

    def recording(*args, **kwargs):
        res = step(*args, **kwargs)
        rec.append((int(res.n_matches), bool(res.used_prior)))
        return res

    monkeypatch.setattr(toff, "plane_vo_step", recording)
    return rec


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


def test_fused_runner_matches_reference(fused_run, monkeypatch):
    fr = fused_run
    rec = _recording_vo(monkeypatch)
    cfg = fr["scfg"]
    st = toff.fused_vo_init(tslam.slam_init(cfg, fr["R0"], fr["t0"],
                                            device="cpu"),
                            cfg.max_det, SH, SW)
    run = toff.make_chunked_fused_vo_runner(fr["K"], fr["pcfg"], cfg)
    st, ((R, t), depth) = toff.run_masks_chunked(run, st, fr["masks"],
                                                 chunk=3)
    n = len(fr["outs"])
    assert R.shape == (n, 3, 3) and depth.shape == (n, SH, SW)
    assert_close(t, np.stack([o[1] for o in fr["outs"]]), 5e-3, what="t")
    assert_close(R, np.stack([o[0] for o in fr["outs"]]), 5e-3, what="R")
    assert rec == fr["vo"]
    end = fr["states"][-1].vo.slam
    assert int(st.vo.slam.n_kf) == int(end.n_kf)
    assert int(st.vo.slam.n_overflow) == int(end.n_overflow)
    np.testing.assert_array_equal(st.vo.slam.store.valid.numpy(),
                                  end.store.valid)
    d = depth.numpy()
    assert np.isfinite(d).all()
    for i, (_, _, d_ref) in enumerate(fr["outs"]):
        assert (_rel(d[i], d_ref) <= 1e-3).mean() >= 0.95, i


def test_fused_frame_matches_reference_from_its_state(fused_run,
                                                      monkeypatch):
    fr = fused_run
    rec = _recording_vo(monkeypatch)
    frame = toff.make_fused_vo_frame_fn(fr["K"], fr["pcfg"], fr["scfg"])
    for i, (R_ref, t_ref, d_ref) in enumerate(fr["outs"]):
        fs = convert.fused_vo_state_from_numpy(fr["states"][i], CPU)
        fs, ((R, t), d) = frame(fs, torch.as_tensor(fr["masks"][i]))
        assert_close(t, t_ref, 1e-3, what=f"t {i}")
        assert_close(R, R_ref, 1e-3, what=f"R {i}")
        np.testing.assert_array_equal(fs.filt.valid.numpy(),
                                      fr["states"][i + 1].filt.valid)
        rel = _rel(d.numpy(), d_ref)
        assert np.isfinite(d.numpy()).all()
        assert rel.max() <= 1e-2 and (rel <= 1e-4).mean() >= 0.99, i
    assert rec == fr["vo"]
