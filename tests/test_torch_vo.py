"""The port's plane-VO odometry (``pop_up_slam_tpu_torch/odometry``) and
monocular runner against the JAX package on the CPU.

- ``match_planes`` on seeded plane sets with gates, invalid slots and
  exact score ties (first index of the minimum, as ``jnp.argmin``):
  indices and weights exact;
- ``align_planes`` on seeded matches with and without a flipped normal,
  with zero weights and with no data (the prior alone): R and t within
  2e-4 (the reference's f32 SVD itself is 1.6e-4 off the f64 answer on
  such draws; the port's q-method rotation is 4.3e-5 off);
- ``plane_vo_step`` with and without support weights, and with too few
  matches (the prior kept): ``n_matches`` and ``used_prior`` exact, R
  and t within 2e-4;
- ``make_chunked_vo_runner`` over 8 synthetic 120x160 corridor frames
  (``io.synthetic.render_frame``), W=4, L=16, through
  ``run_masks_chunked`` in chunks of 3 and of 16 (one short chunk), and
  over no frame: poses within 5e-3 (the reference's fused-vs-per-op
  bound), ``n_matches`` / ``used_prior`` and the end state's discrete
  fields exact; then each frame alone from the reference's own state
  before it: the pose within 1e-3, ``n_matches`` and the pop-up's valid
  walls exact.

The JAX runner is compiled once (a chunk of one frame, ``donate=False``)
in a module fixture and stepped frame by frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_close
from pop_up_slam_tpu.geometry import plane as jplane
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.io import synthetic
from pop_up_slam_tpu.odometry import plane_vo as jvo
from pop_up_slam_tpu.pipeline import offline as joff
from pop_up_slam_tpu.pipeline import slam as jslam
from pop_up_slam_tpu.popup import popup as jpp
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.geometry import se3
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.odometry import plane_vo as tvo
from pop_up_slam_tpu_torch.pipeline import offline as toff
from pop_up_slam_tpu_torch.pipeline import slam as tslam
from pop_up_slam_tpu_torch.popup import popup as tpp

TOL = 2e-4

# the reference's functions, each compiled once for the module
_match = jax.jit(jvo.match_planes, static_argnames=("cfg",))
_align = jax.jit(jvo.align_planes)
_step = jax.jit(jvo.plane_vo_step, static_argnames=("cfg",))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _motion(rng, rot=0.1, trans=0.3):
    xi = np.concatenate([trans * rng.normal(size=3),
                         rot * rng.normal(size=3)]).astype(np.float32)
    R, t = se3.se3_exp(_t(xi))
    return R.numpy(), t.numpy()


def _plane_sets(seed, D=9, noise=0.01):
    """Planes of frame a (unit, camera frame) and the same planes seen
    from frame b after a seeded motion, shuffled, with noise, invalid
    slots and one unmatched plane on each side."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(D, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    pa = np.asarray(jplane.normalize(jnp.asarray(np.concatenate(
        [n, rng.uniform(-4, 4, size=(D, 1))], 1).astype(np.float32))))
    R, t = _motion(rng)
    # x_a = R x_b + t: planes of a seen in b
    R_ba, t_ba = (x.numpy() for x in se3.se3_inverse(_t(R), _t(t)))
    pb = np.asarray(jplane.transform_to_world(jnp.asarray(pa), R_ba, t_ba))
    perm = rng.permutation(D)
    pb = pb[perm] + noise * rng.normal(size=(D, 4)).astype(np.float32)
    pb[0] = np.asarray(jplane.normalize(jnp.asarray(
        rng.normal(size=4).astype(np.float32))))      # unmatched
    va, vb = np.ones(D, bool), np.ones(D, bool)
    va[rng.integers(D)] = vb[rng.integers(D)] = False
    return pa.astype(np.float32), va, pb.astype(np.float32), vb, R, t


@pytest.mark.parametrize("seed", range(4))
def test_match_planes_matches_reference(seed):
    pa, va, pb, vb, R, t = _plane_sets(seed)
    cfg = tvo.PlaneVOConfig()
    for prior in ((R, t), (np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))):
        mt, wt = tvo.match_planes(_t(pa), _t(va), _t(pb), _t(vb),
                                  _t(prior[0]), _t(prior[1]), cfg)
        mj, wj = _match(pa, va, pb, vb, *prior, cfg=jvo.PlaneVOConfig())
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert mt.dtype == torch.int32
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert (mt >= 0).sum() >= 3


def test_match_planes_ties_take_the_first_index():
    """Duplicated planes give exact score ties on both axes."""
    pa = np.tile(np.array([[1.0, 0.0, 0.0, -1.0]], np.float32), (4, 1))
    pa[2] = [0.0, 1.0, 0.0, -2.0]
    valid = np.ones(4, bool)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    mt, _ = tvo.match_planes(_t(pa), _t(valid), _t(pa), _t(valid),
                             _t(eye), _t(zero))
    mj, _ = _match(pa, valid, pa, valid, eye, zero)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.tolist()[0] == 0 and mt.tolist()[2] == 2


@pytest.mark.parametrize("case", ["data", "flipped", "zero_weight",
                                  "prior_only"])
def test_align_planes_matches_reference(case):
    rng = np.random.default_rng(["data", "flipped", "zero_weight",
                                 "prior_only"].index(case))
    for _ in range(8):
        pa, va, pb, vb, R, t = _plane_sets(int(rng.integers(1 << 30)),
                                           noise=0.0)
        m = np.asarray(_match(pa, np.ones(9, bool), pb, np.ones(9, bool),
                              R, t)[0])
        pb_m = pb[np.clip(m, 0, 8)]
        w = (m >= 0).astype(np.float32) * rng.uniform(0.5, 3.0, 9).astype(
            np.float32)
        if case == "flipped":
            pb_m[1] = -pb_m[1]
            pa[3, :3] = -pa[3, :3]            # a normal no longer matches
        if case == "zero_weight":
            w[:5] = 0.0
        if case == "prior_only":
            w[:] = 0.0
        pR, pt = _motion(rng, 0.05, 0.1)
        pR, pt = (R @ pR).astype(np.float32), (t + pt).astype(np.float32)
        Rt, tt = tvo.align_planes(_t(pa), _t(pb_m), _t(w), _t(pR), _t(pt))
        Rj, tj = _align(pa, pb_m, w, pR, pt)
        assert_close(Rt, Rj, TOL, what="R")
        assert_close(tt, tj, TOL, what="t")
        np.testing.assert_allclose(float(torch.linalg.det(Rt)), 1.0,
                                   atol=1e-5)
        if case == "prior_only":
            assert_close(Rt, pR, 1e-5, what="R = prior")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("support", [False, True])
def test_plane_vo_step_matches_reference(seed, support):
    pa, va, pb, vb, R, t = _plane_sets(10 + seed)
    rng = np.random.default_rng(seed)
    pR, pt = _motion(rng, 0.02, 0.05)
    pR, pt = (R @ pR).astype(np.float32), (t + pt).astype(np.float32)
    sup = {}
    if support:
        sup = dict(support_prev=rng.uniform(0, 300, 9).astype(np.float32),
                   support_cur=rng.uniform(0, 300, 9).astype(np.float32))
    for valid_b in (vb, np.zeros(9, bool)):       # the second keeps the prior
        rt = tvo.plane_vo_step(_t(pa), _t(va), _t(pb), _t(valid_b), _t(pR),
                               _t(pt), **{k: _t(v) for k, v in sup.items()})
        rj = _step(pa, va, pb, valid_b, pR, pt, **sup)
        assert int(rt.n_matches) == int(rj.n_matches)
        assert rt.n_matches.dtype == torch.int32
        assert bool(rt.used_prior) == bool(rj.used_prior)
        assert_close(rt.R, rj.R, TOL, what="R")
        assert_close(rt.t, rj.t, TOL, what="t")
    assert bool(rt.used_prior) and int(rt.n_matches) == 0


# ---- the runner on synthetic frames ----

SH, SW, N_FRAMES = 120, 160, 9


@pytest.fixture(scope="module")
def vo_run():
    """The reference's VO runner, compiled once for a one-frame chunk and
    stepped over the frames: its state before each frame, its outputs,
    each frame's n_matches / used_prior and pop-up valid walls."""
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
    vo_rec, pop_rec = [], []
    step, pop_up = joff.plane_vo_step, jpp.pop_up

    def recording(*args, **kwargs):
        res = step(*args, **kwargs)
        jax.debug.callback(lambda m, u: vo_rec.append((int(m), bool(u))),
                           res.n_matches, res.used_prior, ordered=True)
        return res

    def recording_pop_up(*args, **kwargs):
        res = pop_up(*args, **kwargs)
        jax.debug.callback(lambda v: pop_rec.append(np.asarray(v)),
                           res.valid, ordered=True)
        return res

    joff.plane_vo_step, jpp.pop_up = recording, recording_pop_up
    try:
        run = joff.make_chunked_vo_runner(K, jpc, jsc, donate=False)
        # strong-typed leaves, so that the second frame reuses the compile
        st = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                          joff.vo_init(jslam.slam_init(jsc, Rs[0], ts[0]),
                                       jsc.max_det))
        states, outs = [], []
        for i in range(1, N_FRAMES):
            states.append(jax.tree.map(np.asarray, st))
            st, (R, t) = run(st, masks[i:i + 1])
            outs.append((np.asarray(R[0]), np.asarray(t[0])))
        jax.effects_barrier()
    finally:
        joff.plane_vo_step, jpp.pop_up = step, pop_up
    states.append(jax.tree.map(np.asarray, st))
    return dict(masks=masks[1:], states=states, outs=outs, vo=vo_rec,
                pops=pop_rec, R0=np.asarray(Rs[0]), t0=np.asarray(ts[0]),
                scfg=tslam.SlamConfig(**skw), pcfg=tpp.PopupConfig(**pkw),
                K=TK.create(80.0, 80.0, 80.0, 60.0, device="cpu"))


def _recording(monkeypatch):
    vo, pops = [], []
    step, pop_up = toff.plane_vo_step, toff.pp.pop_up

    def recording(*args, **kwargs):
        res = step(*args, **kwargs)
        vo.append((int(res.n_matches), bool(res.used_prior)))
        return res

    def recording_pop_up(*args, **kwargs):
        res = pop_up(*args, **kwargs)
        pops.append(res.valid.numpy())
        return res

    monkeypatch.setattr(toff, "plane_vo_step", recording)
    monkeypatch.setattr(toff.pp, "pop_up", recording_pop_up)
    return vo, pops


@pytest.mark.parametrize("chunk", [3, 16])
def test_vo_runner_matches_reference(vo_run, monkeypatch, chunk):
    vr = vo_run
    vo, _ = _recording(monkeypatch)
    cfg = vr["scfg"]
    st = toff.vo_init(tslam.slam_init(cfg, vr["R0"], vr["t0"], device="cpu"),
                      cfg.max_det)
    run = toff.make_chunked_vo_runner(vr["K"], vr["pcfg"], cfg)
    st, (R, t) = toff.run_masks_chunked(run, st, vr["masks"], chunk=chunk)
    assert R.shape == (len(vr["outs"]), 3, 3)
    assert_close(t, np.stack([o[1] for o in vr["outs"]]), 5e-3, what="t")
    assert_close(R, np.stack([o[0] for o in vr["outs"]]), 5e-3, what="R")
    assert vo == vr["vo"]
    end = vr["states"][-1].slam
    assert int(st.slam.n_kf) == int(end.n_kf)
    assert int(st.slam.n_overflow) == int(end.n_overflow)
    np.testing.assert_array_equal(st.slam.store.valid.numpy(),
                                  end.store.valid)
    # no frame: the state back, empty outputs
    st0, (R0, t0) = toff.run_masks_chunked(run, st, vr["masks"][:0])
    assert st0 is st and R0.shape == (0, 3, 3) and t0.shape == (0, 3)


def test_vo_frame_matches_reference_from_its_state(vo_run, monkeypatch):
    vr = vo_run
    vo, pops = _recording(monkeypatch)
    frame = toff.make_vo_frame_fn(vr["K"], vr["pcfg"], vr["scfg"])
    for i, (R_ref, t_ref) in enumerate(vr["outs"]):
        vs = convert.vo_state_from_numpy(vr["states"][i], CPU)
        vs, (R, t) = frame(vs, torch.as_tensor(vr["masks"][i]))
        assert_close(t, t_ref, 1e-3, what=f"t {i}")
        assert_close(R, R_ref, 1e-3, what=f"R {i}")
        for a, b in zip(vs.prev_valid.numpy(),
                        vr["states"][i + 1].prev_valid):
            assert a == b
    assert vo == vr["vo"]
    np.testing.assert_array_equal(np.stack(pops), np.stack(vr["pops"]))


def test_vo_frame_pads_the_detections():
    """``max_det`` above walls + ground pads the plane set with
    placeholders (invalid, zero support); equal to it, no pad."""
    cfg = tpp.PopupConfig(min_cols=6, smooth_radius=2, nms_radius=4)
    K = TK.create(80.0, 80.0, 80.0, 60.0, device="cpu")
    mask = np.zeros((SH, SW), bool)
    mask[70:] = True
    for extra in (0, 3):
        scfg = tslam.SlamConfig(max_det=cfg.max_segments + 1 + extra,
                                window_size=4, max_landmarks=16)
        vs = toff.vo_init(tslam.slam_init(scfg, np.eye(3, dtype=np.float32),
                                          np.array([0, 0, 1.4], np.float32),
                                          device="cpu"), scfg.max_det)
        vs, _, _ = toff._vo_frame_core(vs, torch.as_tensor(mask), K, cfg,
                                       scfg, tvo.PlaneVOConfig())
        assert vs.prev_planes.shape == (scfg.max_det, 4)
        assert vs.prev_support.shape == (scfg.max_det,)
        if extra:
            assert not vs.prev_valid[-extra:].any()
            assert not vs.prev_support[-extra:].any()
            assert (vs.prev_planes[-extra:]
                    == torch.tensor([0.0, 0.0, 1.0, 0.0])).all()
        assert bool(vs.prev_valid[cfg.max_segments])       # the ground


def _anchor(z, key, i):
    """The reference's recorded state before frame ``i`` (``anchor.*``
    keys of the corridor references) as nested dicts."""
    tree, pre = {}, key + "anchor."
    for k in z.files:
        if k.startswith(pre):
            node = tree
            *path, leaf = k[len(pre):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k][i]
    return tree


def test_vo_frames_from_the_reference_states():
    """Frames 55-59 of the 480x640 corridor through the port's VO frame
    on the CPU, each from the reference's own state before it
    (``corridor_ref_vo.npz``'s ``anchor.*``), with the fused GN's plain
    version: each pose within 1e-4 of the reference's, ``n_matches``
    equal (the CPU side of ``chip_smoke.py``'s anchored hold)."""
    from _torch_parity import REPO, corridor_K, corridor_inputs

    masks, _, _, _, _ = corridor_inputs(1)
    z = np.load(f"{REPO}/pop_up_slam_tpu_torch/data/corridor_ref_vo.npz")
    pcfg = tpp.PopupConfig()
    scfg = tslam.SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                            kf_rot=0.0, fused="on")
    K = TK.create(*corridor_K(1), device="cpu")
    frame = toff._vo_frame_core
    for i in range(55, 60):
        vs = convert.vo_state_from_numpy(_anchor(z, "vo_", i), CPU)
        _, (R, t), (_, _, _, vo) = frame(vs, torch.as_tensor(masks[i]), K,
                                         pcfg, scfg, tvo.PlaneVOConfig())
        assert_close(t, z["vo_t"][i], 1e-4, what=f"t {i}")
        assert int(vo.n_matches) == int(z["vo_n_matches"][i])
