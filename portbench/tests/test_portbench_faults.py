"""A run whose timed path is broken underneath comes out not correct:
one case for each fault a cell can have (the look for a card skipped,
the rest of the run as the benchmark makes it)."""

import numpy as np
import pytest
import torch

from _portbench_cpu import run_cell


def _state_unchanged(monkeypatch):
    from pop_up_slam_tpu_torch.pipeline import offline, slam

    def step(state, det, odom_R, odom_t, cfg, **kw):
        return state, slam.current_pose(state)

    return lambda run: monkeypatch.setattr(offline, "slam_step", step)


def _half_the_detections(monkeypatch):
    """Half of the frame's batch of detections left out."""
    from pop_up_slam_tpu_torch.pipeline import offline

    orig = offline.detections_from_popup

    def det(*args, **kw):
        d = orig(*args, **kw)
        keep = torch.arange(d.valid.shape[0]) % 2 == 0
        return d._replace(valid=d.valid & keep.to(d.valid.device))

    return lambda run: monkeypatch.setattr(offline, "detections_from_popup",
                                           det)


def _pose_altered(monkeypatch):
    """The answer altered where it is produced: each frame's pose moved
    by 1 cm."""
    from pop_up_slam_tpu_torch.pipeline import offline

    orig = offline.slam_step

    def step(*args, **kw):
        state, (R, t) = orig(*args, **kw)
        return state, (R, t + 1e-2)

    return lambda run: monkeypatch.setattr(offline, "slam_step", step)


def _mask_altered(monkeypatch):
    """A decoded mask altered where it is produced (one pixel)."""
    from pop_up_slam_tpu_torch.io import tum

    orig = tum.load_image

    def load(seq, rel):
        img = orig(seq, rel)
        if rel.startswith("seg"):
            img = img.copy()
            img[0, 0] = 255 - img[0, 0]
        return img

    return lambda run: monkeypatch.setattr(tum, "load_image", load)


def _smoother_returns_input(monkeypatch):
    """The smoother returns the keyframes it was given."""
    from pop_up_slam_tpu_torch.runners import tum_runner

    def smooth(rec, state, cfg, iters=8, damping=1e-5, **kw):
        return np.stack(rec.kf_R), np.stack(rec.kf_t), None

    return lambda run: monkeypatch.setattr(tum_runner, "smooth_trajectory",
                                           smooth)


def _smoother_skipped(monkeypatch):
    """The runner's smoother left out."""
    from pop_up_slam_tpu_torch.runners import tum_runner

    orig = tum_runner.run_tum_sequence

    def run_seq(*args, **kw):
        kw["smooth"] = False
        return orig(*args, **kw)

    return lambda run: monkeypatch.setattr(tum_runner, "run_tum_sequence",
                                           run_seq)


SMOOTHER_FAULTS = {"returns_input": _smoother_returns_input,
                   "skipped": _smoother_skipped}

FAULTS = {"state_unchanged": _state_unchanged,
          "half_the_detections": _half_the_detections,
          "pose_altered": _pose_altered}


@pytest.mark.parametrize("cell", ["corridor_w8_gn.replay", "tum_fr3.seq144"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, cell, fault):
    code, res = run_cell(cell, fault=FAULTS[fault](monkeypatch))
    assert code == 0
    assert not res["correct"], res["checks"]


def test_decoded_mask_altered_is_not_correct(monkeypatch):
    code, res = run_cell("tum_fr3.seq144", fault=_mask_altered(monkeypatch))
    assert code == 0
    assert not res["correct"]
    assert res["checks"]["mask_pixels_differ"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(SMOOTHER_FAULTS))
def test_smoother_fault_is_not_correct(monkeypatch, fault):
    code, res = run_cell("tum_fr3.seq144",
                         fault=SMOOTHER_FAULTS[fault](monkeypatch))
    assert code == 0
    assert not res["correct"]
    c = res["checks"]["smooth_gap"]
    assert not c["value"] <= c["limit"], c
