"""The TUM runner's per-frame read decodes only the image the frame's
segmentation reads (port only, on the CPU; no JAX).

On the port's ``write_tum_fixture`` tree (120x160, 12 frames) with the
runner widths of ``tests/test_torch_tum.py``:

- with a ``seg/`` mask for every frame, no ``rgb/`` path is decoded;
  without ``seg/``, every frame's RGB image once; with one frame's mask
  deleted, RGB for that frame alone; ``summary["decoded"]`` counts both;
- the mask each frame hands to the frame step equals the mask of the
  rule the runner always followed (the ``seg/`` mask where the frame has
  one, else ``classical_ground_mask`` of its RGB image), decoded here by
  the plain codec (``io/png.py``), exactly;
- the run's filtering and smoothed trajectories equal, exactly, a run
  over a tree that holds that rule's mask in ``seg/`` for every frame;
- RGB files that cannot be decoded beside masks raise nothing and
  change nothing.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import CPU
from pop_up_slam_tpu_torch import config as tconfig
from pop_up_slam_tpu_torch.io import png
from pop_up_slam_tpu_torch.io import tum as ttum
from pop_up_slam_tpu_torch.io.tum_fixture import write_tum_fixture
from pop_up_slam_tpu_torch.models import classical_ground_mask
from pop_up_slam_tpu_torch.pipeline import offline
from pop_up_slam_tpu_torch.popup.popup import PopupConfig
from pop_up_slam_tpu_torch.runners import tum_runner

N_FRAMES = 12
MISSING = 5     # the frame whose mask the ``one_mask_missing`` tree lacks


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two trees of the same frames: one with ``seg/``, one without."""
    base = tmp_path_factory.mktemp("tum_io")
    with_seg, no_seg = str(base / "with_seg"), str(base / "no_seg")
    meta = write_tum_fixture(with_seg, n_frames=N_FRAMES, device=CPU)
    write_tum_fixture(no_seg, n_frames=N_FRAMES, write_seg=False,
                      device=CPU)
    return {"with_seg": with_seg, "no_seg": no_seg}, meta


def _tree(trees, case, dst):
    """A copy of the case's tree under ``dst``."""
    src = trees[0]["no_seg" if case == "no_seg" else "with_seg"]
    shutil.copytree(src, dst)
    if case == "one_mask_missing":
        seq = ttum.load_sequence(dst)
        os.remove(os.path.join(dst, seq.seg_files[MISSING]))
    return dst


def _rule_masks(root):
    """Each frame's mask by the segmentation rule, from images the plain
    codec decodes: the ``seg/`` mask, else the classical segmenter's."""
    seq = ttum.load_sequence(root)
    out = []
    for i, f in enumerate(seq.rgb_files):
        seg = seq.seg_files[i] if seq.seg_files else None
        if seg:
            out.append(png.read_png(os.path.join(root, seg)) > 127)
        else:
            rgb = png.read_png(os.path.join(root, f))
            out.append(classical_ground_mask(torch.as_tensor(rgb)).numpy())
    return out


def _run(root, meta, monkeypatch, odometry="gt_perturb"):
    """The runner over ``root``: (summary, out, paths decoded, masks
    handed to the frame step)."""
    decoded, masks = [], []
    load, make = ttum.load_image, offline.make_frame_fn

    def spy_load(seq, rel):
        decoded.append(rel)
        return load(seq, rel)

    def spy_make(*args, **kw):
        step = make(*args, **kw)

        def frame(state, xs):
            masks.append(xs[0].cpu().numpy().copy())
            return step(state, xs)

        return frame

    cfg = tconfig.get_config(
        "tum_fr3", sequence_dir=root, fx=meta["fx"], fy=meta["fy"],
        cx=meta["cx"], cy=meta["cy"], height=meta["height"],
        width=meta["width"])
    cfg = cfg._replace(
        slam=cfg.slam._replace(window_size=4, max_landmarks=32,
                               kf_trans=0.05, kf_rot=0.05, gn_iters=3),
        popup=PopupConfig(min_cols=6, smooth_radius=2, nms_radius=4),
        out_trajectory="", metrics_path="")
    out = {}
    with monkeypatch.context() as m:
        m.setattr(ttum, "load_image", spy_load)
        m.setattr(offline, "make_frame_fn", spy_make)
        summary = tum_runner.run_tum_sequence(cfg, odometry=odometry,
                                              device=CPU, out=out)
    return summary, out, decoded, masks


def _assert_same_run(a, b):
    (sa, oa), (sb, ob) = a, b
    for k in ("est_R", "est_t", "kf_R", "kf_t"):
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    for k in ("frames", "n_keyframes", "ate_rmse_m", "ate_filter_rmse_m",
              "pose_trans_std_m", "pose_rot_std_rad"):
        assert sa[k] == sb[k], k


@pytest.mark.parametrize("case", ["with_seg", "no_seg", "one_mask_missing"])
def test_decodes_only_what_each_frame_reads(case, trees, tmp_path,
                                            monkeypatch):
    root = _tree(trees, case, str(tmp_path / "tree"))
    seq = ttum.load_sequence(root)
    summary, out, decoded, masks = _run(root, trees[1], monkeypatch)
    run = range(1, N_FRAMES)            # frame 0 is the start pose
    rgb = {"with_seg": [], "no_seg": list(run),
           "one_mask_missing": [MISSING]}[case]
    seg = [] if case == "no_seg" else [i for i in run if i not in rgb]
    assert decoded == [seq.rgb_files[i] if i in rgb else seq.seg_files[i]
                       for i in run]
    assert summary["decoded"] == {"rgb": len(rgb), "seg": len(seg)}
    assert summary["stage_timing"]["io"]["count"] == N_FRAMES - 1

    rule = _rule_masks(root)
    assert len(masks) == N_FRAMES - 1
    for i, m in zip(run, masks):
        np.testing.assert_array_equal(m, rule[i], err_msg=f"frame {i}")

    # the same run over a tree whose seg/ holds the rule's every mask
    ref_root = str(tmp_path / "rule_tree")
    shutil.copytree(root, ref_root)
    os.makedirs(os.path.join(ref_root, "seg"), exist_ok=True)
    for f, m in zip(seq.rgb_files, rule):
        png.write_png(os.path.join(ref_root, "seg", os.path.basename(f)),
                      m.astype(np.uint8) * np.uint8(255))
    ref, ref_out, ref_decoded, _ = _run(ref_root, trees[1], monkeypatch)
    assert ref["decoded"] == {"rgb": 0, "seg": N_FRAMES - 1}
    assert ref_decoded == [ttum.load_sequence(ref_root).seg_files[i]
                           for i in run]
    _assert_same_run((summary, out), (ref, ref_out))


@pytest.mark.parametrize("odometry", ["gt_perturb", "plane_vo"])
def test_undecodable_rgb_beside_masks_raises_nothing(odometry, trees,
                                                     tmp_path, monkeypatch):
    """Every RGB file replaced by bytes that are no PNG: a tree with a
    mask for every frame runs as before, decoding no RGB image; the
    frame without a mask still reads its RGB file and raises."""
    intact = _run(trees[0]["with_seg"], trees[1], monkeypatch, odometry)
    root = _tree(trees, "with_seg", str(tmp_path / "tree"))
    seq = ttum.load_sequence(root)
    for f in seq.rgb_files:
        with open(os.path.join(root, f), "wb") as fh:
            fh.write(b"not a png")
    broken = _run(root, trees[1], monkeypatch, odometry)
    assert broken[0]["decoded"] == {"rgb": 0, "seg": N_FRAMES - 1}
    assert not any(p.startswith("rgb") for p in broken[2])
    _assert_same_run(intact[:2], broken[:2])

    os.remove(os.path.join(root, seq.seg_files[MISSING]))
    with pytest.raises(RuntimeError):
        _run(root, trees[1], monkeypatch, odometry)
