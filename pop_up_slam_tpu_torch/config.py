"""Single config tree + the five presets.

Port of ``pop_up_slam_tpu/config.py`` over the port's ``SlamConfig``,
``PopupConfig`` and ``AssocConfig``: one NamedTuple tree, named
presets, CLI overrides.  Field names, defaults and presets are the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple

from .assoc import AssocConfig  # noqa: F401
from .pipeline.slam import SlamConfig
from .popup.popup import PopupConfig


class RunConfig(NamedTuple):
    name: str = "corridor"
    mode: str = "synthetic"        # synthetic | popup_demo | tum | distributed
    # camera (fr3 defaults; overridden per dataset)
    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    height: int = 480
    width: int = 640
    # synthetic sequence
    n_frames: int = 60
    odom_sigma_t: float = 0.02
    odom_sigma_r: float = 0.005
    seed: int = 0
    # components
    slam: SlamConfig = SlamConfig()
    popup: PopupConfig = PopupConfig()
    # distributed
    n_devices: int = 0             # 0 = all local devices
    # io
    sequence_dir: str = ""
    out_trajectory: str = ""
    metrics_path: str = ""
    profile_dir: str = ""
    # checkpoint / resume
    checkpoint_path: str = ""     # where to snapshot solver state (.npz)
    checkpoint_every: int = 0     # snapshot every N frames (0 = end only)
    resume: str = ""              # restore from this snapshot and continue


def _popup_demo() -> RunConfig:
    """Single-image pop-up + depth recovery."""
    return RunConfig(name="popup_demo", mode="popup_demo", n_frames=1)


def _corridor() -> RunConfig:
    """Synthetic corridor pose-graph + plane landmarks."""
    return RunConfig(
        name="corridor", mode="synthetic", n_frames=60,
        slam=SlamConfig(window_size=6, max_landmarks=32, max_det=9,
                        kf_trans=0.3, gn_iters=3),
    )


def _tum_fr3() -> RunConfig:
    """Full monocular plane SLAM on TUM fr3_structure_notexture_far
    (one device)."""
    return RunConfig(
        name="tum_fr3", mode="tum",
        sequence_dir="data/rgbd_dataset_freiburg3_structure_notexture_far",
        slam=SlamConfig(window_size=8, max_landmarks=64, max_det=9,
                        kf_trans=0.15, kf_rot=0.1, gn_iters=4),
        popup=PopupConfig(max_segments=8, min_cols=16),
    )


def _single_host() -> RunConfig:
    """Sliding-window BA on all the devices of one host (data-parallel
    front end + factor-sharded Schur, ``pipeline/sharded.py``)."""
    return RunConfig(
        name="single_host", mode="distributed", n_frames=64,
        slam=SlamConfig(window_size=8, max_landmarks=64, max_det=9),
    )


def _multi_host() -> RunConfig:
    """Distributed Schur across 2+ hosts: the same runner as
    ``single_host``, over the flattened host mesh."""
    return RunConfig(
        name="multi_host", mode="distributed", n_frames=128,
        slam=SlamConfig(window_size=12, max_landmarks=128, max_det=9),
    )


PRESETS = {
    "popup_demo": _popup_demo,
    "corridor": _corridor,
    "tum_fr3": _tum_fr3,
    "single_host": _single_host,
    "multi_host": _multi_host,
}


def get_config(name: str, **overrides) -> RunConfig:
    cfg = PRESETS[name]()
    if overrides:
        cfg = cfg._replace(**overrides)
    return cfg
