"""Odometry sources for the SLAM front-end: ``plane_vo``, frame-to-frame
plane-alignment visual odometry."""

from .plane_vo import (  # noqa: F401
    PlaneVOConfig,
    PlaneVOResult,
    align_planes,
    match_planes,
    plane_vo_step,
)
