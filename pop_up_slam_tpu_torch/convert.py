"""Carry state across between the JAX package and the port.

Each ``*_from_numpy`` takes the reference object's arrays as numpy
(``jax.tree.map(np.asarray, x)``) — any object with the same field
names, or a dict keyed by them — and returns the port's tuple on
``device`` with the dtypes kept (f32, int32, bool).  Each ``*_to_numpy``
returns a tuple of the same type with numpy arrays.  Nested tuples
(``Factors``, ``SlamState``, ``VOState``, ``FusedVOState``,
``RoutedFactors``) convert recursively; a state recorded at a block's
start (``block.*`` of ``corridor_ref_sharded.npz``) converts through
:func:`slam_state_from_numpy`.  No module of the JAX
package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .factors.graph import (Factors, OdomFactors, PlaneFactors, PosePriors,
                           Window)
from .fusion.depth_fusion import DepthFilter
from .geometry.camera import Intrinsics
from .mapping.landmark_store import LandmarkStore
from .parallel.keyframe_blocks import RoutedFactors
from .pipeline.offline import FusedVOState, VOState
from .pipeline.slam import FrameDetections, SlamState
from .popup.popup import PopupPlanes

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.bool_): torch.bool,
}

# nested fields: which port type each converts into
_NESTED = {
    (Factors, "odom"): OdomFactors,
    (Factors, "planes"): PlaneFactors,
    (Factors, "priors"): PosePriors,
    (SlamState, "window"): Window,
    (SlamState, "store"): LandmarkStore,
    (VOState, "slam"): SlamState,
    (FusedVOState, "vo"): VOState,
    (FusedVOState, "filt"): DepthFilter,
    (RoutedFactors, "odom"): OdomFactors,
    (RoutedFactors, "planes"): PlaneFactors,
    (RoutedFactors, "priors"): PosePriors,
}


def _from(cls, x, device):
    vals = []
    for name in cls._fields:
        v = x[name] if isinstance(x, dict) else getattr(x, name)
        sub = _NESTED.get((cls, name))
        if sub is not None:
            vals.append(_from(sub, v, device))
            continue
        a = np.asarray(v)
        dtype = _DTYPES.get(a.dtype)
        if dtype is None:
            raise TypeError(f"{cls.__name__}.{name}: dtype {a.dtype}")
        # a copy: arrays from JAX are read-only
        vals.append(torch.tensor(a).to(device=device, dtype=dtype))
    return cls(*vals)


def _to(x):
    vals = []
    for v in x:
        vals.append(_to(v) if isinstance(v, tuple)
                    else v.detach().cpu().numpy())
    return type(x)(*vals)


def intrinsics_from_numpy(x, device) -> Intrinsics:
    return _from(Intrinsics, x, device)


def window_from_numpy(x, device) -> Window:
    return _from(Window, x, device)


def factors_from_numpy(x, device) -> Factors:
    return _from(Factors, x, device)


def landmark_store_from_numpy(x, device) -> LandmarkStore:
    return _from(LandmarkStore, x, device)


def slam_state_from_numpy(x, device) -> SlamState:
    return _from(SlamState, x, device)


def popup_planes_from_numpy(x, device) -> PopupPlanes:
    return _from(PopupPlanes, x, device)


def frame_detections_from_numpy(x, device) -> FrameDetections:
    return _from(FrameDetections, x, device)


def vo_state_from_numpy(x, device) -> VOState:
    return _from(VOState, x, device)


def fused_vo_state_from_numpy(x, device) -> FusedVOState:
    return _from(FusedVOState, x, device)


def depth_filter_from_numpy(x, device) -> DepthFilter:
    return _from(DepthFilter, x, device)


def routed_factors_from_numpy(x, device) -> RoutedFactors:
    return _from(RoutedFactors, x, device)


def segnet_state_dict_from_flax(params) -> dict:
    """A flax ``SegNetLite`` parameter tree as numpy arrays (``{"params":
    {"Conv_k": {"kernel": (kh, kw, in, out), "bias": (out,)}}}``, the
    ``"params"`` level optional) -> the port module's state dict on the
    CPU (``convs.k.weight`` (out, in, kh, kw), ``convs.k.bias``)."""
    params = params.get("params", params)
    sd = {}
    for name, leaf in params.items():
        k = int(name.split("_")[1])
        kernel = np.asarray(leaf["kernel"], np.float32)
        sd[f"convs.{k}.weight"] = torch.tensor(kernel.transpose(3, 2, 0, 1))
        sd[f"convs.{k}.bias"] = torch.tensor(np.asarray(leaf["bias"],
                                                        np.float32))
    return sd


def segnet_flax_tree_from_state_dict(sd) -> dict:
    """The inverse of :func:`segnet_state_dict_from_flax`: a port
    SegNetLite state (or parameter) dict -> flax's ``{"params": {"Conv_k":
    {"bias", "kernel"}}}`` as f32 numpy."""
    convs = {}
    for name, x in sd.items():
        _, k, kind = name.split(".")
        a = x.detach().cpu().numpy().astype(np.float32)
        leaf = convs.setdefault(f"Conv_{k}", {})
        if kind == "weight":
            leaf["kernel"] = a.transpose(2, 3, 1, 0)
        else:
            leaf["bias"] = a
    return {"params": convs}


intrinsics_to_numpy = window_to_numpy = factors_to_numpy = _to
landmark_store_to_numpy = slam_state_to_numpy = _to
popup_planes_to_numpy = frame_detections_to_numpy = _to
vo_state_to_numpy = fused_vo_state_to_numpy = depth_filter_to_numpy = _to
routed_factors_to_numpy = _to
