"""K2: dense depth render of the popped-up plane model (CUDA) and its
plain PyTorch version.

Replaces ``pop_up_slam_tpu/ops/depth_render.py::depth_render_pallas``.
The CUDA kernel (``csrc/depth_render.cu``) is one wave of blocks (at most
two per SM) walking the row-major image with a grid-stride loop, four
pixels per thread and step: one 4-byte mask load and one 16-byte depth
store, scalar for the last ``H*W % 4`` pixels.  Each block's prologue
stages the camera, pose, ground plane and per-wall terms in shared memory
(one thread per wall, from the pop-up's own tensors), so a render is one
launch with no parameter packing; ground pixels skip the wall loop.  It
is memory- and launch-bound (0.3 MB of mask read, 1.2 MB of depth written
per 480x640 frame); it reads and writes each pixel once, coalesced.  The
plain version is :func:`..popup.popup.depth_from_popup`.
"""

from __future__ import annotations

import torch

from ._build import check, library


def _operand(x: torch.Tensor, shape, dtype, dev, name: str) -> torch.Tensor:
    if x.device != dev:
        raise ValueError(f"depth_render: {name} on {x.device}, mask on {dev}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"depth_render: {name} has shape {tuple(x.shape)}, "
                         f"want {tuple(shape)}")
    if x.dtype != dtype:
        raise ValueError(f"depth_render: {name} must be {dtype}")
    return x.contiguous()


def depth_render(K, res, ground_mask: torch.Tensor, R_wc: torch.Tensor,
                 t_wc: torch.Tensor, max_depth: float = 50.0,
                 wall_height: float = 2.5,
                 extent_pad: float = 0.5) -> torch.Tensor:
    """Depth (H, W) f32.  CUDA tensors launch the kernel; CPU tensors run
    the plain version, :func:`..popup.popup.depth_from_popup`."""
    if ground_mask.device.type == "cpu":
        from ..popup.popup import depth_from_popup

        return depth_from_popup(K, res, ground_mask, R_wc, t_wc,
                                max_depth=max_depth, wall_height=wall_height,
                                extent_pad=extent_pad)
    dev = ground_mask.device
    if dev.type != "cuda":
        raise ValueError(f"depth_render: unsupported device {dev}")
    if ground_mask.dtype != torch.bool or ground_mask.ndim != 2:
        raise ValueError("depth_render: ground_mask must be (H, W) bool")
    if not ground_mask.is_contiguous():
        raise ValueError("depth_render: ground_mask must be contiguous")
    H, W = ground_mask.shape
    S = res.planes_w.shape[0]
    f32, b8 = torch.float32, torch.bool
    ins = [_operand(x, (), f32, dev, n)
           for x, n in zip(K, ("fx", "fy", "cx", "cy"))]
    ins += [
        _operand(R_wc, (3, 3), f32, dev, "R_wc"),
        _operand(t_wc, (3,), f32, dev, "t_wc"),
        _operand(res.ground_c, (4,), f32, dev, "ground_c"),
        _operand(res.planes_w, (S, 4), f32, dev, "planes_w"),
        _operand(res.endpoints_w, (S, 2, 3), f32, dev, "endpoints_w"),
        _operand(res.clipped, (S, 2), b8, dev, "clipped"),
        _operand(res.valid, (S,), b8, dev, "valid"),
    ]
    out = torch.empty((H, W), dtype=f32, device=dev)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    depth_render.launches += 1
    check(lib.popup_depth_render(
        *(x.data_ptr() for x in ins), S, ground_mask.data_ptr(),
        out.data_ptr(), H, W, float(max_depth), float(wall_height),
        float(extent_pad), stream), "depth_render")
    return out


depth_render.launches = 0
