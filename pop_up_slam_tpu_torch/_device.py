"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None, *like) -> torch.device:
    """The device an entry point runs on.

    An explicit ``device`` wins; otherwise the first torch tensor among
    ``like`` decides; otherwise ``cuda``.  Raises when the result is a
    CUDA device and no GPU is present, so nothing falls back to the CPU
    without being asked.
    """
    if device is None:
        for x in like:
            if isinstance(x, torch.Tensor):
                device = x.device
                break
        else:
            device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pop_up_slam_tpu_torch: no CUDA device is available; pass "
            "device='cpu' (or CPU tensors) to run on the CPU"
        )
    return device


def const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device`` without a host sync: the
    host-to-device copy is issued ``non_blocking`` (a plain ``.to(cuda)``
    of pageable memory is followed by a stream synchronize)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (numpy, python or tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)
