"""The windowed factor graph as the CUDA kernels K1, K6 and K7 receive it.

One packing of the window's masks and the factors (:func:`pack`) and one
call of a kernel's C entry (:func:`_launch`): a pointer, an int and a
float table, the shared slots first (``make_problem`` in
``csrc/factor_graph.cuh``), then the kernel's own.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..factors.graph import Factors, Window
from ..factors.robust import RobustConfig
from ._build import check, check_inputs

MAX_SMEM = 232448   # bytes of shared memory one H100 block may use
_KINDS = {"none": 0, "huber": 1, "cauchy": 2}


class Packed(NamedTuple):
    """The factors as the kernels read them, packed once a call."""

    tensors: tuple   # the shared slots after the window's R, t, planes
    ints: tuple      # W, L, F, O, P, sqrt-info strides, robust kinds
    floats: tuple    # (k, k^2, 2k) of the odometry, plane, prior kernels


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    return (x if x.dtype == dtype else x.to(dtype)).contiguous()


def _sqrt_rows(A: torch.Tensor, n: int, d: int):
    """(tensor, row stride) of a stack of n (d, d) sqrt-info matrices: one
    matrix read n times where it is broadcast (stride 0, as the frame step
    builds them), else contiguous rows."""
    if n > 0 and A.stride() == (0, d, 1):
        return A[0], 0
    return _as(A, torch.float32).reshape(n, d, d), d * d


def pack(window: Window, factors: Factors,
         robust: RobustConfig | None = None) -> Packed | None:
    """The kernels' view of ``factors`` and the window's masks (None for
    CPU tensors): no copy where they are contiguous and of the kernels'
    dtypes already.  k^2 and 2k are taken in double and rounded to f32
    once, as ``factors/robust.py`` rounds them."""
    dev = window.t.device
    if dev.type != "cuda":
        return None
    if robust is None:
        robust = RobustConfig()
    od, pf, pr = factors
    W, L = window.window_size, window.max_landmarks
    F, O, P = pf.valid.shape[0], od.valid.shape[0], pr.valid.shape[0]
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    pf_A, pf_As = _sqrt_rows(pf.sqrt_info, F, 3)
    od_A, od_As = _sqrt_rows(od.sqrt_info, O, 6)
    pr_A, pr_As = _sqrt_rows(pr.sqrt_info, P, 6)
    specs = (
        (_as(window.pose_valid, b), (W,), b),
        (_as(window.pose_fixed, b), (W,), b),
        (_as(window.lm_valid, b), (L,), b),
        (_as(pf.pose_idx, i32), (F,), i32), (_as(pf.lm_idx, i32), (F,), i32),
        (_as(pf.pi_meas, f32), (F, 4)),
        (pf_A, (3, 3) if pf_As == 0 else (F, 3, 3)),
        (_as(pf.valid, b), (F,), b),
        (_as(od.i, i32), (O,), i32), (_as(od.j, i32), (O,), i32),
        (_as(od.R_meas, f32), (O, 3, 3)), (_as(od.t_meas, f32), (O, 3)),
        (od_A, (6, 6) if od_As == 0 else (O, 6, 6)),
        (_as(od.valid, b), (O,), b),
        (_as(pr.idx, i32), (P,), i32),
        (_as(pr.R, f32), (P, 3, 3)), (_as(pr.t, f32), (P, 3)),
        (pr_A, (6, 6) if pr_As == 0 else (P, 6, 6)),
        (_as(pr.valid, b), (P,), b),
    )
    check_inputs("pack", dev, *specs)
    kinds, consts = [], []
    for kern in robust:
        if kern.kind not in _KINDS:
            raise ValueError(f"unknown robust kernel '{kern.kind}'")
        k = float(kern.scale)
        kinds.append(_KINDS[kern.kind])
        consts += [k, k * k, 2.0 * k]
    return Packed(tuple(s[0] for s in specs),
                  (W, L, F, O, P, pf_As, od_As, pr_As, *kinds), tuple(consts))


def check_window(name: str, window: Window) -> None:
    """Raise unless the window's R, t and planes are f32, contiguous and
    of its sizes, on its device."""
    W, L = window.window_size, window.max_landmarks
    check_inputs(name, window.t.device, (window.R, (W, 3, 3)),
                 (window.t, (W, 3)), (window.planes, (L, 4)))


def _launch(fn, what: str, window: Window, packed: Packed, own, ints=(),
            floats=()) -> None:
    """Call a kernel's C entry with the shared slots (the window's R, t,
    planes, then ``packed``), the kernel's own pointers (None: null) and
    the integer and float parameters."""
    ptrs = [window.R.data_ptr(), window.t.data_ptr(), window.planes.data_ptr()]
    ptrs += [x.data_ptr() for x in packed.tensors]
    ptrs += [None if x is None else x.data_ptr() for x in own]
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    n = (ctypes.c_int * (len(packed.ints) + len(ints)))(*packed.ints, *ints)
    x = (ctypes.c_float * (len(packed.floats) + len(floats)))(
        *packed.floats, *floats)
    stream = torch.cuda.current_stream(window.t.device).cuda_stream
    check(fn(ctypes.addressof(p), ctypes.addressof(n), ctypes.addressof(x),
             stream), what)
