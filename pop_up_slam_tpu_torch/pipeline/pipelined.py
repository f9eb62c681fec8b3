"""Pipelined front-end/back-end execution (the PP analog).

Port of ``pop_up_slam_tpu/pipeline/pipelined.py``: the front-end stage
(pop-up plane extraction on the mask) and the back-end stage
(association + windowed BA, K1 on CUDA) are separate, and the loop
issues the front end of frame t+1 before it waits for the back end of
frame t.

- On one card the front end (``make_stages``' ``front_end``) runs on a
  side CUDA stream, so its kernels overlap the back end's on the current
  stream.  The side stream waits for the state's last update
  (``wait_stream``); the detections cross back behind an event recorded
  on the side stream (``wait_event``).  The detections and the mask,
  used on a stream other than the one they were allocated on, are marked
  with ``record_stream``, and the state the side stream reads is kept
  alive until the back end has waited on that event, so the caching
  allocator cannot hand their memory out early.
- With ``fe_device`` and ``be_device`` two devices, the front end runs
  on ``fe_device`` (on a side stream there when it is a card) and the
  detections are copied to ``be_device`` with ``non_blocking=True``
  behind the same event.

``stale_prediction=False`` is bit-identical to the sequential frame loop
(:func:`.offline.make_frame_fn`): the schedule changes, the arithmetic
does not.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import torch

from .._device import as_tensor
from ..geometry.camera import Intrinsics
from ..popup import popup as pp
from .slam import (
    FrameDetections,
    SlamConfig,
    SlamState,
    current_pose,
    detections_from_popup,
    slam_step,
)


def _to(x, device, non_blocking: bool = False):
    """A tensor or a (Named)tuple of tensors on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=non_blocking)
    vals = (_to(v, device, non_blocking) for v in x)
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _tensors(v)]


def make_stages(K: Intrinsics, pcfg: pp.PopupConfig, scfg: SlamConfig,
                fe_device=None, be_device=None):
    """The two pipeline stages:

    - ``front_end(state, mask) -> FrameDetections``: the pop-up at
      ``current_pose(state)`` (the sequential runner's prediction), on
      ``fe_device`` (default: the state's device);
    - ``back_end(state, det, oR, ot) -> (state, (R, t))``: association +
      BA, on ``be_device`` (default: the state's device)."""

    def front_end(state: SlamState, mask) -> FrameDetections:
        pred = current_pose(state)
        dev = torch.device(fe_device) if fe_device is not None \
            else pred[1].device
        pred_R, pred_t = _to(pred, dev, non_blocking=True)
        res = pp.pop_up(_to(K, dev), as_tensor(mask, dev, torch.bool),
                        pred_R, pred_t, pcfg)
        return detections_from_popup(res, pred_R, pred_t, scfg.max_det)

    def back_end(state: SlamState, det: FrameDetections, odom_R, odom_t):
        if be_device is not None:
            state = _to(state, be_device)
        dev = state.window.t.device
        return slam_step(state, _to(det, dev),
                         as_tensor(odom_R, dev, torch.float32),
                         as_tensor(odom_t, dev, torch.float32), scfg)

    return front_end, back_end


class _Front:
    """Runs ``front_end`` for one frame and lands its detections on the
    back end's device and stream (see the module docstring)."""

    def __init__(self, front_end, fe: torch.device, be: torch.device):
        self.front_end, self.fe, self.be = front_end, fe, be
        self.side = torch.cuda.Stream(fe) if fe.type == "cuda" else None

    def issue(self, state: SlamState, mask):
        """Start ``mask``'s front end at ``current_pose(state)``.  Returns
        a handle for :meth:`land`."""
        if self.side is None:
            return self.front_end(state, mask), None, None
        # the side stream starts after what the current streams queued
        # (the state's last update, a mask already on the card)
        self.side.wait_stream(torch.cuda.current_stream(self.fe))
        if self.be.type == "cuda" and self.be != self.fe:
            self.side.wait_stream(torch.cuda.current_stream(self.be))
        if isinstance(mask, torch.Tensor) and mask.device == self.fe:
            mask.record_stream(self.side)
        with torch.cuda.stream(self.side):
            det = self.front_end(state, mask)
            done = torch.cuda.Event()
            done.record(self.side)
        # the handle keeps ``state`` alive: the side stream reads it, and
        # its memory may be reused only once the back end waits on ``done``
        return det, done, state

    def land(self, handle) -> FrameDetections:
        """The detections on the back end's device, ordered after the
        front end's kernels on the back end's stream."""
        det, done, _ = handle
        if done is None:
            return _to(det, self.be)
        if self.be.type != "cuda":
            done.synchronize()
            return _to(det, self.be)
        be_stream = torch.cuda.current_stream(self.be)
        be_stream.wait_event(done)
        if self.be == self.fe:
            # allocated on the side stream, read on the back end's
            for x in _tensors(det):
                x.record_stream(be_stream)
            return det
        with torch.cuda.stream(self.side):
            return _to(det, self.be, non_blocking=True)


def run_pipelined(
    state: SlamState,
    frames: Iterable,                 # yields (mask, odom_R, odom_t)
    K: Intrinsics,
    pcfg: pp.PopupConfig,
    scfg: SlamConfig,
    fe_device=None,
    be_device=None,
    stale_prediction: bool = True,
) -> Iterator[tuple]:
    """Drive the two-stage pipeline; yields (R, t) per frame.

    ``stale_prediction=True`` (the real pipeline): the front end of frame
    t+1 pops up at the pose prediction before frame t's BA has landed, so
    the two stages have no data dependency and overlap, with the
    one-update-stale prediction of a tracking/mapping split.

    ``stale_prediction=False``: the front end of t+1 waits for the back
    end of t: bit-identical to the sequential frame loop, no overlap.

    The back end runs on ``be_device`` (default: the state's device), the
    front end on ``fe_device`` (default: the back end's)."""
    be = torch.device(be_device) if be_device is not None \
        else state.window.t.device
    fe = torch.device(fe_device) if fe_device is not None else be
    state = _to(state, be)
    front_end, back = make_stages(_to(K, fe), pcfg, scfg, fe, be)
    front = _Front(front_end, fe, be)

    it = iter(frames)
    try:
        mask, oR, ot = next(it)
    except StopIteration:
        return
    pending = (front.issue(state, mask), oR, ot)     # warm the pipe

    for n_mask, n_oR, n_ot in it:
        handle, oR, ot = pending
        if stale_prediction:
            # front(t+1) reads the state before back(t): the two overlap
            n_handle = front.issue(state, n_mask)
            state, pose = back(state, front.land(handle), oR, ot)
        else:
            state, pose = back(state, front.land(handle), oR, ot)
            n_handle = front.issue(state, n_mask)
        pending = (n_handle, n_oR, n_ot)
        yield pose

    handle, oR, ot = pending                         # drain the pipe
    state, pose = back(state, front.land(handle), oR, ot)
    yield pose
