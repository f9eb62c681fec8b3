"""Multi-process setup: ``torch.distributed`` bring-up and host-aware meshes.

Port of ``pop_up_slam_tpu/parallel/multihost.py``.  One process per GPU
(``torchrun`` starts them); NCCL carries the collectives between GPUs,
gloo between CPU processes.

- :func:`init_distributed` joins this process to the process group
  (idempotent; a no-op for a single process started without a
  launcher).
- :func:`make_host_mesh` builds a ("host", "chip") 2-D
  :class:`~torch.distributed.device_mesh.DeviceMesh`: ranks of one host
  (``LOCAL_WORLD_SIZE`` of them, as ``torchrun`` sets it) share a row;
  :func:`flat_mesh_axis` is the 1-D mesh over the world that the
  solvers take.

The runtime is not elastic, as the reference's: the process set is fixed
at :func:`init_distributed`, a lost rank fails the job's collectives, and
recovery is a restart from a checkpoint (``utils/checkpoint.py``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve_device


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for a CUDA device given
    without an index (``cuda`` is the default), else ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> None:
    """Join the process group (idempotent).

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when present and is
    otherwise a no-op.  Explicit arguments bring a group up by hand:
    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous.  The
    backend is NCCL for a CUDA ``device`` (the default), gloo for the
    CPU.  A failed rendezvous raises."""
    if dist.is_initialized():
        return
    if num_processes is None and coordinator_address is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("init_distributed: give coordinator_address, "
                             "num_processes and process_id together")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev), init_method=init_method,
                            world_size=world, rank=rank)


def _mesh(device_type: str, ranks: torch.Tensor, names) -> DeviceMesh:
    if device_type == "cuda" and not torch.cuda.is_initialized():
        torch.cuda.set_device(rank_device("cuda"))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh(axis_host: str = "host",
                   axis_chip: str = "chip") -> DeviceMesh:
    """(hosts, ranks per host) mesh over the world, ranks in order: a
    host's ranks are consecutive (``LOCAL_WORLD_SIZE`` of them; all of
    them without a launcher)."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"{per_host} ranks per host")
    grid = torch.arange(world).reshape(world // per_host, per_host)
    return _mesh(_device_type(), grid, (axis_host, axis_chip))


def flat_mesh_axis(axis: str = "d") -> DeviceMesh:
    """1-D mesh over the world (host-grouped rank order)."""
    return _mesh(_device_type(), torch.arange(dist.get_world_size()),
                 (axis,))
