"""Process-group bootstrap for multi-process runs (PyTorch port of
gradslam_tpu.parallel.multihost).

Every process runs the same program and drives one device. A run joins its
processes with ``torch.distributed.init_process_group``; the mesh helpers
of :mod:`gradslam_tpu_torch.parallel.mesh` then lay the ranks out over the
``(data, map)`` axes.

    from gradslam_tpu_torch.parallel import multihost, make_mesh

    multihost.initialize_multihost("10.0.0.1:29500", num_processes=8, process_id=rank)
    mesh = make_mesh(data=4, map_=2)

The backend is named by the caller and never chosen on its own: ``"nccl"``
across cards (the default), ``"gloo"`` for CPU tensors or for several ranks
that share one card (NCCL refuses two ranks on one GPU). Every collective
of the port is an ``all_reduce`` or a ``broadcast``, which both carry on
CUDA tensors.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

__all__ = ["initialize_multihost", "is_multihost", "host_summary"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Joins this process to the run's process group.

    Args:
        coordinator_address: ``host:port`` of rank 0's rendezvous
            (``tcp://``); None reads ``MASTER_ADDR`` / ``MASTER_PORT`` /
            ``WORLD_SIZE`` / ``RANK`` from the environment (``env://``).
        num_processes, process_id: the world size and this process's rank
            (None: ``WORLD_SIZE`` and ``RANK`` from the environment).
        backend: ``"nccl"`` (default) or ``"gloo"``.

    A no-op when the group is already initialized, or when there is nothing
    to join: no address given or in the environment and one process, as the
    JAX package's skips a single process whose rendezvous fails. An address
    with one process makes a group of one rank.
    """
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        if world == 1:
            return
        raise ValueError(f"{world} processes need a coordinator_address or MASTER_ADDR to meet at")
    kw = dict(backend=backend or "nccl")
    if coordinator_address is not None:
        addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        dist.init_process_group(init_method=addr, world_size=world, rank=rank, **kw)
    else:
        extra = {} if process_id is None else dict(rank=process_id)
        dist.init_process_group(init_method="env://", world_size=world, **extra, **kw)


def is_multihost() -> bool:
    """True when the run has more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


def host_summary() -> str:
    """One line on the process topology, in the JAX package's format: each
    process drives one device, so the global devices are the world size."""
    if not dist.is_initialized():
        return "process 0/1, 1 local / 1 global devices (none)"
    return (
        f"process {dist.get_rank()}/{dist.get_world_size()}, 1 local / "
        f"{dist.get_world_size()} global devices ({dist.get_backend()})"
    )
