"""Process-group setup for ranks started outside this package.

Port of srrg2_proslam_tpu/parallel/multihost.py.  Every rank runs the same
program; ``initialize`` joins it to a torch.distributed process group, and
``global_mesh`` is the 1-D mesh over all ranks.  Host-side control (the
status machine, splits, closure decisions) is deterministic given
replicated packets, so the ranks stay in lockstep without extra
coordination; a rank that diverges fails at the process group's timeout
instead of hanging.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch.distributed as dist

from .spmd import Mesh, backend_for, make_mesh, rank_device

DEFAULT_TIMEOUT_S = 120.0


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, device="cuda") -> None:
    """Join this process to the process group.

    ``coordinator_address`` is ``host:port`` of a TCP store (rank 0 serves
    it) or a ``file://`` path of a FileStore; with no arguments the
    environment's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE`` are read.  ``backend`` defaults to NCCL when each rank
    of this host has a card of its own and gloo otherwise (ranks sharing a
    card, or ``device="cpu"``).  Every collective fails after ``timeout_s``.
    """
    if coordinator_address is None:
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
        init_method = "env://"
    elif coordinator_address.startswith("file://"):
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = backend_for(num_processes, rank_device(process_id, device))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))


def global_mesh(axis: str = "d", device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the group: rank r on
    ``cuda:(r % device_count)``, or on the CPU with ``device="cpu"``."""
    return make_mesh([rank_device(r, device) for r in range(dist.get_world_size())], axis)


def is_coordinator() -> bool:
    return dist.get_rank() == 0
