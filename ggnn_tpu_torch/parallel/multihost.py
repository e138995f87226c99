"""Multi-process bootstrap on ``torch.distributed``.

Every process runs the same program; :func:`initialize_multihost` is the
rendezvous (``init_process_group`` over TCP), driven by the environment
``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) or by its arguments.  Its timeout is the
liveness check: a rank that misses the rendezvous fails the job rather
than hanging it.  Recovery is the reference's: deterministic resumable
training from the last checkpoint (:mod:`ggnn_tpu_torch.train.checkpoint`).

Each rank's device is ``cuda:{LOCAL_RANK % device_count}``
(:func:`rank_device`); without a card that raises unless the caller asks
for the CPU.  NCCL takes one rank per device: ranks that share a card run
over ``gloo`` (the collectives of :mod:`~ggnn_tpu_torch.parallel.comm`
stage CUDA tensors through pinned host memory for it).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ggnn_tpu_torch.models.init import device_or_raise


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given (a CUDA one raises without
    a card), else ``cuda:{LOCAL_RANK % device_count}``, raising without a
    card; the CPU only when asked for."""
    if device is not None:
        return device_or_raise(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available "
                           "(torch.cuda.is_available() is false); pass "
                           "device='cpu' to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         init_timeout_s: int = 300,
                         backend: Optional[str] = None,
                         device=None) -> bool:
    """Join the ``torch.distributed`` world; a no-op with one process.

    Returns True when running multi-process (or when a coordinator was
    named: a world of one).  ``coordinator_address`` is ``host:port``
    (default ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (``WORLD_SIZE``), ``process_id`` the rank (``RANK``); ``init_timeout_s``
    is the rendezvous' timeout (a missing rank raises
    ``torch.distributed.DistError`` after it).  ``backend`` defaults to
    ``nccl`` on a CUDA ``device`` (:func:`rank_device`) and ``gloo`` on the
    CPU or where this host's ranks (``LOCAL_WORLD_SIZE``, else all
    ``num_processes``) outnumber its cards: NCCL takes one rank per
    device.  The one named is the one used."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, "
                         "the number of processes and this process's id "
                         "(arguments or MASTER_ADDR/MASTER_PORT, WORLD_SIZE, "
                         "RANK)")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        backend = ("nccl" if device.type == "cuda"
                   and local <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=init_timeout_s))
    return True


def is_primary() -> bool:
    """Rank 0 (or a single process): metrics aggregation, checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0
