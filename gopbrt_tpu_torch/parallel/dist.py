"""Process-group bring-up for the multi-rank render, on ``torch.distributed``.

Counterpart of ``gopbrt_tpu/parallel/dist.py`` (``init_distributed``).  The
reference brings up ``jax.distributed`` from a coordinator address; here the
group comes from the environment ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) or from explicit arguments::

    from gopbrt_tpu_torch.parallel.dist import init_distributed
    init_distributed(init_method="tcp://localhost:29500", rank=r, world_size=n)

``parallel/shard.py`` re-exports it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from gopbrt_tpu_torch import resolve_device

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def local_device(device=None) -> torch.device:
    """The device this rank renders on: ``None`` or ``"cuda"`` without an
    index means ``cuda:(local rank % device count)``, the local rank from
    ``LOCAL_RANK`` (else the global rank, else 0); raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = os.environ.get("LOCAL_RANK")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(rank) % torch.cuda.device_count())


def init_distributed(init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, backend: str | None = None,
                     device=None) -> bool:
    """Bring up the default process group of ``torch.distributed``.

    From explicit ``init_method`` / ``rank`` / ``world_size`` (any URL
    ``init_process_group`` takes: ``tcp://host:port``, ``file:///path``), or
    from the environment ``torchrun`` sets.  Returns False when neither is
    given (a single-process run: the mesh is world 1), True when a group is
    up, already or now.  ``backend`` defaults to ``"nccl"`` for the card and
    ``"gloo"`` for ``device="cpu"``; a backend that fails raises and is not
    swapped for another.  On the card the rank's device is made current.
    """
    if dist.is_initialized():
        return True
    if init_method is None and not all(os.environ.get(k) for k in _ENV):
        return False
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(device))
    return True
