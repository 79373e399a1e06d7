"""Multi-host process-group initialization and the global mesh (PyTorch port).

Counterpart of ``wrinklefree_tpu/parallel/multihost.py``. The reference forms
its process group with ``jax.distributed.initialize()``; here the default
``torch.distributed`` group is formed from the environment that ``torchrun``
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), and the global mesh puts the model axis innermost, so that a
model group is the consecutive ranks of one host (``torchrun`` numbers a
host's ranks consecutively) and its collectives stay on that host's links,
while the data axis spans hosts.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def init_multihost(backend: Optional[str] = None) -> Tuple[int, int]:
    """Initialize the default process group from ``torchrun``'s environment;
    returns (rank, world size). A no-op returning (0, 1) on a single process
    (no ``WORLD_SIZE``, or 1); if the group is already initialized, its rank
    and size. ``backend`` defaults to NCCL when CUDA is available, gloo
    otherwise; the rendezvous is ``env://`` (``MASTER_ADDR``/``MASTER_PORT``)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = _int_env("WORLD_SIZE")
    if world is None or world <= 1:
        return 0, 1
    rank = _int_env("RANK")
    if rank is None:
        raise ValueError("WORLD_SIZE is set without RANK: start the ranks with torchrun")
    be = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if be == "nccl":
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device((rank if local is None else local) % torch.cuda.device_count())
    dist.init_process_group(be, init_method="env://", rank=rank, world_size=world)
    logger.info("multihost: rank %d/%d (%s), local rank %s", rank, world, be,
                os.environ.get("LOCAL_RANK"))
    return rank, world


def global_mesh(dp: Optional[int] = None, tp: Optional[int] = None, **mesh_kw):
    """This rank's mesh over every rank of the default group (all hosts),
    model axis innermost (``parallel.sharding.make_mesh``). Defaults: tp =
    the ranks on this host (``LOCAL_WORLD_SIZE``, else the CUDA device count,
    else 1), dp = world / tp. Raises ``ValueError`` if dp * tp is not the
    world size."""
    from .sharding import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        tp = _int_env("LOCAL_WORLD_SIZE") or max(1, torch.cuda.device_count())
        tp = min(tp, world)
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp*tp = {dp}*{tp} != {world} ranks")
    return make_mesh(dp, tp, **mesh_kw)
