"""Tensor and data parallelism on ``torch.distributed`` (PyTorch port of
``wrinklefree_tpu/parallel``): sharding and the mesh, multi-host
initialization, the replica router. Pipeline and expert parallelism
(``pipeline.py``, ``expert.py``) are not ported yet (ROADMAP item 12b)."""

from .multihost import global_mesh, init_multihost
from .router import ReplicaRouter
from .sharding import (
    make_mesh,
    make_tp_forward,
    param_partition_specs,
    repack_params_for_tp,
    shard_params,
)
