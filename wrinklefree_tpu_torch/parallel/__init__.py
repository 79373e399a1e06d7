"""Parallelism on ``torch.distributed`` (PyTorch port of
``wrinklefree_tpu/parallel``): tensor and data parallelism, sharding and the
meshes, pipeline parallelism (``pipeline.py``), expert parallelism
(``expert.py``), multi-host initialization, the replica router."""

from .expert import capacity_for, ep_moe_ffn, make_ep_moe
from .multihost import global_mesh, init_multihost
from .pipeline import make_pp_forward, shard_params_pp, stage_partition_specs
from .router import ReplicaRouter
from .sharding import (
    make_mesh,
    make_named_mesh,
    make_tp_forward,
    param_partition_specs,
    repack_params_for_tp,
    shard_params,
)
