"""The scale-out layer of the port (counterpart of hand3d_tpu/parallel/):
data, tensor and spatial parallelism over a ("data", "model") or
("slice", "data", "model") mesh of torch.distributed ranks (``mesh``,
``spatial``, ``collectives``), GPipe over PoseNet's refinement units
(``pipeline``) and an expert-parallel MoE layer (``expert``).

``pipeline`` and ``expert`` import the models, and the models' ops import
this package, so their names load on first use.
"""

import importlib

from hand3d_tpu_torch.parallel.mesh import (batch_shard_count,
                                            batch_sharding, gather_params,
                                            init_distributed, make_mesh,
                                            make_multislice_mesh,
                                            param_sharding, rank_device,
                                            replicate, shard_params,
                                            shard_rows, spatial_constrainer)

_LAZY = {
    "make_pipeline_mesh": "pipeline",
    "posenet_pipeline_loss": "pipeline",
    "refine_param_sharding": "pipeline",
    "stack_refinement_params": "pipeline",
    "unstack_refinement_params": "pipeline",
    "expert_param_sharding": "expert",
    "make_expert_mesh": "expert",
    "moe_dense_apply": "expert",
    "moe_dense_init": "expert",
}

__all__ = [
    "make_mesh",
    "make_multislice_mesh",
    "init_distributed",
    "make_pipeline_mesh",
    "make_expert_mesh",
    "batch_sharding",
    "expert_param_sharding",
    "moe_dense_apply",
    "moe_dense_init",
    "param_sharding",
    "posenet_pipeline_loss",
    "refine_param_sharding",
    "replicate",
    "shard_params",
    "stack_refinement_params",
    "unstack_refinement_params",
    # the port's own
    "batch_shard_count",
    "gather_params",
    "rank_device",
    "shard_rows",
    "spatial_constrainer",
]


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(
            f"hand3d_tpu_torch.parallel.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(
        f"module 'hand3d_tpu_torch.parallel' has no attribute {name!r}")
