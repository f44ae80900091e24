"""Data parallelism over torch.distributed ranks (counterpart of
hand3d_tpu/parallel/: the "data" axis of its mesh)."""

from hand3d_tpu_torch.parallel.mesh import (batch_shard_count,
                                            init_distributed, make_mesh,
                                            make_multislice_mesh,
                                            param_sharding, rank_device,
                                            shard_rows, spatial_constrainer)

__all__ = ["batch_shard_count", "init_distributed", "make_mesh",
           "make_multislice_mesh", "param_sharding", "rank_device",
           "shard_rows", "spatial_constrainer"]
