"""Data parallelism over torch.distributed (`parallel/mesh.py`)."""

from wetts_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    host_shard_info,
    init_distributed,
    replicate,
)

__all__ = ["all_reduce_grads", "host_shard_info", "init_distributed",
           "replicate"]
