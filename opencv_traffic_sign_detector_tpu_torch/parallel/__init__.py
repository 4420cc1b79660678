from .mesh import data_mesh, shard_batch
from .multihost import (
    host_shard_files,
    initialize_distributed,
    multihost_batched_frames,
)
from .train import distributed_lda_fit, distributed_train_step

__all__ = [
    "data_mesh",
    "shard_batch",
    "distributed_lda_fit",
    "distributed_train_step",
    "host_shard_files",
    "initialize_distributed",
    "multihost_batched_frames",
]
