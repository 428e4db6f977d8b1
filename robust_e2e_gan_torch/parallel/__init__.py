from robust_e2e_gan_torch.parallel.launcher import launch
from robust_e2e_gan_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    local_batch_size,
    make_mesh,
    partition_rule,
    process_batch_slice,
    replicated,
    shard_batch,
    shard_params,
    shard_train_state,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "launch",
    "local_batch_size",
    "make_mesh",
    "partition_rule",
    "process_batch_slice",
    "replicated",
    "shard_batch",
    "shard_params",
    "shard_train_state",
]
