from robust_e2e_gan_torch.parallel.launcher import launch
from robust_e2e_gan_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    full_state_dict,
    gathered,
    local_batch_size,
    local_shard,
    make_mesh,
    partition_rule,
    process_batch_slice,
    shard_batch,
    shard_params,
    shard_train_state,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "full_state_dict",
    "gathered",
    "launch",
    "local_batch_size",
    "local_shard",
    "make_mesh",
    "partition_rule",
    "process_batch_slice",
    "shard_batch",
    "shard_params",
    "shard_train_state",
]
