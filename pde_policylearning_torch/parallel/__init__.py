"""The parallel layer of the port on torch.distributed: the ('data',
'model') mesh, multigrid patching with the patch batch over the model
group, the x-sharded and the data-parallel channel DNS, and the rank
launcher the dry run and the tests use.

Counterpart of `pde_policylearning_tpu/parallel/`.  NCCL on the card (one
rank per card), gloo on the CPU."""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_gradients,
                   gather, get_data_parallel_size, get_model_parallel_size,
                   init_distributed, make_mesh, replicate, shard_batch,
                   split_batch_size)
from .patching import (MultigridPatching2D, make_mg_patches, make_patches,
                       stitch_patches)
from .sharded_env import (data_parallel_rollout, gather_x, shard_env_batch,
                          shard_env_state, sharded_rollout, sharded_step)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "get_data_parallel_size",
    "get_model_parallel_size", "init_distributed", "make_mesh", "replicate",
    "shard_batch", "split_batch_size",
    "MultigridPatching2D", "make_mg_patches", "make_patches",
    "stitch_patches",
    "shard_env_state", "sharded_rollout", "sharded_step",
    "data_parallel_rollout", "shard_env_batch",
    "Mesh", "all_reduce_gradients", "gather", "gather_x",
]
