from detr_tpu_torch.parallel.distributed import (
    allgather_host,
    broadcast_from_primary,
    data_shard,
    initialize_distributed,
    is_primary,
    process_count,
    process_index,
)
from detr_tpu_torch.parallel.mesh import Grid, assert_divisible, make_mesh, shard_batch, shard_state
from detr_tpu_torch.parallel.tp import (
    TensorParallel,
    gather_state_tp,
    make_mesh_2d,
    param_specs,
    shard_state_tp,
    tensor_parallel,
    validate_tp,
)

__all__ = [
    "Grid",
    "TensorParallel",
    "make_mesh",
    "make_mesh_2d",
    "param_specs",
    "shard_state_tp",
    "gather_state_tp",
    "tensor_parallel",
    "validate_tp",
    "shard_batch",
    "shard_state",
    "assert_divisible",
    "initialize_distributed",
    "is_primary",
    "process_index",
    "process_count",
    "data_shard",
    "allgather_host",
    "broadcast_from_primary",
]
