"""The (data, model) mesh: process groups and sharding rules
(``sharding.py``), Megatron tensor parallelism (``tensor_parallel.py``) and
the launcher of one process per rank (``launch.py``). Counterpart of the
JAX package's ``parallel/``."""

from .sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_state_dict,
    make_mesh,
    param_partition_spec,
    shard_state_dict,
)
from .tensor_parallel import TensorParallel, shard_model_

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "TensorParallel", "gather_state_dict",
    "make_mesh", "param_partition_spec", "shard_model_", "shard_state_dict",
]
