"""Data parallelism over ``torch.distributed`` (``mesh.py``)."""

from .mesh import (
    allreduce_grads,
    convert_global_batchnorm,
    data_parallel,
    get_dist_info,
    get_world_size,
    init_dist_slurm,
    init_distributed,
    replicate,
    shard_batch,
)
