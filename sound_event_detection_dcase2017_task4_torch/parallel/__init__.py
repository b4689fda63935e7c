"""Data parallel over processes: the port of the JAX package's ``parallel/``.

The JAX package shards the batch over a ``jax.sharding.Mesh`` and lets XLA
insert the collectives; the port runs one process per card under
``torchrun`` and issues them itself (``mesh.py``): global-batch BatchNorm
statistics, the gradient average, the mixup partner's rows and the eval
outputs.
"""

from .mesh import (Mesh, all_reduce_sum, average_, barrier, gather_rows,
                   is_initialized, join, make_mesh, make_mesh_for_batch,
                   mesh_size, mirror, pad_rows, replicate, shard_batch,
                   world_size)

__all__ = ["Mesh", "is_initialized", "world_size", "join", "make_mesh",
           "make_mesh_for_batch", "mesh_size", "shard_batch",
           "all_reduce_sum", "average_", "mirror", "gather_rows",
           "replicate", "barrier", "pad_rows"]
