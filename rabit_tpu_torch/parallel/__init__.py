"""Parallelism layer: meshes of logical ranks and in-program collectives
over per-rank tensors (counterpart of :mod:`rabit_tpu.parallel`).

``replicated``, ``sharded_batch`` and ``shard_collective`` have no
counterpart: a list of per-rank tensors is the sharding, and each
collective is called on that list directly.
"""
from rabit_tpu_torch.ops.reduce_ops import apply_op_pairwise
from rabit_tpu_torch.parallel.collectives import (
    allgather,
    allreduce,
    broadcast,
    reduce_scatter,
    ring_allreduce,
)
from rabit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    local_data_slice,
    make_mesh,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "local_data_slice",
    "allreduce",
    "allgather",
    "broadcast",
    "reduce_scatter",
    "ring_allreduce",
    "apply_op_pairwise",
]
