"""rabit_tpu_torch — the PyTorch/CUDA port of rabit_tpu.

A second package beside :mod:`rabit_tpu`, mirroring its module names.
It imports ``torch`` and ``numpy`` and nothing of the JAX package; the
hot k-means statistics pass runs as hand-written CUDA kernels for the
H100 (``ops/csrc``).  Entry points run on the card unless the caller
asks for the CPU.  Ported so far: the world-of-one ``empty`` engine, the
API, and k-means (:mod:`rabit_tpu_torch.learn.kmeans`).
"""
from rabit_tpu_torch.api import (
    allgather,
    allreduce,
    broadcast,
    checkpoint,
    device_epoch,
    finalize,
    get_processor_name,
    get_rank,
    get_world_size,
    init,
    initialized,
    is_distributed,
    load_checkpoint,
    tracker_print,
    version_number,
)
from rabit_tpu_torch.ops import (BITAND, BITOR, BITXOR, MAX, MIN, PROD, SUM,
                                 ReduceOp)
from rabit_tpu_torch.utils import RabitError, Serializable

__version__ = "0.1.0"

__all__ = [
    "init", "finalize", "initialized", "get_rank", "get_world_size",
    "get_processor_name", "is_distributed", "tracker_print", "allreduce",
    "allgather", "broadcast", "load_checkpoint", "checkpoint",
    "version_number", "device_epoch",
    "MAX", "MIN", "SUM", "PROD", "BITOR", "BITAND", "BITXOR", "ReduceOp",
    "Serializable", "RabitError", "__version__",
]
