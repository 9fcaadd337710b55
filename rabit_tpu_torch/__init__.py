"""rabit_tpu_torch — the PyTorch/CUDA port of rabit_tpu.

A second package beside :mod:`rabit_tpu`, mirroring its module names.
It imports ``torch`` and ``numpy`` and nothing of the JAX package; the
hot k-means statistics pass and the GBDT gradient histograms run as
hand-written CUDA kernels for the H100 (``ops/csrc``).  Entry points run
on the card unless the caller asks for the CPU.  Ported so far: the
world-of-one ``empty`` engine, the ``pysocket`` engine
(:mod:`rabit_tpu_torch.engine.pysocket`: the collectives, the async
pump with bucket fusion, custom reductions) and the fault-tolerant
``pyrobust`` engine over it (:mod:`rabit_tpu_torch.engine.robust`,
with the keepalive launcher :mod:`rabit_tpu_torch.tracker.launch_local`,
the durable checkpoint tier :mod:`rabit_tpu_torch.ckpt` and elastic
membership: a world that grows or shrinks at a commit boundary raises
:class:`WorldChangedError`, and :mod:`rabit_tpu_torch.learn.splitrows`
re-shards the rows),
the API, k-means
(:mod:`rabit_tpu_torch.learn.kmeans`), gradient-boosted trees
(:mod:`rabit_tpu_torch.learn.boosting`), and the wire the engine rides:
the tracker protocol and rendezvous (:mod:`rabit_tpu_torch.tracker`),
the TCP links and their pumps (:mod:`rabit_tpu_torch.transport`) and
the tree, ring, halving and hierarchical schedules
(:mod:`rabit_tpu_torch.sched`),
byte for byte the JAX package's.
"""
from rabit_tpu_torch.api import (
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    allreduce_custom,
    allreduce_many,
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
    lazy_checkpoint,
    load_checkpoint,
    tracker_print,
    version_number,
)
from rabit_tpu_torch.ckpt import CheckpointSkewError
from rabit_tpu_torch.engine.interface import AsyncOrderError, CollectiveHandle
from rabit_tpu_torch.engine.pysocket import (AsyncPumpError,
                                             TrackerLostError,
                                             WorldChangedError)
from rabit_tpu_torch.engine.robust import RecoveryError
from rabit_tpu_torch.ops import (BITAND, BITOR, BITXOR, MAX, MIN, PROD, SUM,
                                 ReduceOp)
from rabit_tpu_torch.utils import RabitError, Serializable

__version__ = "0.1.0"

__all__ = [
    "init", "finalize", "initialized", "get_rank", "get_world_size",
    "get_processor_name", "is_distributed", "tracker_print", "allreduce",
    "allreduce_async", "allreduce_custom", "allreduce_many", "allgather",
    "allgather_async", "broadcast", "load_checkpoint", "checkpoint",
    "lazy_checkpoint", "version_number", "device_epoch",
    "AsyncOrderError", "AsyncPumpError", "RecoveryError", "CollectiveHandle",
    "CheckpointSkewError", "TrackerLostError", "WorldChangedError",
    "MAX", "MIN", "SUM", "PROD", "BITOR", "BITAND", "BITXOR", "ReduceOp",
    "Serializable", "RabitError", "__version__",
]
