"""Tree schedule: reduce up the binary tree, broadcast down.

PyTorch-port counterpart of :mod:`rabit_tpu.sched.tree`.  The latency
king for small payloads (log2(n) hops) and the baseline every other
schedule is bit-compared against.  The two-phase chunked pump itself
lives on the engine (``_tree_chunked``); this schedule is the thin
allreduce face over it.
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.sched.base import Schedule


class TreeSchedule(Schedule):
    name = "tree"

    def applies(self, eng, nbytes: int) -> bool:
        return eng._world >= 2  # tree links are always wired

    def run(self, eng, buf: np.ndarray, op: ReduceOp) -> None:
        eng._tree_allreduce(buf, op)
