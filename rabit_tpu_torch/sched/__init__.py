"""rabit_tpu_torch.sched — collective schedules.

PyTorch-port counterpart of :mod:`rabit_tpu.sched`.  The collective hot
path runs behind a **schedule object** (:class:`Schedule`): each
allreduce algorithm is a pluggable singleton selected per
``(op, dtype, payload_bytes, world, topology)`` dispatch point.  Ported:
the tree and ring pumps and recursive halving/doubling, with the
peer-pattern math (:mod:`~rabit_tpu_torch.sched.topo`) the tracker
shares and the directive's wire encoding
(:mod:`~rabit_tpu_torch.sched.tuner`).  Swing, the hierarchical and
synthesized schedules and the tuning cache wait for ROADMAP A3/A8.

Selection modes (``rabit_sched``): ``static`` (default — the classic
tree/ring byte crossover, configurable via
``rabit_ring_threshold_bytes``) or a schedule name (force it wherever
it applies).  The reference's ``auto`` mode and the schedules not
ported here raise :class:`NotImplementedError` in the engine.
"""
from __future__ import annotations

from rabit_tpu_torch.sched.base import Schedule
from rabit_tpu_torch.sched.halving import HalvingDoublingSchedule
from rabit_tpu_torch.sched.ring import RingSchedule, ring_allreduce
from rabit_tpu_torch.sched.tree import TreeSchedule
from rabit_tpu_torch.sched.tuner import decode_directive, encode_directive

TREE = TreeSchedule()
RING = RingSchedule()
HALVING = HalvingDoublingSchedule()

#: every registered schedule, by name
SCHEDULES: dict[str, Schedule] = {s.name: s for s in (TREE, RING, HALVING)}

#: legal rabit_sched values
MODES = ("static",) + tuple(SCHEDULES)

__all__ = [
    "Schedule", "TreeSchedule", "RingSchedule", "HalvingDoublingSchedule",
    "ring_allreduce", "SCHEDULES", "MODES", "TREE", "RING", "HALVING",
    "encode_directive", "decode_directive",
]
