"""rabit_tpu_torch.sched — the schedules' peer-pattern math.

PyTorch-port counterpart of :mod:`rabit_tpu.sched`, so far only what the
tracker's rendezvous needs: :mod:`~rabit_tpu_torch.sched.topo` (the
peers every schedule asks for, which the tracker wires at rendezvous)
and the schedule directive's wire encoding from
:mod:`~rabit_tpu_torch.sched.tuner`.  The schedule objects themselves
(tree, ring, halving, swing, hier, synth) and the tuning cache are
ported with the engine (ROADMAP A2, A3, A8).
"""
from __future__ import annotations

from rabit_tpu_torch.sched.tuner import decode_directive, encode_directive

__all__ = ["encode_directive", "decode_directive"]
