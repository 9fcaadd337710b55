"""The Schedule interface — collective algorithms as pluggable data.

PyTorch-port counterpart of :mod:`rabit_tpu.sched.base` (its own copy).
A :class:`Schedule` is a stateless singleton describing ONE allreduce
algorithm over the engine's wired links.  The engine's dispatch
(``PySocketEngine._allreduce_dispatch``) selects a schedule per
``(op, dtype, payload_bytes, world, topology)`` point — statically via
the tree/ring crossover, or by force (``rabit_sched=<name>``) — and a
schedule is deterministic given the topology: the same op stream on the
same world produces the same wire traffic.

Schedules run INSIDE the engine's op body with the engine's own IO
helpers (``_exchange``/``_send``/``_recv``/``_recv_all``), scratch
arena and reduce-buffer chunk budget; they own only the peer pattern
and block math.  Reductions go through the engine's ``_wire_merge``
seam (absolute element offset + count).  ``applies()`` must be cheap,
deterministic across ranks (it sees only replicated state: world,
topology handout, payload size) and honest about link availability — a
schedule whose links the tracker did not wire reports False and the
dispatch falls back to the static crossover instead of dying on a
KeyError mid-collective.
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.ops import ReduceOp


class Schedule:
    """One allreduce algorithm; subclasses override ``name``/``run``."""

    #: registry key and the ``rabit_sched`` value that forces this
    #: schedule
    name = "?"

    def applies(self, eng, nbytes: int) -> bool:
        """Can this schedule run the given payload on ``eng``'s current
        topology?  Checked on EVERY rank with replicated inputs, so all
        ranks agree; False sends the op to the static fallback."""
        return eng._world >= 2

    def run(self, eng, buf: np.ndarray, op: ReduceOp) -> None:
        """Reduce ``buf`` in place across the world.  (The reference's
        ``red_dtype`` argument, the merge type of its bf16 wire, comes
        with the codecs, ROADMAP A8.)"""
        raise NotImplementedError

    def _links_ok(self, eng, peers) -> bool:
        links = eng._links
        return all(p in links for p in peers)
