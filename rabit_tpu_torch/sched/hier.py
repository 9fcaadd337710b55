"""Hierarchical two-level allreduce for multi-host shapes.

PyTorch-port counterpart of :mod:`rabit_tpu.sched.hier`.  Keyed off the
tracker's topology handout (the ``groups`` field — one host-group id
per rank, derived from registrant hosts or the ``RABIT_TRACKER_GROUPS``
override, e.g. ``RABIT_TRACKER_GROUPS=0,0,1`` for ranks 0 and 1 on one
host and rank 2 on another): each group's members reduce into their
leader (minimum rank — the chunked concurrent drain the tree pump
uses), the leaders run a bandwidth-optimal ring among themselves over
the cross-host leader links, and each leader broadcasts the finished
vector back to its members.  Cross-host traffic thus shrinks from
every-rank-crosses to one-rank-per-host-crosses.

Merge order is deterministic (member-rank order inside the group,
leader-ring block order across).  The cross-host leader ring is the
shared :func:`ring_allreduce` walk, so its hop loops ride the engine's
pipelined exchange+merge window like the whole-world ring.  The
straggler-demotion set of the reference's adaptive controller is
always empty in the port (ROADMAP A8), so the leader is the group's
minimum rank.
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.sched import topo
from rabit_tpu_torch.sched.base import Schedule
from rabit_tpu_torch.sched.ring import ring_allreduce


class HierarchicalSchedule(Schedule):
    name = "hier"

    def applies(self, eng, nbytes: int) -> bool:
        n = eng._world
        groups = getattr(eng, "_groups", None) or []
        if n < 2 or len(groups) != n or len(set(groups)) < 2:
            return False
        demoted = getattr(eng, "_demoted", ()) or ()
        return self._links_ok(
            eng, topo.hier_peers(eng._rank, n, groups, demoted))

    def run(self, eng, buf: np.ndarray, op: ReduceOp) -> None:
        r = eng._rank
        groups = eng._groups
        demoted = getattr(eng, "_demoted", ()) or ()
        flat = buf.reshape(-1)
        if flat.nbytes == 0:
            return
        view = memoryview(flat).cast("B")
        members = topo.group_members(groups, r)
        leader = topo.group_leader(groups, groups[r], demoted)
        if r != leader:
            # Contribute, then park for the finished vector — the
            # intra-host legs ride the (fast, usually loopback) local
            # links only.
            eng._send(leader, view)
            eng._recv(leader, len(view), view)
            return
        # Drain order stays ascending member rank (minus the leader), so
        # the reduction order is deterministic.
        others = [m for m in members if m != leader]
        if others:
            # The engine's shared chunked concurrent drain: every member
            # streams at once, merges stay in member-rank order.
            def merge(off: int, ne: int, src) -> None:
                eng._wire_merge(op, flat, off, ne,
                                np.frombuffer(src, dtype=flat.dtype,
                                              count=ne))

            eng._drain_merge(others, len(flat), flat.itemsize, merge)
        leaders = topo.group_leaders(groups, demoted)
        if len(leaders) > 1:
            li = leaders.index(r)
            nl = len(leaders)
            ring_allreduce(eng, buf, op, ring_rank=li, ring_world=nl,
                           prev=leaders[(li - 1) % nl],
                           nxt=leaders[(li + 1) % nl])
        for mr in others:
            eng._send(mr, view)
