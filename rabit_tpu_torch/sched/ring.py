"""Ring schedule: bandwidth-optimal reduce-scatter + all-gather.

PyTorch-port counterpart of :mod:`rabit_tpu.sched.ring`, the solo ring
over the whole world.  The reference's sub-ring keywords serve its
hierarchical schedule, and its fused segmented ring the async bucket
path; both come with those (ROADMAP A3), and its ``red_dtype`` (the
merge type of the bf16 wire) with the codecs (A8).
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.sched.base import Schedule


def ring_allreduce(eng, buf: np.ndarray, op: ReduceOp) -> None:
    """Bandwidth-optimal ring: reduce-scatter then all-gather."""
    n, me = eng._world, eng._rank
    nxt, prev = eng._ring_next, eng._ring_prev
    flat = buf.reshape(-1)
    view = memoryview(flat).cast("B")
    # Block b covers bytes [off[b], off[b+1]); blocks itemsize-aligned.
    item = flat.itemsize
    per = (len(flat) + n - 1) // n
    bounds = [min(i * per, len(flat)) for i in range(n + 1)]

    def block(i: int) -> memoryview:
        b = i % n
        return view[bounds[b] * item: bounds[b + 1] * item]

    # Reduce-scatter scratch is one ring block, capped at the
    # rabit_reduce_buffer budget: oversized blocks stream through the
    # exchange in budget-sized sub-chunks (TCP framing is
    # size-agnostic, so peers with different budgets interoperate).
    # The chunked exchange+merge itself is the engine's pipelined hop
    # primitive: with rabit_pipeline_depth > 1 the next sub-chunk's
    # exchange is in flight while this one merges.  Ragged worlds
    # (len % world != 0) produce zero-length edge blocks, which take
    # zero sub-steps by construction — symmetric on both sides of
    # every link, since block b has one global length.
    chunk_elems = min(max(eng._reduce_buffer // item, 1), max(per, 1))
    cbytes = chunk_elems * item
    # Phase 1: reduce-scatter.  After step s, block (me-s) has been
    # combined at this member with s+1 contributions.
    for s in range(n - 1):
        send_b = me - s
        recv_b = me - s - 1
        sblk, rblk = block(send_b), block(recv_b)
        relem0 = bounds[recv_b % n]

        def merge(coff: int, rl: int, src) -> None:
            nelem = rl // item
            eng._wire_merge(op, flat, relem0 + coff // item, nelem,
                            np.frombuffer(src, dtype=flat.dtype,
                                          count=nelem))

        eng._hop_exchange_merge(nxt, sblk, prev, len(rblk), cbytes,
                                item, merge, what="ring hop")
    # Phase 2: all-gather the fully reduced blocks around the ring.
    for s in range(n - 1):
        send_b = me + 1 - s
        recv_b = me - s
        eng._exchange(nxt, block(send_b), prev, block(recv_b))


class RingSchedule(Schedule):
    name = "ring"

    def applies(self, eng, nbytes: int) -> bool:
        return eng._world >= 2  # ring links are always wired

    def run(self, eng, buf: np.ndarray, op: ReduceOp) -> None:
        ring_allreduce(eng, buf, op)
