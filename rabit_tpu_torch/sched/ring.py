"""Ring schedules: bandwidth-optimal reduce-scatter + all-gather.

PyTorch-port counterpart of :mod:`rabit_tpu.sched.ring`.  The ring walk
runs over ANY ordered member list — the global world by default, or a
sub-ring such as the hierarchical schedule's cross-host leader ring.
The fused segmented variant (one vectored exchange moves every bucket
member's block per step) lives here too.  The reference's ``red_dtype``
(the merge type of its bf16 wire) comes with the codecs (ROADMAP A8).
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.ops.reduce_ops import apply_op_numpy
from rabit_tpu_torch.sched.base import Schedule


def ring_allreduce(eng, buf: np.ndarray, op: ReduceOp, *,
                   ring_rank: int | None = None,
                   ring_world: int | None = None,
                   prev: int | None = None, nxt: int | None = None) -> None:
    """Bandwidth-optimal ring: reduce-scatter then all-gather.

    With the keyword arguments the walk runs over a sub-ring:
    ``ring_rank``/``ring_world`` index this member within it and
    ``prev``/``nxt`` are the GLOBAL ranks of its ring neighbors.
    Defaults reproduce the classic whole-world ring.
    """
    n = eng._world if ring_world is None else ring_world
    me = eng._rank if ring_rank is None else ring_rank
    nxt = eng._ring_next if nxt is None else nxt
    prev = eng._ring_prev if prev is None else prev
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


def ring_segmented(eng, tflats: list[np.ndarray], op: ReduceOp) -> None:
    """Fused multi-member ring: every exchange step moves the
    corresponding block of EVERY member in one vectored write/read
    (scatter-gather send, receives landing straight in the member
    arrays on the all-gather phase — no staging copies), so a bucket of
    K ring-sized ops costs one ring walk instead of K.  Each member
    keeps its OWN block partition, hence its solo reduction order, bit
    for bit."""
    n = eng._world
    item = tflats[0].itemsize
    views = [memoryview(f).cast("B") for f in tflats]
    bounds = []
    for f in tflats:
        per = (len(f) + n - 1) // n
        bounds.append([min(i * per, len(f)) for i in range(n + 1)])
    nmem = len(tflats)

    def blk(i: int, b: int) -> memoryview:
        b %= n
        return views[i][bounds[i][b] * item: bounds[i][b + 1] * item]

    max_recv = sum((bd[1] - bd[0]) * item for bd in bounds)
    scratch = eng._arena.take(max_recv)
    eng._note_scratch(max_recv)

    def _merge_member(i: int, recv_b: int, rpart, rl: int) -> None:
        nelem = rl // item
        e0 = bounds[i][recv_b % n]
        apply_op_numpy(op, tflats[i][e0:e0 + nelem],
                       np.frombuffer(rpart, dtype=tflats[i].dtype,
                                     count=nelem))

    try:
        # Phase 1: reduce-scatter, all members per step.
        for s in range(n - 1):
            send_b = eng._rank - s
            recv_b = eng._rank - s - 1
            sparts = [blk(i, send_b) for i in range(nmem)]
            rlens = [len(blk(i, recv_b)) for i in range(nmem)]
            rparts, off = [], 0
            for rl in rlens:
                rparts.append(scratch[off:off + rl])
                off += rl
            if eng._pipe_depth > 1 and nmem > 1:
                # Pipelined fused hop: member i's block merges while
                # member i+1's exchange is in flight — same bytes in
                # the same order as the vectored exchange below, so
                # mixed-depth peers interoperate.  Each member's recv
                # slice is distinct, so the window needs no slot
                # leases; the step boundary drains (a merged block is
                # the NEXT step's send).
                _seg_hop_pipelined(eng, sparts, rparts, rlens, recv_b,
                                   _merge_member)
            else:
                eng._exchange_v(eng._ring_next, sparts,
                                eng._ring_prev, rparts)
                for i, rl in enumerate(rlens):
                    if rl:
                        _merge_member(i, recv_b, rparts[i], rl)
        # Phase 2: all-gather the fully reduced blocks.
        for s in range(n - 1):
            send_b = eng._rank + 1 - s
            recv_b = eng._rank - s
            eng._exchange_v(
                eng._ring_next, [blk(i, send_b) for i in range(nmem)],
                eng._ring_prev, [blk(i, recv_b) for i in range(nmem)])
    finally:
        eng._arena.give(scratch)


def _seg_hop_pipelined(eng, sparts: list, rparts: list, rlens: list,
                       recv_b: int, merge_member) -> None:
    """One pipelined step of the fused segmented ring: per-member chunk
    pushes through a :class:`~rabit_tpu_torch.transport.pump.HopPipeline`,
    popped and merged in member order with at most
    ``rabit_pipeline_depth`` exchanges in flight.  The engine's
    ``_pipe_run`` owns the open/close/abort choreography."""
    def body(pipe) -> None:
        def pop_merge() -> None:
            i, rl = pipe.pop()
            if rl:
                merge_member(i, recv_b, rparts[i], rl)

        for i, sp in enumerate(sparts):
            if pipe.inflight >= eng._pipe_depth:
                pop_merge()
            rl = rlens[i]
            pipe.push([sp] if len(sp) else [],
                      [rparts[i]] if rl else [], (i, rl))
        while pipe.inflight:
            pop_merge()

    eng._pipe_run(eng._ring_next, eng._ring_prev, "fused ring hop", body)


class RingSchedule(Schedule):
    name = "ring"

    def applies(self, eng, nbytes: int) -> bool:
        return eng._world >= 2  # ring links are always wired

    def run(self, eng, buf: np.ndarray, op: ReduceOp) -> None:
        ring_allreduce(eng, buf, op)
