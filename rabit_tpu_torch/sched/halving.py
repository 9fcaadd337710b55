"""Recursive halving/doubling allreduce (Rabenseifner-style).

PyTorch-port counterpart of :mod:`rabit_tpu.sched.halving` (its own
copy, without the reference's ``red_dtype``, the merge type of its bf16
wire: that comes with the codecs, ROADMAP A8).

Reduce-scatter by recursive vector halving (log2(m) exchange steps,
each moving half the remaining region to the XOR partner), then
all-gather by recursive doubling — 2*log2(m) total rounds moving
2*(1-1/m)*N bytes per rank, the same volume as the ring in log(n)
rather than 2(n-1) rounds.  That makes it the mid-size sweet spot:
latency-bound enough that the ring's 2(n-1) serial hops hurt, large
enough that the tree's full-payload store-and-forward per level hurts.

Non-power-of-two worlds fold the ``world - m`` extra ranks in a
pre/post step: extra rank ``r >= m`` ships its vector to fold partner
``r - m`` (merged before the power-of-two phase) and receives the
finished result after it — the classic 3-phase fallback.

Block bounds are the same global, itemsize-aligned partition the ring
uses, so ragged payloads (``len % m != 0``, including ``len < m`` with
zero-length edge blocks) take zero-byte exchanges symmetrically on
both sides of every link.
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.sched import topo
from rabit_tpu_torch.sched.base import Schedule


class HalvingDoublingSchedule(Schedule):
    name = "halving"

    def applies(self, eng, nbytes: int) -> bool:
        if eng._world < 2:
            return False
        return self._links_ok(
            eng, topo.halving_peers(eng._rank, eng._world))

    def run(self, eng, buf: np.ndarray, op: ReduceOp) -> None:
        n, r = eng._world, eng._rank
        flat = buf.reshape(-1)
        if flat.nbytes == 0:
            return
        view = memoryview(flat).cast("B")
        item = flat.itemsize
        nelems = len(flat)
        m = topo.pow2_floor(n)
        chunk_elems = min(max(eng._reduce_buffer // item, 1), nelems)
        cbytes = chunk_elems * item

        # Fold pre-step: extra ranks ship their whole vector to the
        # partner (chunk-drained there) and park until the post-step.
        if r >= m:
            p = r - m
            eng._send(p, view)
            eng._recv(p, len(view), view)
            return

        def merge_at(e_base: int):
            def merge(coff: int, rl: int, src) -> None:
                ne = rl // item
                eng._wire_merge(op, flat, e_base + coff // item, ne,
                                np.frombuffer(src, dtype=flat.dtype,
                                              count=ne))
            return merge

        if r + m < n:
            # Recv-only pipelined drain of the extra rank's vector:
            # chunk k merges while chunk k+1 is in flight.
            eng._hop_exchange_merge(r + m, view[:0], r + m, len(view),
                                    cbytes, item, merge_at(0),
                                    what="halving fold")

        per = -(-nelems // m)
        bounds = [min(i * per, nelems) for i in range(m + 1)]
        # Phase 1: reduce-scatter by halving.  At distance d my live
        # region [nb, nb+d) blocks halves; I ship the partner's half
        # and fold its contribution for mine.  After the walk, block r
        # is fully reduced here.  Each halving exchange is one
        # pipelined hop: sub-chunks stream through the engine's depth
        # window so the fold compute hides behind the wire.
        d = m >> 1
        while d:
            p = r ^ d
            nb = r & ~(d - 1)
            pnb = p & ~(d - 1)
            sblk = view[bounds[pnb] * item: bounds[pnb + d] * item]
            r_lo = bounds[nb]
            rbytes = (bounds[nb + d] - r_lo) * item
            eng._hop_exchange_merge(p, sblk, p, rbytes, cbytes, item,
                                    merge_at(r_lo), what="halving hop")
            d >>= 1
        # Phase 2: all-gather by doubling — the reverse walk, receives
        # landing straight in the payload (no scratch, like the ring's
        # gather phase).
        d = 1
        while d < m:
            p = r ^ d
            base = r & ~(d - 1)
            pbase = base ^ d
            eng._exchange(
                p, view[bounds[base] * item: bounds[base + d] * item],
                p, view[bounds[pbase] * item: bounds[pbase + d] * item])
            d <<= 1
        # Fold post-step: hand the finished vector back to the extra.
        if r + m < n:
            eng._send(r + m, view)
