"""Transport-generic multi-link progress pumps.

PyTorch-port counterpart of :mod:`rabit_tpu.transport.pump` (its own
copy: the port imports nothing of the JAX package).  The engine's
deadlock-sensitive concurrent IO patterns — full-duplex ring exchange,
the tree's multi-child drain and the hop pipeline — are written against
the :class:`~rabit_tpu_torch.transport.base.Link` pump interface, so a
ring step between two shm peers, two TCP peers, or one of each runs the
same loop: poll every involved link, and only when NOTHING progressed
wait on the links' fds.  Shm links bound the wait to a short slice
(``needs_poll``): their ring state is not fully visible to ``poll``, so
the pump re-polls at millisecond granularity as the lost-wakeup safety
net while the doorbell fd provides the common-case wakeup.

Byte streams are unchanged from the reference's loops: payload is
consumed in arrival order per link, send windows are whatever the
kernel (or ring) accepts, and the timeout is an IDLE bound — it re-arms
on every byte of progress.
"""
from __future__ import annotations

import time
from typing import Optional

from rabit_tpu_torch.transport.base import (Link, LinkError, flatten_parts,
                                            wait_readable_writable)
from rabit_tpu_torch.transport.shm import WAIT_SLICE_SEC


def _timeout_error(links: list[Link], msg: str) -> LinkError:
    """Build the idle-timeout error, health-probing the stalled links
    first: a link that is structurally dead (ctrl EOF, lost ring
    magic) gets the blame — with ``err.link`` attribution, so the
    engine's failover hook fires — instead of an anonymous timeout."""
    for link in links:
        try:
            ok = link.healthy()
        except (OSError, ValueError):
            ok = False
        if not ok:
            err = LinkError(f"{msg} (link to rank {link.peer} failed "
                            f"its health probe)")
            err.link = link
            return err
    return LinkError(msg)


def _wait(rlinks: list[Link], wlinks: list[Link],
          deadline: Optional[float], timeout_msg: str) -> None:
    """Block until some link is plausibly ready (or a slice passes).
    Raises LinkError once the idle deadline expires."""
    now = time.monotonic()
    if deadline is not None and now >= deadline:
        raise _timeout_error(rlinks + wlinks, timeout_msg)
    bounded = any(link.needs_poll() for link in rlinks) \
        or any(link.needs_poll() for link in wlinks)
    # Shm write-waits watch the doorbell fd for READABLE wakeup bytes
    # (the reader signals freed space on the same channel).
    rlist = list(rlinks) + [lk for lk in wlinks
                            if lk.needs_poll() and lk not in rlinks]
    wlist = [lk for lk in wlinks if not lk.needs_poll()]
    wait_sec = None if deadline is None else max(deadline - now, 0.0)
    if bounded:
        wait_sec = WAIT_SLICE_SEC if wait_sec is None \
            else min(wait_sec, WAIT_SLICE_SEC)
    if not rlist and not wlist:
        return
    # Waiter flags first, readiness re-check second (the shm sleep
    # protocol: the peer rings only for an advertised sleeper, and it
    # may have acted between our poll and the arm).
    for link in rlinks:
        link.arm_wait(rx=True)
    for link in wlinks:
        link.arm_wait(rx=False)
    try:
        for link in rlinks:
            if link.rx_pending():
                return
        try:
            readable, writable = wait_readable_writable(rlist, wlist,
                                                        wait_sec)
        except (OSError, ValueError) as e:
            raise LinkError(f"{timeout_msg.split(':')[0]}: wait "
                            f"failed: {e}") from e
        if deadline is not None and not bounded \
                and not readable and not writable:
            # poll blocked the full remaining idle budget, no event
            raise _timeout_error(rlinks + wlinks, timeout_msg)
        for link in rlist:
            link.drain_wakeups()
    finally:
        for link in rlinks:
            link.disarm_wait(rx=True)
        for link in wlinks:
            link.disarm_wait(rx=False)


def _end_all(begun: list[Link], suppress: bool) -> None:
    """Restore EVERY entered link's blocking state.  ``suppress`` means
    a real error already aborted the pump: the links ABORT — framed tx
    backlog dropped, never flushed — because a blocking flush to a peer
    that is itself stuck in the failed collective would delay the
    in-flight LinkError by up to the full link timeout.  On the success
    path pump_end flushes, and the first flush failure propagates (after
    every link was still restored)."""
    if suppress:
        for link in begun:
            link.pump_abort()
        return
    flush_err: Optional[LinkError] = None
    for link in begun:
        try:
            link.pump_end()
        except LinkError as e:
            flush_err = flush_err if flush_err is not None else e
    if flush_err is not None:
        raise flush_err


class HopPipeline:
    """Depth-N window of in-flight chunk exchanges over one (send, recv)
    link pair — the transport half of the engine's hop pipeline.

    Where :func:`exchange` runs ONE full-duplex transfer to completion,
    a HopPipeline keeps several consecutive chunk exchanges of the same
    hop in flight at once: ``push()`` enqueues a chunk's send/recv
    buffers (starting its IO opportunistically), ``pop()`` blocks until
    the OLDEST pushed chunk has fully completed and returns its ``meta``
    — so the caller can fold chunk k's bytes while chunk k+1's wire IO
    progresses underneath.  The per-link byte stream is IDENTICAL to the
    serial loop (same bytes, same order; only the compute/IO
    interleaving changes), so peers running different depths —
    including depth-1 serial peers — interoperate on the same
    collective.

    Completion of a chunk means: all its recv bytes arrived AND all its
    send bytes are actually on the wire — for framed links that claim
    payload by reference (``encode_frames`` never copies), the claimed
    backlog must also have drained (``tx_pending``), or a caller
    mutating the just-"sent" region could corrupt frames still pointing
    at it.

    Pump mode is held for the pipeline's lifetime; ``close()`` flushes
    and restores blocking state (success path), ``abort()`` drops any
    framed backlog and restores state (exception path, never raises).
    The idle timeout re-arms on every byte of progress, exactly like
    the one-shot pumps.
    """

    def __init__(self, slink: Link, rlink: Link,
                 timeout: Optional[float], what: str) -> None:
        self._slink = slink
        self._rlink = rlink
        self._timeout = timeout
        self._what = what
        self._sq: list = []      # flattened pending send views (in order)
        self._rq: list = []      # flattened pending recv views (in order)
        self._bounds: list = []  # (send_end, recv_end, meta) per chunk
        self._senq = 0           # send bytes enqueued so far
        self._renq = 0           # recv bytes enqueued so far
        self._sent = 0           # send bytes claimed by the link
        self._recvd = 0          # recv bytes landed in caller buffers
        self._deadline = (None if timeout is None
                          else time.monotonic() + timeout)
        self._begun: list[Link] = []
        links = [slink] if slink is rlink else [slink, rlink]
        try:
            for link in links:
                link.pump_begin()  # raises LinkError on a dead fd
                self._begun.append(link)
        except BaseException:
            self.abort()
            raise

    @property
    def inflight(self) -> int:
        """Chunks pushed but not yet popped."""
        return len(self._bounds)

    def push(self, send_parts: list, recv_parts: list, meta=None) -> None:
        """Enqueue one chunk exchange (either side may be empty) and
        make opportunistic non-blocking progress."""
        sb = flatten_parts(send_parts)
        rb = flatten_parts(recv_parts)
        self._senq += sum(len(m) for m in sb)
        self._renq += sum(len(m) for m in rb)
        self._sq.extend(sb)
        self._rq.extend(rb)
        self._bounds.append((self._senq, self._renq, meta))
        self._advance(block=False)

    def pop(self):
        """Block until the OLDEST chunk completes; return its meta."""
        send_end, recv_end, meta = self._bounds[0]
        while not self._done(send_end, recv_end):
            self._advance(block=True)
        self._bounds.pop(0)
        return meta

    def _done(self, send_end: int, recv_end: int) -> bool:
        if self._recvd < recv_end or self._sent < send_end:
            return False
        return send_end == 0 or not self._slink.tx_pending()

    def _advance(self, block: bool) -> None:
        progress = False
        if self._rq:
            n = self._rlink.poll_recv(self._rq[0])
            if n:
                progress = True
                self._recvd += n
                self._rq[0] = self._rq[0][n:]
                if not len(self._rq[0]):
                    self._rq.pop(0)
            elif self._rlink.wire_progress:
                # Raw bytes of an incomplete integrity frame moved: the
                # link is delivering — re-arm the idle timeout.
                progress = True
        if self._sq or self._slink.tx_pending():
            left = sum(len(m) for m in self._sq)
            if self._slink.poll_sendv(self._sq):
                progress = True
            self._sent += left - sum(len(m) for m in self._sq)
        if progress:
            if self._timeout is not None:
                self._deadline = time.monotonic() + self._timeout
        elif block:
            _wait([self._rlink] if self._rq else [],
                  [self._slink]
                  if self._sq or self._slink.tx_pending() else [],
                  self._deadline, f"{self._what}: timed out")

    def close(self) -> None:
        """Success-path exit: flush framed backlog, restore blocking
        state on every entered link (first flush error propagates)."""
        begun, self._begun = self._begun, []
        _end_all(begun, suppress=False)

    def abort(self) -> None:
        """Exception-path exit: drop framed tx backlog, restore state.
        Never raises."""
        begun, self._begun = self._begun, []
        _end_all(begun, suppress=True)


def exchange(slink: Link, send_parts: list, rlink: Link,
             recv_parts: list, timeout: Optional[float]) -> None:
    """Full-duplex: stream ``send_parts`` to one link while filling
    ``recv_parts`` from another (possibly the same link — the halving
    schedule pairs both directions on one peer).  Vectored on the send
    side; receive buffers fill strictly in order."""
    sbufs = flatten_parts(send_parts)
    rbufs = flatten_parts(recv_parts)
    links = [slink] if slink is rlink else [slink, rlink]
    deadline = None if timeout is None else time.monotonic() + timeout
    begun: list[Link] = []
    try:
        for link in links:
            link.pump_begin()  # raises LinkError on a dead fd
            begun.append(link)
        while sbufs or rbufs or slink.tx_pending():
            progress = False
            if rbufs:
                n = rlink.poll_recv(rbufs[0])
                if n:
                    progress = True
                    rbufs[0] = rbufs[0][n:]
                    if not len(rbufs[0]):
                        rbufs.pop(0)
                elif rlink.wire_progress:
                    # Raw bytes of an incomplete integrity frame moved:
                    # the link is alive and delivering — re-arm the
                    # idle timeout even though no plaintext surfaced.
                    progress = True
            if sbufs or slink.tx_pending():
                progress |= slink.poll_sendv(sbufs)
            if progress:
                if timeout is not None:
                    deadline = time.monotonic() + timeout  # idle re-arm
            else:
                _wait([rlink] if rbufs else [],
                      [slink] if sbufs or slink.tx_pending() else [],
                      deadline, "exchange: timed out")
    except BaseException:
        _end_all(begun, suppress=True)
        raise
    _end_all(begun, suppress=False)


def recv_all(links: list[Link], nbytes: int, bufs: list,
             timeout: Optional[float]) -> None:
    """Fill ``bufs[i][:nbytes]`` from ``links[i]``, draining every link
    concurrently (bytes are consumed in arrival order across links, so
    one slow peer no longer serializes its siblings).  Callers merge in
    deterministic rank order afterwards — reduction order unchanged."""
    got = [0] * len(links)
    pending = set(range(len(links)))
    deadline = None if timeout is None else time.monotonic() + timeout
    begun: list[Link] = []
    try:
        for link in links:
            link.pump_begin()  # raises LinkError on a dead fd
            begun.append(link)
        while pending:
            progress = False
            for i in list(pending):
                n = links[i].poll_recv(bufs[i][got[i]:nbytes])
                if n:
                    got[i] += n
                    progress = True
                    if got[i] == nbytes:
                        pending.discard(i)
                elif links[i].wire_progress:
                    progress = True  # mid-frame raw bytes: link alive
            if pending and not progress:
                _wait([links[i] for i in pending], [], deadline,
                      "tree recv: timed out on children")
            elif progress and timeout is not None:
                deadline = time.monotonic() + timeout  # idle re-arm
    except BaseException:
        _end_all(begun, suppress=True)
        raise
    _end_all(begun, suppress=False)
