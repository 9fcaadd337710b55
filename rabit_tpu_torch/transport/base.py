"""The Transport/Link interface — how engine bytes reach a peer.

PyTorch-port counterpart of :mod:`rabit_tpu.transport.base` (its own
copy: the port imports nothing of the JAX package), with both of its
links: TCP and the same-host shared-memory rings.

Every worker-worker byte the pure-Python engines move flows through
a :class:`Link`: the engine wires one per peer at rendezvous (via
:class:`rabit_tpu_torch.transport.factory.LinkFactory`), the collective
schedules keep calling the engine's IO helpers (``_send``/``_recv``/
``_exchange``/``_recv_all``), and those helpers delegate here.  A link
owns exactly the byte-moving concerns — blocking and non-blocking
send/recv, vectored writes, timeouts, health — while the engine keeps
everything above the byte stream (op framing, reduction math, seqno/
replay, recovery).

Two implementations ship: :class:`rabit_tpu_torch.transport.tcp.TcpLink`
(the classic TCP path, byte-identical on the wire) and
:class:`rabit_tpu_torch.transport.shm.ShmLink` (same-host shared-memory
ring buffers, byte for byte the reference's layout, with the TCP
connection retained as doorbell + liveness channel).  A link optionally
speaks
**integrity framing** (``rabit_wire_integrity``): every write is wrapped
in a ``u32 length | payload | u32 crc`` frame so a flipped wire bit is
*detected* — surfacing as a typed :class:`IntegrityError` (a
:class:`LinkError`, so the pyrobust recovery path treats it like any
dead link) instead of silently corrupting the model.  Framing is
negotiated per link in the handshake (factory.py) and off by default,
which keeps the default-config wire byte-identical to older peers.

No engine imports here — engine → transport only, never back.
"""
from __future__ import annotations

import math
import select
import socket
import threading
from typing import Optional

from rabit_tpu_torch.utils.checks import check

#: integrity frame payload cap: bounds the deframer's staging memory and
#: the blast radius of one corrupted frame (matches the engines' stream
#: chunk so large payloads frame per chunk, not per byte).
FRAME_MAX = 256 << 10

#: scatter-gather segments per sendmsg (mirrors the engine's historical
#: cap; IOV_MAX is >= 1024 everywhere we run).
SENDMSG_MAX_PARTS = 64

#: accepted ``rabit_wire_integrity`` modes.  Both currently compute the
#: trailer with the C-accelerated stdlib CRC-32 (zlib); ``crc32c`` is
#: the negotiated NAME reserved for a Castagnoli implementation — the
#: frame layout and detection strength are identical, and peers agree on
#: the mode through the link handshake either way.
INTEGRITY_MODES = ("off", "crc32", "crc32c")
TRANSPORT_MODES = ("tcp", "shm", "auto")

#: smallest usable shm ring: enforced on the local config AND on the
#: NEGOTIATED size (a skewed or garbled peer offer below this takes the
#: clean tcp-fallback path — a degenerate ring whose every write
#: returns 0 would stall to the link timeout instead).
SHM_RING_MIN = 4096


class LinkError(ConnectionError):
    """A worker-worker or tracker link failed (peer death or reset).

    Raised by every transport on IO failure; the robust engine's
    recovery path catches exactly this.  Instances raised inside a
    :class:`Link` carry the link as ``err.link`` so the engine can
    attribute the failure (the shm→tcp failover bookkeeping)."""

    link: Optional["Link"] = None


class IntegrityError(LinkError):
    """Integrity framing detected wire corruption on a link.

    A frame's CRC trailer (or a structurally impossible frame length)
    did not match its payload after the transport's bounded re-read
    budget.  This IS a :class:`LinkError` on purpose: the pyrobust
    recovery path escalates it exactly like a peer death — the op
    retries from pristine buffers — and the engine's failover hook
    additionally tears a corrupted shm link down and re-dials it as
    TCP.  Without a robust layer it reaches the caller typed, never as
    silently wrong numbers."""


class Events:
    """Telemetry hooks the engine hands the transport layer (counters +
    trace events ride the engine's obs subsystem; the default sink
    drops everything, so transports never gate on obs config)."""

    def counter(self, name: str, n: int = 1) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass


NULL_EVENTS = Events()


class CountingEvents(Events):
    """An :class:`Events` sink that keeps the counters (name -> total)
    and drops the trace events: the engine's transport counters
    (``transport.links.*``, ``transport.shm.fallback``,
    ``transport.failover.*``, ``integrity.*``) while the obs plane is
    not ported (ROADMAP A8).  Link threads and the engine's async pump
    may count at once, hence the lock."""

    def __init__(self) -> None:
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counts)


class TransportConfig:
    """Resolved transport knobs (doc/parameters.md "Transports").

    ``transport``: ``tcp`` (default — byte-identical classic wire),
    ``shm``/``auto`` (offer shared-memory rings to same-host-group
    peers, TCP cross-host; ``shm`` logs when it has to fall back).
    ``integrity``: ``off`` | ``crc32`` | ``crc32c`` frame trailers.
    ``shm_ring_bytes``: per-direction ring capacity.  ``failover``:
    tear a failing shm link down and re-dial as TCP at the next
    rendezvous.  ``shm_retries``: bounded re-reads of a CRC-failed shm
    frame before escalating (catches a torn-but-completing write).
    ``shm_dir``: where the ring files are made (None: ``/dev/shm``, or
    the temp directory where that is not writable).  The reference's
    ``link_mbps`` pacing is refused by the engine (ROADMAP A8).
    """

    def __init__(self, transport: str = "tcp", integrity: str = "off",
                 shm_ring_bytes: int = 1 << 20, failover: bool = True,
                 shm_retries: int = 3,
                 shm_dir: Optional[str] = None) -> None:
        check(transport in TRANSPORT_MODES,
              "rabit_transport must be one of %s, got %r",
              "/".join(TRANSPORT_MODES), transport)
        check(integrity in INTEGRITY_MODES,
              "rabit_wire_integrity must be one of %s, got %r",
              "/".join(INTEGRITY_MODES), integrity)
        check(shm_ring_bytes >= SHM_RING_MIN,
              "rabit_shm_ring_bytes must be >= %d, got %r",
              SHM_RING_MIN, shm_ring_bytes)
        check(shm_retries >= 0, "rabit_shm_retries must be >= 0")
        self.transport = transport
        self.integrity = integrity
        self.shm_ring_bytes = int(shm_ring_bytes)
        self.failover = bool(failover)
        self.shm_retries = int(shm_retries)
        self.shm_dir = shm_dir

    @property
    def wants_integrity(self) -> bool:
        return self.integrity != "off"

    @property
    def wants_shm(self) -> bool:
        return self.transport in ("shm", "auto")

    def mode_label(self, groups: list[int]) -> str:
        """The transport label for tuning-cache keys: ``shm`` when shm
        is configured AND the topology has same-group peers to use it
        on, else ``tcp``.  Replicated inputs only (config + handout),
        so every rank computes the same label — schedule choice stays a
        collective decision."""
        if self.wants_shm and len(groups) != len(set(groups)):
            return "shm"
        return "tcp"


#: poll masks: errors/hangups surface as "readable" so the caller's
#: next read turns them into a typed LinkError (POLLNVAL covers a fd
#: closed out from under a racing pump).
_POLL_RD = select.POLLIN | select.POLLERR | select.POLLHUP | select.POLLNVAL


def wait_readable_writable(rlist, wlist, timeout: Optional[float]
                           ) -> tuple[list, list]:
    """One bounded readiness wait over objects with ``fileno()`` —
    ``select.poll``, NOT ``select.select``: link fds in an fd-heavy
    host process routinely exceed FD_SETSIZE, and the transport layer
    must degrade to a LinkError, never a ValueError crash.  Not an
    epoll selector either: shm waits call this once per 2 ms slice, and
    a poll object costs no kernel fd and no per-call register/close
    syscalls.  Returns (readable, writable)."""
    poller = select.poll()
    by_fd: dict = {}
    for obj in rlist:
        fd = obj.fileno()
        if fd < 0:
            raise ValueError(f"wait on closed fd ({fd})")
        by_fd[fd] = obj
        ev = _POLL_RD
        if obj in wlist:
            ev |= select.POLLOUT
        poller.register(fd, ev)
    for obj in wlist:
        fd = obj.fileno()
        if fd < 0:
            raise ValueError(f"wait on closed fd ({fd})")
        if fd not in by_fd:
            by_fd[fd] = obj
            poller.register(fd, select.POLLOUT | select.POLLERR
                            | select.POLLHUP | select.POLLNVAL)
    # Ceil to whole ms: a sub-ms slice must sleep, not busy-poll.
    ms = None if timeout is None else max(0, math.ceil(timeout * 1000))
    readable, writable = [], []
    for fd, ev in poller.poll(ms):
        obj = by_fd[fd]
        err = ev & (select.POLLERR | select.POLLHUP | select.POLLNVAL)
        if obj in rlist and (ev & select.POLLIN or err):
            readable.append(obj)
        if obj in wlist and (ev & select.POLLOUT or err):
            writable.append(obj)
    return readable, writable


def setup_stream_socket(sock: socket.socket, timeout: Optional[float],
                        sock_buf: int) -> socket.socket:
    """The ONE socket-setup helper every TCP link creation path runs,
    so ``rabit_sock_buf`` and the latency options can never silently
    miss a link: TCP_NODELAY (small consensus words must not wait on
    Nagle), the engine's link IO timeout, and SO_SNDBUF/SO_RCVBUF when
    ``rabit_sock_buf`` asks (both directions; the kernel doubles the
    value for bookkeeping).
    """
    sock.settimeout(timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if sock_buf > 0:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sock_buf)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, sock_buf)
    return sock


def advance_iov(bufs: list, n: int) -> None:
    """Consume ``n`` sent bytes from the head of a scatter-gather
    buffer list in place (the partial-write bookkeeping shared by every
    vectored send path)."""
    while bufs and n >= len(bufs[0]):
        n -= len(bufs[0])
        bufs.pop(0)
    if bufs and n:
        bufs[0] = bufs[0][n:]


def flatten_parts(parts) -> list:
    """Normalize a part list to non-empty byte memoryviews."""
    return [m for m in (memoryview(p).cast("B") for p in parts) if len(m)]


class Link:
    """One established engine↔peer byte channel.

    Byte-STREAM semantics on both sides (like a TCP socket): send
    boundaries are invisible to the receiver, so every engine pump and
    every schedule's chunking composes with any transport.  All methods
    raise :class:`LinkError` (with ``err.link = self``) on peer
    failure; blocking calls honor the engine's link IO timeout.

    Two operating modes:

    * **blocking** — ``sendall``/``sendv``/``recv_exact`` for the tree
      and sequential paths;
    * **pump** — bracketed by ``pump_begin``/``pump_end``, the
      non-blocking ``poll_sendv``/``poll_recv`` primitives plus
      ``rx_pending``/``tx_pending``/``fileno`` that the generic
      multi-link pumps (:mod:`rabit_tpu_torch.transport.pump`)
      multiplex over.  ``rx_pending()`` must be True only when
      ``poll_recv`` WILL make progress without new wire bytes, or the
      pump would busy-spin; ``needs_poll()`` marks transports whose
      readiness a plain ``poll`` cannot fully see (shm rings), bounding
      the pump's wait slices.
    """

    kind = "?"
    peer = -1

    # -- blocking ------------------------------------------------------
    def sendall(self, data) -> None:
        raise NotImplementedError

    def sendv(self, parts) -> None:
        raise NotImplementedError

    def recv_exact(self, nbytes: int, into=None):
        raise NotImplementedError

    # -- pump ----------------------------------------------------------
    def pump_begin(self) -> None:
        pass

    def pump_end(self) -> None:
        pass

    def pump_abort(self) -> None:
        """Exception-path pump exit: restore the blocking state but
        DROP any claimed-but-unsent framed tx backlog instead of
        flushing it.  The op is aborted and recovery rewires every link
        from scratch (engine ``_close_links`` + ``_reconnect_links``),
        so a flush here could only block — up to the full link timeout
        — on a peer that is itself aborting, delaying the LinkError the
        recovery path is waiting on.  Must never raise."""

    def poll_sendv(self, bufs: list) -> bool:
        """Non-blocking send attempt from ``bufs`` (mutated in place as
        payload is claimed).  True iff any progress was made."""
        raise NotImplementedError

    #: set by ``poll_recv``: True when the call moved RAW wire bytes
    #: even if it produced no plaintext yet (an integrity frame
    #: arriving in pieces) — the pumps re-arm their idle timeout on it,
    #: so a slowly-but-continuously delivering link never times out
    #: mid-frame.
    wire_progress = False

    def poll_recv(self, mv) -> int:
        """Non-blocking receive into ``mv``; bytes produced (0 = would
        block).  Must update ``wire_progress``."""
        raise NotImplementedError

    def rx_pending(self) -> bool:
        return False

    def tx_pending(self) -> bool:
        return False

    def needs_poll(self) -> bool:
        return False

    def drain_wakeups(self) -> None:
        """Consume queued doorbell bytes (shm); no-op elsewhere."""

    def arm_wait(self, rx: bool) -> None:
        """Advertise an imminent blocking wait for data (``rx``) or
        space (``not rx``) so the peer knows a wakeup is wanted (shm
        waiter flags); no-op elsewhere.  Callers must re-check
        readiness after arming and ``disarm_wait`` afterwards."""

    def disarm_wait(self, rx: bool) -> None:
        pass

    def fileno(self) -> int:
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------
    def healthy(self) -> bool:
        """Cheap liveness probe: False once the peer is known dead or
        the channel is structurally broken (closed fd, bad ring magic).
        Never blocks."""
        return True

    def close(self) -> None:
        raise NotImplementedError

    # -- shared raise helper -------------------------------------------
    def _fail(self, msg: str, cause: Optional[BaseException] = None,
              cls=LinkError):
        err = cls(msg)
        err.link = self
        if cause is not None:
            raise err from cause
        raise err
