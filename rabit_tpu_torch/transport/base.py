"""The Transport/Link interface — how engine bytes reach a peer.

PyTorch-port counterpart of :mod:`rabit_tpu.transport.base` (its own
copy: the port imports nothing of the JAX package).  The port has the
TCP link only; ``rabit_transport=shm``/``auto`` raise until the shm
rings are ported (ROADMAP A8).

Every worker-worker byte the pure-Python engines move flows through
a :class:`Link`: the engine wires one per peer at rendezvous (via
:class:`rabit_tpu_torch.transport.factory.LinkFactory`), the collective
schedules keep calling the engine's IO helpers (``_send``/``_recv``/
``_exchange``/``_recv_all``), and those helpers delegate here.  A link
owns exactly the byte-moving concerns — blocking and non-blocking
send/recv, vectored writes, timeouts, health — while the engine keeps
everything above the byte stream (op framing, reduction math, seqno/
replay, recovery).

The port's implementation is
:class:`rabit_tpu_torch.transport.tcp.TcpLink` (the classic TCP path,
byte-identical on the wire).  The reference also ships same-host
shared-memory rings (``ShmLink``).  A link optionally speaks
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

import socket
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


class LinkError(ConnectionError):
    """A worker-worker or tracker link failed (peer death or reset).

    Raised by every transport on IO failure; the robust engine's
    recovery path catches exactly this.  Instances raised inside a
    :class:`Link` carry the link as ``err.link`` so the engine can
    attribute the failure."""

    link: Optional["Link"] = None


class IntegrityError(LinkError):
    """Integrity framing detected wire corruption on a link.

    A frame's CRC trailer (or a structurally impossible frame length)
    did not match its payload after the transport's bounded re-read
    budget.  This IS a :class:`LinkError` on purpose: the pyrobust
    recovery path escalates it exactly like a peer death — the op
    retries from pristine buffers.  Without a robust layer it reaches
    the caller typed, never as silently wrong numbers."""


class Events:
    """Telemetry hooks the engine hands the transport layer (counters +
    trace events ride the engine's obs subsystem; the default sink
    drops everything, so transports never gate on obs config)."""

    def counter(self, name: str, n: int = 1) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass


NULL_EVENTS = Events()


class TransportConfig:
    """Resolved transport knobs (doc/parameters.md "Transports").

    ``transport``: ``tcp`` (default — byte-identical classic wire).
    ``shm``/``auto`` (the reference's shared-memory rings to
    same-host-group peers) raise :class:`NotImplementedError` here
    until the rings are ported (ROADMAP A8): nothing falls back to TCP
    silently.  ``integrity``: ``off`` | ``crc32`` | ``crc32c`` frame
    trailers.
    """

    def __init__(self, transport: str = "tcp",
                 integrity: str = "off") -> None:
        check(transport in TRANSPORT_MODES,
              "rabit_transport must be one of %s, got %r",
              "/".join(TRANSPORT_MODES), transport)
        if transport != "tcp":
            raise NotImplementedError(
                f"rabit_transport={transport!r}: the shared-memory "
                "transport is not ported yet (ROADMAP A8); use tcp")
        check(integrity in INTEGRITY_MODES,
              "rabit_wire_integrity must be one of %s, got %r",
              "/".join(INTEGRITY_MODES), integrity)
        self.transport = transport
        self.integrity = integrity

    @property
    def wants_integrity(self) -> bool:
        return self.integrity != "off"


def setup_stream_socket(sock: socket.socket,
                        timeout: Optional[float]) -> socket.socket:
    """The ONE socket-setup helper every TCP link creation path runs,
    so the latency options can never silently miss a link: TCP_NODELAY
    (small consensus words must not wait on Nagle) and the engine's
    link IO timeout.  (The reference also sizes the socket buffers from
    ``rabit_sock_buf``; that knob waits for its engine, ROADMAP A2.)
    """
    sock.settimeout(timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
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
      multi-link pumps (the reference's ``transport/pump.py``) multiplex
      over.  ``rx_pending()`` must be True only when ``poll_recv``
      WILL make progress without new wire bytes, or the pump would
      busy-spin.
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
    def _fail(self, msg: str, cause: Optional[BaseException] = None):
        err = LinkError(msg)
        err.link = self
        if cause is not None:
            raise err from cause
        raise err
