"""Link construction: handshake, feature negotiation, transport pick.

PyTorch-port counterpart of :mod:`rabit_tpu.transport.factory` (its own
copy), byte for byte the reference's handshake, so port and reference
peers negotiate with each other in both directions.

The engine dials/accepts raw TCP sockets (retry and backoff stay
engine-side); the factory turns each established socket into a
:class:`~rabit_tpu_torch.transport.base.Link`:

* **Default config** sends the CLASSIC handshake — ``u32 MAGIC, u32
  rank`` each way — so the wire is byte-identical to every previous
  release and to old peers.
* A worker with transport features configured (``rabit_transport``
  shm/auto toward a same-host-group peer, or any
  ``rabit_wire_integrity``) opens with ``XMAGIC`` instead and appends
  one feature string ("crc32c,shm:1048576").  An acceptor MIRRORS
  whichever magic it received and answers with its OWN offer (possibly
  empty), and each feature activates only in the INTERSECTION of the
  two offers — so a featured worker and a default-config worker
  interoperate in both directions, each link degrading to the common
  subset.
* An agreed shm link keeps the TCP connection as doorbell + liveness
  channel: the dialer creates the two ring files (one per direction),
  sends their paths, and the acceptor maps them — a cross-host peer
  that cannot open the paths answers 0 and BOTH sides fall back to
  TCP, which is also the self-verifying same-host check (the
  host-group handout nominates candidates; the filesystem proves it).
  Ring files are unlinked as soon as both sides hold the mapping, so a
  crashed worker leaks nothing.

**Failover** bookkeeping also lives here: the engine records a peer
whose shm link failed (health probe, ring fault, integrity escalation,
peer death) in :attr:`LinkFactory.denied`, and every later negotiation
with that peer simply never offers shm again — the recover rendezvous
that the LinkError already triggered re-dials the link as plain TCP,
mid-job.  So the engine keeps ONE factory for its life.

Of the reference factory's engine-side hooks the port takes
``sock_buf`` (``rabit_sock_buf``) and ``events`` (the engine's transport
counters); the chaos socket wrapper and plan, and link pacing, wait for
ROADMAP A8.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.transport import shm as shm_mod
from rabit_tpu_torch.transport.base import (Events, Link, NULL_EVENTS,
                                            SHM_RING_MIN, TransportConfig,
                                            setup_stream_socket)
from rabit_tpu_torch.transport.tcp import TcpLink
from rabit_tpu_torch.utils.checks import check, log

#: feature-negotiating link hello (the classic hello is protocol.MAGIC)
XMAGIC = 0x7AB17912
#: feature-string length cap (a handshake read, so bounded like all of
#: them — see protocol.MAX_HELLO_STR for the rationale)
MAX_FEATURES = 256


def _parse_offer(raw: str) -> dict:
    """``"crc32c,shm:1048576"`` → ``{"crc": "crc32c", "shm": 1048576}``.
    Unknown tokens are IGNORED (forward compatibility: a newer peer may
    offer features we cannot parse — the intersection simply excludes
    them)."""
    out: dict = {}
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok in ("crc32", "crc32c"):
            out["crc"] = tok
        elif tok.startswith("shm:"):
            try:
                out["shm"] = int(tok[4:])
            except ValueError:
                continue
    return out


class LinkFactory:
    """Per-engine link builder; topology and denial state mutate across
    rendezvous rounds, the config never does.  ``rank`` is the one sent
    in every hello: the engine sets it, with the host groups, through
    :meth:`set_topology` at every rendezvous.  ``sock_buf`` sizes
    SO_SNDBUF/SO_RCVBUF on every TCP link (0 keeps the kernel
    default)."""

    def __init__(self, cfg: TransportConfig, rank: int = 0, *,
                 timeout: Optional[float], sock_buf: int = 0,
                 events: Events = NULL_EVENTS) -> None:
        self.cfg = cfg
        self.timeout = timeout
        self.sock_buf = sock_buf
        self.events = events
        self.rank = int(rank)
        self.groups: list[int] = []
        #: peers whose shm link failed — permanently TCP for this
        #: process life (the engine's transport.failover.* counters
        #: mark each entry)
        self.denied: set[int] = set()
        self._shm_dir: Optional[str] = None

    # ------------------------------------------------------------------
    # topology / feature state
    # ------------------------------------------------------------------
    def set_topology(self, rank: int, groups: list[int]) -> None:
        self.rank = int(rank)
        self.groups = list(groups)

    def shm_dir(self) -> str:
        if self._shm_dir is None:
            self._shm_dir = self.cfg.shm_dir or shm_mod.default_shm_dir()
        return self._shm_dir

    def same_group(self, peer: int) -> bool:
        g = self.groups
        return (0 <= self.rank < len(g) and 0 <= peer < len(g)
                and g[self.rank] == g[peer])

    def _offer(self, peer: int) -> dict:
        feats: dict = {}
        if self.cfg.wants_integrity:
            feats["crc"] = self.cfg.integrity
        if (self.cfg.wants_shm and self.same_group(peer)
                and peer not in self.denied):
            feats["shm"] = self.cfg.shm_ring_bytes
        return feats

    @staticmethod
    def _offer_str(feats: dict) -> str:
        toks = []
        if "crc" in feats:
            toks.append(feats["crc"])
        if "shm" in feats:
            toks.append(f"shm:{feats['shm']}")
        return ",".join(toks)

    # ------------------------------------------------------------------
    # handshake
    # ------------------------------------------------------------------
    def dial(self, sock: socket.socket, peer: int) -> Link:
        """Upgrade an engine-dialed socket into a Link (dialer side of
        the link handshake)."""
        setup_stream_socket(sock, self.timeout, self.sock_buf)
        feats = self._offer(peer)
        if not feats:
            # Classic bytes: identical to every pre-transport release.
            P.send_u32(sock, P.MAGIC)
            P.send_u32(sock, self.rank)
            check(P.recv_u32(sock) == P.MAGIC, "link handshake: bad magic")
            check(P.recv_u32(sock) == peer, "link handshake: rank mismatch")
            return self._tcp_link(sock, peer, frames=False)
        P.send_u32(sock, XMAGIC)
        P.send_u32(sock, self.rank)
        P.send_str(sock, self._offer_str(feats))
        check(P.recv_u32(sock) == XMAGIC, "link handshake: bad magic "
              "(peer does not speak transport negotiation — upgrade it "
              "or clear rabit_transport/rabit_wire_integrity)")
        check(P.recv_u32(sock) == peer, "link handshake: rank mismatch")
        theirs = _parse_offer(P.recv_str(sock, max_len=MAX_FEATURES))
        frames = self._crc_agreed(peer, feats, theirs)
        if "shm" in feats and "shm" in theirs:
            link = self._dial_shm(sock, peer, theirs, frames)
            if link is not None:
                return link
        return self._tcp_link(sock, peer, frames=frames)

    def accept(self, sock: socket.socket) -> tuple[Link, int]:
        """Acceptor side; returns ``(link, peer_rank)``."""
        setup_stream_socket(sock, self.timeout, self.sock_buf)
        magic = P.recv_u32(sock)
        if magic == P.MAGIC:
            peer = P.recv_u32(sock)
            P.send_u32(sock, P.MAGIC)
            P.send_u32(sock, self.rank)
            return self._tcp_link(sock, peer, frames=False), peer
        check(magic == XMAGIC, "link handshake: bad magic")
        peer = P.recv_u32(sock)
        theirs = _parse_offer(P.recv_str(sock, max_len=MAX_FEATURES))
        feats = self._offer(peer)
        P.send_u32(sock, XMAGIC)
        P.send_u32(sock, self.rank)
        P.send_str(sock, self._offer_str(feats))
        frames = self._crc_agreed(peer, feats, theirs)
        if "shm" in feats and "shm" in theirs:
            link = self._accept_shm(sock, peer, frames)
            if link is not None:
                return link, peer
        return self._tcp_link(sock, peer, frames=frames), peer

    def _crc_agreed(self, peer: int, mine: dict, theirs: dict) -> bool:
        """Integrity activates only when both ends offered the SAME
        mode name: the two names are interchangeable today (both the
        stdlib CRC-32), but the moment ``crc32c`` becomes a real
        Castagnoli a mixed-mode link would reject every frame as
        corruption — so a mismatch deactivates framing (loudly) rather
        than arming a time bomb."""
        if "crc" not in mine or "crc" not in theirs:
            return False
        if mine["crc"] == theirs["crc"]:
            return True
        log("integrity mode mismatch with rank %d (%s vs %s): framing "
            "DISABLED on this link — align rabit_wire_integrity across the "
            "world", peer, mine["crc"], theirs["crc"])
        return False

    # ------------------------------------------------------------------
    # shm upgrade (ctrl socket = the handshake socket, kept open)
    # ------------------------------------------------------------------
    def _dial_shm(self, sock: socket.socket, peer: int, theirs: dict,
                  frames: bool) -> Optional[Link]:
        size = min(self.cfg.shm_ring_bytes, int(theirs["shm"]))
        if size < SHM_RING_MIN:
            # A skewed or garbled peer offer (tiny/zero/negative ring)
            # must take the clean tcp-fallback path: a degenerate ring
            # whose every write returns 0 would stall each send to the
            # link timeout instead of ever moving a byte.
            P.send_str(sock, "")   # protocol: empty path = dialer abort
            self._fallback(peer, "bad_ring_offer")
            return None
        made = []
        try:
            for _ in range(2):
                made.append(shm_mod.ShmRing.create(self.shm_dir(), size))
        except OSError as e:
            # A first ring made before the second failed goes too.
            for ring, path in made:
                self._unlink_rings(path)
                ring.close()
            log("shm ring creation failed (%s); link to rank %d stays tcp",
                e, peer)
            P.send_str(sock, "")   # protocol: empty path = dialer abort
            self._fallback(peer, "create_failed")
            return None
        (tx, path_tx), (rx, path_rx) = made
        try:
            P.send_str(sock, path_tx)
            P.send_str(sock, path_rx)
            ok = P.recv_u32(sock)
        except BaseException:
            # The peer died mid-exchange: tmpfs ring files surviving a
            # failed handshake would leak RAM on every failure re-dial,
            # so unlink + unmap before the error propagates.
            self._unlink_rings(path_tx, path_rx)
            tx.close()
            rx.close()
            raise
        # Both sides hold (or refused) the mapping now: the names are
        # no longer needed either way — a crash leaks nothing.
        self._unlink_rings(path_tx, path_rx)
        if not ok:
            tx.close()
            rx.close()
            self._fallback(peer, "peer_attach_failed")
            return None
        return self._shm_link(sock, peer, tx, rx, frames)

    @staticmethod
    def _unlink_rings(*paths: str) -> None:
        for path in paths:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _accept_shm(self, sock: socket.socket, peer: int,
                    frames: bool) -> Optional[Link]:
        path_tx_of_dialer = P.recv_str(sock, max_len=4096)
        if not path_tx_of_dialer:
            self._fallback(peer, "peer_create_failed")
            return None
        path_rx_of_dialer = P.recv_str(sock, max_len=4096)
        try:
            # Dialer's tx ring is our rx, and vice versa.
            rx = shm_mod.ShmRing.attach(path_tx_of_dialer)
        except OSError:
            P.send_u32(sock, 0)
            self._fallback(peer, "attach_failed")
            return None
        try:
            tx = shm_mod.ShmRing.attach(path_rx_of_dialer)
        except OSError:
            rx.close()
            P.send_u32(sock, 0)
            self._fallback(peer, "attach_failed")
            return None
        if rx.size < SHM_RING_MIN or tx.size < SHM_RING_MIN:
            # The dialer (version skew, corrupt offer) built rings our
            # release considers degenerate: refuse the attach so BOTH
            # sides land on tcp instead of a ring that can stall.
            tx.close()
            rx.close()
            P.send_u32(sock, 0)
            self._fallback(peer, "bad_ring_size")
            return None
        try:
            P.send_u32(sock, 1)
        except OSError:
            # Dialer died before our ack: drop the mappings (it owns
            # the unlink; our fds were the only thing pinning the RAM).
            tx.close()
            rx.close()
            raise
        return self._shm_link(sock, peer, tx, rx, frames)

    # ------------------------------------------------------------------
    # link construction + bookkeeping
    # ------------------------------------------------------------------
    def _tcp_link(self, sock: socket.socket, peer: int,
                  frames: bool) -> Link:
        self.events.counter("transport.links.tcp")
        return TcpLink(sock, peer, self.timeout, frames=frames)

    def _shm_link(self, sock: socket.socket, peer: int, tx, rx,
                  frames: bool) -> Link:
        self.events.counter("transport.links.shm")
        self.events.event("transport", phase="shm_link", peer=peer,
                          frames=frames)
        return shm_mod.ShmLink(sock, peer, tx, rx, self.timeout,
                               self.events, frames=frames,
                               retries=self.cfg.shm_retries)

    def _fallback(self, peer: int, why: str) -> None:
        self.events.counter("transport.shm.fallback")
        self.events.event("transport", phase="shm_fallback", peer=peer,
                          reason=why)
        if self.cfg.transport == "shm":
            log("rabit_transport=shm: link to rank %d fell back to tcp "
                "(%s)", peer, why)

    def deny(self, peer: int) -> bool:
        """Mark a peer's shm link failed; True when newly denied (the
        caller counts the failover exactly once)."""
        if not self.cfg.failover or peer in self.denied:
            return False
        self.denied.add(peer)
        return True
