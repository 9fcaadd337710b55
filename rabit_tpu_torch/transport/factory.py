"""Link construction: handshake, feature negotiation, transport pick.

PyTorch-port counterpart of :mod:`rabit_tpu.transport.factory`, TCP
path only: the port never offers ``shm`` (the shared-memory rings wait
for ROADMAP A8, and :class:`TransportConfig` raises for them), so every
link it builds is a :class:`TcpLink`, framed or plain.

The engine dials/accepts raw TCP sockets (retry and backoff stay
engine-side); the factory turns each established socket into a
:class:`~rabit_tpu_torch.transport.base.Link`:

* **Default config** sends the CLASSIC handshake — ``u32 MAGIC, u32
  rank`` each way — so the wire is byte-identical to every previous
  release and to old peers.
* A worker with ``rabit_wire_integrity`` configured opens with
  ``XMAGIC`` instead and appends one feature string ("crc32c").  An
  acceptor MIRRORS whichever magic it received and answers with its OWN
  offer (possibly empty), and each feature activates only in the
  INTERSECTION of the two offers — so a featured worker and a
  default-config worker interoperate in both directions, each link
  degrading to the common subset.  A reference peer that offers
  ``shm:<bytes>`` meets an offer without it here, so that link is TCP
  on both ends, exactly as the reference's own negotiation decides.

The reference factory's engine-side knobs (socket buffers, a socket
wrapper, telemetry, the shm failover bookkeeping) come with the engine
that sets them (ROADMAP A2, A8).
"""
from __future__ import annotations

import socket
from typing import Optional

from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.transport.base import (Link, TransportConfig,
                                            setup_stream_socket)
from rabit_tpu_torch.transport.tcp import TcpLink
from rabit_tpu_torch.utils.checks import check, log

#: feature-negotiating link hello (the classic hello is protocol.MAGIC)
XMAGIC = 0x7AB17912
#: feature-string length cap (a handshake read, so bounded like all of
#: them — see protocol.MAX_HELLO_STR for the rationale)
MAX_FEATURES = 256


def _parse_offer(raw: str) -> dict:
    """``"crc32c,shm:1048576"`` → ``{"crc": "crc32c"}``.  Unknown tokens
    are IGNORED (forward compatibility: a newer peer may offer features
    we cannot parse — the intersection simply excludes them); ``shm:``
    is one of them here, as the port builds no shm link."""
    out: dict = {}
    for tok in raw.split(","):
        tok = tok.strip()
        if tok in ("crc32", "crc32c"):
            out["crc"] = tok
    return out


class LinkFactory:
    """Link builder for one rank: ``rank`` is the one its rendezvous
    reply gave it, sent in every hello."""

    def __init__(self, cfg: TransportConfig, rank: int, *,
                 timeout: Optional[float]) -> None:
        self.cfg = cfg
        self.rank = int(rank)
        self.timeout = timeout

    # ------------------------------------------------------------------
    # feature offer
    # ------------------------------------------------------------------
    def _offer(self, peer: int) -> dict:
        feats: dict = {}
        if self.cfg.wants_integrity:
            feats["crc"] = self.cfg.integrity
        return feats

    @staticmethod
    def _offer_str(feats: dict) -> str:
        return feats.get("crc", "")

    # ------------------------------------------------------------------
    # handshake
    # ------------------------------------------------------------------
    def dial(self, sock: socket.socket, peer: int) -> Link:
        """Upgrade an engine-dialed socket into a Link (dialer side of
        the link handshake)."""
        setup_stream_socket(sock, self.timeout)
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
              "or clear rabit_wire_integrity)")
        check(P.recv_u32(sock) == peer, "link handshake: rank mismatch")
        theirs = _parse_offer(P.recv_str(sock, max_len=MAX_FEATURES))
        frames = self._crc_agreed(peer, feats, theirs)
        return self._tcp_link(sock, peer, frames=frames)

    def accept(self, sock: socket.socket) -> tuple[Link, int]:
        """Acceptor side; returns ``(link, peer_rank)``."""
        setup_stream_socket(sock, self.timeout)
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
    # link construction
    # ------------------------------------------------------------------
    def _tcp_link(self, sock: socket.socket, peer: int,
                  frames: bool) -> Link:
        return TcpLink(sock, peer, self.timeout, frames=frames)
