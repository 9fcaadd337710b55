"""``ShmTransport``: same-host shared-memory ring-buffer links.

PyTorch-port counterpart of :mod:`rabit_tpu.transport.shm` (its own
copy: the port imports nothing of the JAX package), with the same ring
layout byte for byte, so a port rank and a reference rank share a ring.

The payload bytes move through a pair of mmap'd single-producer/
single-consumer ring buffers (one per direction) created in
``rabit_shm_dir`` (default ``/dev/shm``), while the already-established
TCP connection is RETAINED as the **doorbell + liveness channel**:
wakeup bytes ride it when a side transitions the ring from empty (or
frees a full ring), and a peer death surfaces as EOF on it — so a dead
shm peer is detected exactly like a dead TCP peer, never by spinning
forever on a frozen ring.

Ring layout (offsets in the mmap): ``u32 magic | u32 pad | u64 size |
u64 head | u64 tail``, the waiter flags at 32 and 36, data at byte 64.
``head``/``tail`` are free-running u64 cursors (writer owns head,
reader owns tail — one 8-byte aligned word each, so the two sides never
write the same word).  The writer copies payload THEN publishes
``head``; the reader loads ``head`` THEN copies — on x86's
total-store-order that is exactly the SPSC publication contract.
Weaker orderings are additionally covered by integrity framing's
bounded re-read: a torn read re-checks the CRC after a short pause
before escalating.

Readiness: a reader first spins briefly on the ring, then yield-polls,
then blocks on the doorbell fd in bounded slices, re-polling the ring
each slice so a lost wakeup costs milliseconds, not a hang.  The
engine's link IO timeout bounds the whole wait.

The reference's chaos hooks on this transport (torn writes, read-side
bit damage, swallowed doorbells under ``rabit_chaos``) are not ported
(ROADMAP A8); the engine refuses ``rabit_chaos``.
"""
from __future__ import annotations

import mmap
import os
import socket
import struct
import tempfile
import time
from typing import Optional

from rabit_tpu_torch.transport.base import (Events, IntegrityError, Link,
                                            NULL_EVENTS, advance_iov,
                                            flatten_parts,
                                            wait_readable_writable)
from rabit_tpu_torch.transport.framing import (CRC_BYTES, FRAME_MAX,
                                               HDR_BYTES, PlainBuffer,
                                               encode_frames, frame_crc)

RING_MAGIC = 0x7AB175B1
RING_HDR_BYTES = 64
_OFF_MAGIC = 0
_OFF_HEAD = 16
_OFF_TAIL = 24
# Sleep-advertisement flags (the SPSC waiter protocol): a side sets its
# flag before blocking on the doorbell fd, and the OTHER side rings
# only when the flag is up (then clears it).  Doorbell bytes are
# therefore bounded by actual sleeps — sending one per publish would
# slowly fill the ctrl socket buffer until every wakeup dropped and
# each hand-off degraded to a full poll slice.
_OFF_RWAIT = 32   # ring's reader is asleep waiting for data
_OFF_WWAIT = 36   # ring's writer is asleep waiting for space

#: ring polls before falling back to the doorbell fd (each poll is one
#: 8-byte read of the peer's cursor).  The busy phase is short and the
#: bulk of the budget is sched_yield polls: on an oversubscribed box
#: (more ranks than cores) the peer needs OUR timeslice to produce the
#: bytes we are waiting for.
SPIN_POLLS = 64
YIELD_POLLS = 256
#: doorbell wait slice: the lost-wakeup safety net — every blocked side
#: re-polls the ring at least this often, so a swallowed doorbell byte
#: (the benign publish/consume race) degrades latency by milliseconds
#: instead of hanging.
WAIT_SLICE_SEC = 0.002
#: pause between bounded re-reads of a CRC-failed frame (a torn-but-
#: completing write needs the writer's memcpy to finish, not long).
RETRY_PAUSE_SEC = 0.001

_DOORBELL = b"\x01"


def default_shm_dir() -> str:
    d = "/dev/shm"
    if os.path.isdir(d) and os.access(d, os.W_OK):
        return d
    return tempfile.gettempdir()


class ShmRing:
    """One single-writer single-reader mmap ring (byte stream)."""

    def __init__(self, mm: mmap.mmap, size: int, fileobj) -> None:
        self._mm = mm
        self._size = size
        self._file = fileobj          # kept open: the mapping's anchor
        self._buf = memoryview(mm)
        self._data = self._buf[RING_HDR_BYTES:RING_HDR_BYTES + size]

    @property
    def size(self) -> int:
        return self._size

    # -- construction --------------------------------------------------
    @classmethod
    def create(cls, dir_path: str, size: int) -> tuple["ShmRing", str]:
        fd, path = tempfile.mkstemp(prefix="rabit-shm-", dir=dir_path)
        f = os.fdopen(fd, "r+b")
        try:
            f.truncate(RING_HDR_BYTES + size)
            mm = mmap.mmap(f.fileno(), RING_HDR_BYTES + size)
        except (OSError, ValueError):
            # A full or size-capped directory: leave no half-made file.
            f.close()
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        struct.pack_into("<IIQQQ", mm, 0, RING_MAGIC, 0, size, 0, 0)
        return cls(mm, size, f), path

    @classmethod
    def attach(cls, path: str) -> "ShmRing":
        f = open(path, "r+b")
        try:
            mm = mmap.mmap(f.fileno(), 0)
        except (OSError, ValueError):
            f.close()
            raise
        magic, _pad, size = struct.unpack_from("<IIQ", mm, 0)
        if magic != RING_MAGIC or len(mm) != RING_HDR_BYTES + size:
            mm.close()
            f.close()
            raise OSError(f"not a rabit shm ring: {path}")
        return cls(mm, size, f)

    # -- cursors -------------------------------------------------------
    @property
    def head(self) -> int:
        return struct.unpack_from("<Q", self._buf, _OFF_HEAD)[0]

    @property
    def tail(self) -> int:
        return struct.unpack_from("<Q", self._buf, _OFF_TAIL)[0]

    def avail(self) -> int:
        return self.head - self.tail

    def space(self) -> int:
        return self._size - (self.head - self.tail)

    def magic_ok(self) -> bool:
        return struct.unpack_from("<I", self._buf, _OFF_MAGIC)[0] \
            == RING_MAGIC

    # -- waiter flags ---------------------------------------------------
    def set_reader_waiting(self, v: int) -> None:
        struct.pack_into("<I", self._mm, _OFF_RWAIT, v)

    @property
    def reader_waiting(self) -> int:
        return struct.unpack_from("<I", self._buf, _OFF_RWAIT)[0]

    def set_writer_waiting(self, v: int) -> None:
        struct.pack_into("<I", self._mm, _OFF_WWAIT, v)

    @property
    def writer_waiting(self) -> int:
        return struct.unpack_from("<I", self._buf, _OFF_WWAIT)[0]

    # -- writer side ---------------------------------------------------
    def write(self, mv) -> int:
        """Copy what fits, publish head AFTER the copy, return bytes
        taken (0 when full)."""
        head = self.head
        n = min(self._size - (head - self.tail), len(mv))
        if n <= 0:
            return 0
        self._copy_in(head % self._size, mv[:n])
        struct.pack_into("<Q", self._mm, _OFF_HEAD, head + n)
        return n

    def _copy_in(self, pos: int, src) -> None:
        first = min(len(src), self._size - pos)
        self._data[pos:pos + first] = src[:first]
        if first < len(src):
            self._data[:len(src) - first] = src[first:]

    # -- reader side ---------------------------------------------------
    def read(self, mv) -> int:
        n = min(self.avail(), len(mv))
        if n <= 0:
            return 0
        self.peek(0, mv[:n])
        self.advance(n)
        return n

    def peek(self, off: int, mv) -> None:
        """Copy ``len(mv)`` bytes at ``tail + off`` WITHOUT consuming
        (the framed reader verifies before it advances, which is what
        makes the bounded corrupted-frame re-read possible at all)."""
        pos = (self.tail + off) % self._size
        first = min(len(mv), self._size - pos)
        mv[:first] = self._data[pos:pos + first]
        if first < len(mv):
            mv[first:] = self._data[:len(mv) - first]

    def advance(self, n: int) -> None:
        struct.pack_into("<Q", self._mm, _OFF_TAIL, self.tail + n)

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        if self._mm is None:
            return  # idempotent: teardown paths may overlap
        # The views into the mapping go first: mmap.close() refuses
        # while an exported buffer is alive.
        self._data.release()
        self._buf.release()
        try:
            self._mm.close()
            self._file.close()
        except (OSError, ValueError):
            pass  # fd already invalid: the mapping dies with us anyway
        self._mm = None


class ShmLink(Link):
    kind = "shm"

    def __init__(self, ctrl: socket.socket, peer: int,
                 tx: ShmRing, rx: ShmRing, timeout: Optional[float],
                 events: Events = NULL_EVENTS, frames: bool = False,
                 retries: int = 3) -> None:
        self._ctrl = ctrl
        self._ctrl.setblocking(False)
        self.peer = peer
        self._tx = tx
        self._rx = rx
        self._timeout = timeout
        self._ev = events
        self._frames = frames
        self._retries = retries
        # A frame is verified WHOLE from the ring, so it must always be
        # able to become fully resident: cap frames well under the ring
        # capacity (both ends negotiated the same ring size, so sender
        # cap and receiver expectation agree).
        self._frame_max = min(FRAME_MAX, max(tx.size // 4, 1024))
        # Acceptance bound: generous (an honest peer caps at its ring/4
        # by the same formula) but strictly ring-fitting, so a corrupt
        # length can never name a frame that could not become resident
        # — that would stall to the timeout instead of detecting.
        self._rx_frame_cap = min(FRAME_MAX, rx.size - 8)
        self._plain = PlainBuffer()   # verified framed payload
        self._pend: list = []         # pump-mode tx backlog
        self._rx_seen_head = 0        # wire_progress watermark
        self._dead = False

    # ------------------------------------------------------------------
    # doorbell channel
    # ------------------------------------------------------------------
    def _doorbell(self) -> None:
        try:
            self._ctrl.send(_DOORBELL)
        except (BlockingIOError, InterruptedError):
            pass  # ctrl buffer full = wakeups already queued at the peer
        except OSError:
            # Peer teardown races a wakeup; the reader path will turn
            # the dead channel into a typed LinkError.
            self._dead = True

    def drain_wakeups(self) -> None:
        """Consume queued doorbell bytes.  EOF on the channel is the
        peer's close or death, a LinkError, except while bytes the peer
        published before it closed are still to be read (a whole frame,
        when framed): those are its last bytes, and the read that next
        finds nothing raises.  (The reference raises at once, so a
        reader that sleeps through its peer's last write and close loses
        those bytes: ROADMAP §C.)"""
        while True:
            try:
                got = self._ctrl.recv(4096)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self._dead = True
                self._fail(f"shm doorbell to rank {self.peer} failed: {e}",
                           e)
            if got == b"":
                self._dead = True
                if self.rx_pending():
                    return
                self._fail(f"rank {self.peer} closed the link")

    def arm_wait(self, rx: bool) -> None:
        """Advertise an imminent sleep (waiter-flag protocol): the peer
        rings the doorbell on its next publish/consume iff the flag is
        up, so wakeup bytes are bounded by actual sleeps.  Callers MUST
        re-check readiness AFTER arming (the peer may have acted in
        between — the residual store/load race costs one bounded
        slice, nothing more)."""
        if rx:
            self._rx.set_reader_waiting(1)
        else:
            if self._dead:
                # no one will free the space: the peer closed (its last
                # bytes may still be in our rx ring, see drain_wakeups)
                self._fail(f"rank {self.peer} closed the link")
            self._tx.set_writer_waiting(1)

    def disarm_wait(self, rx: bool) -> None:
        if rx:
            self._rx.set_reader_waiting(0)
        else:
            self._tx.set_writer_waiting(0)

    def _wait(self, deadline: Optional[float], what: str,
              ready=None, rx: bool = True) -> None:
        """One bounded wait for ring progress: drain wakeups, arm the
        waiter flag, RE-CHECK the ring, then sleep on the doorbell fd
        for at most a slice.  The re-check after arm+drain is
        load-bearing: the peer may have published between our last ring
        poll and the arm — sleeping then would turn its (unsent or
        already-drained) wakeup into a dead slice on every hot
        hand-off."""
        self.drain_wakeups()
        self.arm_wait(rx)
        try:
            if ready is not None and ready():
                return
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._fail(f"{what} rank {self.peer} timed out (shm)")
                slice_sec = min(WAIT_SLICE_SEC, left)
            else:
                slice_sec = WAIT_SLICE_SEC
            try:
                wait_readable_writable([self._ctrl], [], slice_sec)
            except (OSError, ValueError) as e:
                self._dead = True
                self._fail(f"shm doorbell to rank {self.peer} failed: {e}",
                           e)
        finally:
            self.disarm_wait(rx)

    def _deadline(self) -> Optional[float]:
        return (None if self._timeout is None
                else time.monotonic() + self._timeout)

    # ------------------------------------------------------------------
    # blocking send
    # ------------------------------------------------------------------
    def sendall(self, data) -> None:
        self.sendv([data])

    def sendv(self, parts) -> None:
        bufs = flatten_parts(parts)
        if self._frames:
            bufs = encode_frames(bufs, self._frame_max)
        deadline = self._deadline()
        for mv in bufs:
            off = 0
            while off < len(mv):
                n = self._ring_write(mv[off:])
                if n:
                    off += n
                    deadline = self._deadline()  # idle re-arm
                elif not self._spin(lambda: self._tx.space() > 0):
                    self._wait(deadline, "send to",
                               ready=lambda: self._tx.space() > 0,
                               rx=False)

    def _ring_write(self, mv) -> int:
        n = self._tx.write(mv)
        if n:
            if self._tx.reader_waiting:
                self._tx.set_reader_waiting(0)
                self._doorbell()
        return n

    def _note_consumed(self) -> None:
        """Ring bytes were just consumed: wake a space-starved writer
        that advertised a sleep."""
        if self._rx.writer_waiting:
            self._rx.set_writer_waiting(0)
            self._doorbell()

    # ------------------------------------------------------------------
    # blocking recv
    # ------------------------------------------------------------------
    def recv_exact(self, nbytes: int, into=None):
        buf = into if into is not None else memoryview(bytearray(nbytes))
        deadline = self._deadline()
        got = 0
        while got < nbytes:
            n = self._recv_some(buf[got:nbytes])
            if n:
                got += n
                deadline = self._deadline()  # idle re-arm
            elif not self._spin_rx():
                self._wait(deadline, "recv from", ready=self.rx_pending)
        return buf

    @staticmethod
    def _spin(ready) -> bool:
        """Brief busy poll, then yield-polls, before blocking on the
        doorbell: the same-host hot path wakes in well under a
        microsecond, and the yield phase hands the timeslice to the
        peer instead of burning it on an oversubscribed box."""
        for _ in range(SPIN_POLLS):
            if ready():
                return True
        for _ in range(YIELD_POLLS):
            os.sched_yield()
            if ready():
                return True
        return False

    def _spin_rx(self) -> bool:
        # rx_pending, not bare avail: a PARTIALLY resident frame must
        # not satisfy the spin (a hot loop would burn the timeslice the
        # writer needs to finish publishing it).
        return self._spin(self.rx_pending)

    def _recv_some(self, mv) -> int:
        """One non-waiting receive attempt into ``mv``."""
        if not self._frames:
            n = self._rx.read(mv)
            if n:
                self._note_consumed()
            return n
        n = self._plain.take(mv)
        if n:
            return n
        if not self._decode_frame():
            return 0
        return self._plain.take(mv)

    def _frame_ready(self):
        """Length of the next frame when it is FULLY resident in the
        ring, else None (the one header peek serves both the readiness
        check and the decode)."""
        avail = self._rx.avail()
        if avail < HDR_BYTES:
            return None
        hdr = bytearray(HDR_BYTES)
        self._rx.peek(0, hdr)
        (ln,) = struct.unpack("<I", hdr)
        if not 0 < ln <= self._rx_frame_cap:
            self._ev.counter("integrity.detected")
            self._ev.event("integrity", phase="detected", peer=self.peer,
                           transport=self.kind,
                           detail=f"impossible frame length {ln}")
            self._detect(f"impossible frame length {ln}")
        if avail < HDR_BYTES + ln + CRC_BYTES:
            return None
        return ln

    def _decode_frame(self) -> bool:
        """Verify-then-consume one frame from the ring; False when no
        complete frame is resident yet.  The CRC is checked on a PEEKED
        copy, so a mismatch can be re-read (bounded) before the typed
        escalation — a torn-but-completing write recovers
        transparently."""
        ln = self._frame_ready()
        if ln is None:
            return False
        body = bytearray(ln + CRC_BYTES)
        detected = False
        for attempt in range(self._retries + 1):
            self._rx.peek(HDR_BYTES, body)
            payload = memoryview(body)[:ln]
            (want,) = struct.unpack_from("<I", body, ln)
            if frame_crc(payload) == want:
                if detected:
                    self._ev.counter("integrity.recovered")
                    self._ev.event("integrity", phase="recovered",
                                   peer=self.peer, transport=self.kind,
                                   retries=attempt)
                self._rx.advance(HDR_BYTES + ln + CRC_BYTES)
                self._note_consumed()
                self._plain.push(payload)
                payload.release()
                return True
            payload.release()
            if not detected:
                detected = True
                self._ev.counter("integrity.detected")
                self._ev.event("integrity", phase="detected",
                               peer=self.peer, transport=self.kind,
                               detail=f"frame crc mismatch (len {ln})")
            if attempt < self._retries:
                self._ev.counter("integrity.retry")
                time.sleep(RETRY_PAUSE_SEC)
        self._detect(f"frame crc mismatch persisted across "
                     f"{self._retries} re-read(s) (len {ln})")

    def _detect(self, what: str):
        self._fail(f"wire corruption from rank {self.peer} detected "
                   f"(shm): {what}", cls=IntegrityError)

    # ------------------------------------------------------------------
    # pump
    # ------------------------------------------------------------------
    def pump_begin(self) -> None:
        pass

    def pump_end(self) -> None:
        if self._pend:
            deadline = self._deadline()
            for mv in self._pend:
                off = 0
                while off < len(mv):
                    n = self._ring_write(mv[off:])
                    if n:
                        off += n
                    else:
                        self._wait(deadline, "send to",
                                   ready=lambda: self._tx.space() > 0,
                                   rx=False)
            self._pend = []

    def pump_abort(self) -> None:
        self._pend = []

    def poll_sendv(self, bufs: list) -> bool:
        if self._frames:
            if not self._pend and bufs:
                self._pend = encode_frames(bufs, self._frame_max)
                del bufs[:]
            send_bufs = self._pend
        else:
            send_bufs = bufs
        if not send_bufs:
            return False
        n = self._ring_write(send_bufs[0])
        if n:
            advance_iov(send_bufs, n)
            return True
        return False

    def poll_recv(self, mv) -> int:
        # wire_progress: did the peer PUBLISH since our last poll?  A
        # large integrity frame arrives in several ring writes; the
        # pumps re-arm their idle timeout on this even while no
        # complete frame (hence no plaintext) is ready yet.
        head = self._rx.head
        self.wire_progress = head != self._rx_seen_head
        self._rx_seen_head = head
        n = self._recv_some(mv)
        if n == 0:
            self.drain_wakeups()  # surfaces peer death as LinkError
        return n

    def rx_pending(self) -> bool:
        if self._frames:
            return (self._plain.pending()
                    or self._frame_ready() is not None)
        return self._rx.avail() > 0

    def tx_pending(self) -> bool:
        return bool(self._pend)

    def needs_poll(self) -> bool:
        return True

    def fileno(self) -> int:
        return self._ctrl.fileno()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def healthy(self) -> bool:
        if self._dead:
            return False
        if not (self._tx.magic_ok() and self._rx.magic_ok()):
            return False
        try:
            self.drain_wakeups()
        except OSError:
            return False
        return not self._dead

    def close(self) -> None:
        try:
            self._ctrl.close()
        except OSError:
            pass
        self._tx.close()
        self._rx.close()
