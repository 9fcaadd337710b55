"""The port's shared-memory transport against rabit_tpu's, in one process.

Rings under ``tmp_path``, link pairs over ``socket.socketpair`` and
engine worlds on threads against an in-process tracker, as the JAX
package's ``tests/test_transport.py`` builds them.  The ring layout is
the reference's byte for byte, so rings made by one package are read by
the other; links, the factory's negotiation and whole worlds over shm
give the reference's bytes and bits, port with port and port with
reference.  Faults that the reference injects through its chaos plan
(not ported) come from a test seam here: a wrapped ring read or link
write on one instance.
"""
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from rabit_tpu.engine.pysocket import PySocketEngine as JEngine
from rabit_tpu.engine.robust import PyRobustEngine as JRobust
from rabit_tpu.ops import ReduceOp as JOp
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JTracker
from rabit_tpu.transport import base as jbase
from rabit_tpu.transport import factory as jfactory
from rabit_tpu.transport import shm as jshm
from rabit_tpu_torch.engine.pysocket import PySocketEngine
from rabit_tpu_torch.engine.robust import PyRobustEngine
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker
from rabit_tpu_torch.transport import base as tbase
from rabit_tpu_torch.transport import factory as tfactory
from rabit_tpu_torch.transport import shm as tshm
from torch_ref import ref_engine

SHM = {"torch": tshm, "jax": jshm}
BASE = {"torch": tbase, "jax": jbase}
FACTORY = {"torch": tfactory, "jax": jfactory}
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]
PAIR_IDS = [f"{a}-{b}" for a, b in PAIRS]
ENGINES = {"torch": PySocketEngine, "jax": ref_engine(JEngine),
           "torch-robust": PyRobustEngine, "jax-robust": ref_engine(JRobust)}
OPCODES = {"torch": ReduceOp, "jax": JOp}
JOIN_SEC = 60.0
TIMEOUT = 10.0
SIZES = [0, 1, 2, 3, 5, 7, 13, 100, 1001, 4097]


class _Counters:
    """Events stub recording transport-layer counters."""

    def __init__(self):
        self.counts = {}

    def counter(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def event(self, name, **fields):
        pass


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Ranks pinned to task ids (a port world and a reference world
    hand every input to the same rank); no group layout, schedule or
    timeout from the environment."""
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    monkeypatch.setenv("RABIT_TPU_LOG_TAG", "")
    for var in ("RABIT_TRACKER_SHUFFLE", "RABIT_TRACKER_GROUPS",
                "RABIT_TIMEOUT_SEC", "RABIT_OBS", "RABIT_SCHED",
                "RABIT_TRANSPORT", "RABIT_SHM_DIR"):
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------- rings
@pytest.mark.parametrize("maker,reader", PAIRS, ids=PAIR_IDS)
def test_ring_roundtrip_and_wraparound(tmp_path, maker, reader):
    """About ten capacities of seeded bytes in ragged chunks through a
    64-byte ring, so the cursors wrap many times and every copy splits
    at the boundary; one package makes the ring, the other reads it."""
    ring, path = SHM[maker].ShmRing.create(str(tmp_path), 64)
    peer = SHM[reader].ShmRing.attach(path)
    os.unlink(path)
    payload = np.random.default_rng(7).integers(
        0, 256, 640, dtype=np.uint8).tobytes()
    got = bytearray()
    off = 0
    while off < len(payload) or len(got) < len(payload):
        if off < len(payload):
            off += ring.write(memoryview(payload)[off:off + 37])
        buf = bytearray(29)
        n = peer.read(memoryview(buf))
        got += buf[:n]
    assert bytes(got) == payload
    assert ring.avail() == peer.avail() == 0
    assert ring.space() == peer.space() == 64
    assert ring.head == peer.tail == 640
    ring.close()
    peer.close()


@pytest.mark.parametrize("maker,reader", PAIRS, ids=PAIR_IDS)
def test_ring_peek_does_not_consume(tmp_path, maker, reader):
    ring, path = SHM[maker].ShmRing.create(str(tmp_path), 32)
    peer = SHM[reader].ShmRing.attach(path)
    os.unlink(path)
    ring.write(memoryview(b"abcdefgh"))
    first, again, mid = bytearray(4), bytearray(4), bytearray(3)
    peer.peek(0, memoryview(first))
    peer.peek(0, memoryview(again))
    assert bytes(first) == bytes(again) == b"abcd"
    assert peer.avail() == 8          # nothing consumed
    peer.peek(2, memoryview(mid))
    assert bytes(mid) == b"cde"
    peer.advance(8)
    assert peer.avail() == ring.avail() == 0
    ring.close()
    peer.close()


def test_ring_files_match_the_reference_byte_for_byte(tmp_path):
    """The same writes, reads and waiter flags leave the same file bytes
    in a ring of each package: header, cursors, flags and data."""
    files = {}
    rng = np.random.default_rng(11)
    chunks = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(1, 300, 12)]
    for pkg, mod in SHM.items():
        ring, path = mod.ShmRing.create(str(tmp_path), 4096)
        peer = mod.ShmRing.attach(path)
        for c in chunks:
            ring.write(memoryview(c))
            peer.read(memoryview(bytearray(len(c) // 2)))
        peer.set_reader_waiting(1)
        ring.set_writer_waiting(1)
        with open(path, "rb") as f:
            files[pkg] = f.read()
        os.unlink(path)
        ring.close()
        peer.close()
    assert files["torch"] == files["jax"]
    magic, _pad, size, head, tail, rwait, wwait = struct.unpack_from(
        "<IIQQQII", files["torch"])
    assert (magic, size) == (tshm.RING_MAGIC, 4096) == (0x7AB175B1, 4096)
    assert (head, rwait, wwait) == (sum(map(len, chunks)), 1, 1)
    assert tail == sum(len(c) // 2 for c in chunks)
    assert tshm.RING_HDR_BYTES == jshm.RING_HDR_BYTES == 64
    for name in ("SPIN_POLLS", "YIELD_POLLS", "WAIT_SLICE_SEC",
                 "RETRY_PAUSE_SEC", "_DOORBELL", "_OFF_RWAIT",
                 "_OFF_WWAIT"):
        assert getattr(tshm, name) == getattr(jshm, name), name


def test_attach_refuses_a_file_that_is_not_a_ring(tmp_path):
    path = tmp_path / "not-a-ring"
    path.write_bytes(b"\0" * 128)
    with pytest.raises(OSError, match="not a rabit shm ring"):
        tshm.ShmRing.attach(str(path))


# ------------------------------------------------------------ link pairs
def _pair(tmp_path, pkg_w="torch", pkg_r="torch", frames=True, ev_w=None,
          ev_r=None, ring=65536, retries=3):
    """A writer link of ``pkg_w`` and a reader link of ``pkg_r`` over two
    rings and one socketpair (the doorbell channel), as the factory
    wires a dialer and its acceptor."""
    a, b = socket.socketpair()
    r1, p1 = SHM[pkg_w].ShmRing.create(str(tmp_path), ring)
    r2, p2 = SHM[pkg_w].ShmRing.create(str(tmp_path), ring)
    w = SHM[pkg_w].ShmLink(a, 1, r1, r2, TIMEOUT,
                           ev_w or BASE[pkg_w].NULL_EVENTS, frames=frames,
                           retries=retries)
    r = SHM[pkg_r].ShmLink(b, 0, SHM[pkg_r].ShmRing.attach(p2),
                           SHM[pkg_r].ShmRing.attach(p1), TIMEOUT,
                           ev_r or BASE[pkg_r].NULL_EVENTS, frames=frames,
                           retries=retries)
    os.unlink(p1)
    os.unlink(p2)
    return w, r


@pytest.mark.parametrize("frames", [True, False], ids=["framed", "plain"])
@pytest.mark.parametrize("pkg_w,pkg_r", PAIRS, ids=PAIR_IDS)
def test_link_roundtrip_across_threads(tmp_path, pkg_w, pkg_r, frames):
    """100,000 seeded bytes through a 4 KiB ring (it wraps many times),
    vectored on the way in; then 333 bytes back the other way."""
    w, r = _pair(tmp_path, pkg_w, pkg_r, frames=frames, ring=4096)
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    back = rng.integers(0, 256, 333, dtype=np.uint8).tobytes()
    err, got_back = [], []

    def writer():
        try:
            w.sendv([payload[:333], payload[333:]])
            got_back.append(bytes(w.recv_exact(len(back))))
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            err.append(e)

    t = threading.Thread(target=writer)
    t.start()
    out = r.recv_exact(len(payload))
    r.sendall(back)
    t.join(timeout=30)
    assert not err, err
    assert bytes(out) == payload and got_back == [back]
    w.close()
    r.close()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_crc_failed_frame_recovered_by_the_reread(tmp_path, pkg):
    """A transient read fault (the first peek of the frame's body comes
    back with a flipped bit) is detected, re-read once and recovered:
    the same counters in both packages."""
    ev = _Counters()
    w, r = _pair(tmp_path, pkg, pkg, ev_r=ev)
    real_peek, hit = r._rx.peek, []

    def flipping_peek(off, mv):
        real_peek(off, mv)
        if off and not hit:         # the body, not the length header
            hit.append(off)
            mv[0] ^= 0x10
    r._rx.peek = flipping_peek
    w.sendall(b"payload under transient read damage")
    assert bytes(r.recv_exact(35)) == b"payload under transient read damage"
    assert hit and ev.counts == {"integrity.detected": 1,
                                 "integrity.retry": 1,
                                 "integrity.recovered": 1}
    w.close()
    r.close()


@pytest.mark.parametrize("retries", [0, 3])
@pytest.mark.parametrize("pkg_w,pkg_r", PAIRS, ids=PAIR_IDS)
def test_torn_write_escalates_to_integrity_error(tmp_path, pkg_w, pkg_r,
                                                  retries):
    """A torn ring write (a payload byte damaged in the ring, the
    writer's buffer intact) fails the CRC on every one of the reader's
    ``1 + shm_retries`` reads and raises a typed IntegrityError carrying
    the reader's link."""
    ev = _Counters()
    w, r = _pair(tmp_path, pkg_w, pkg_r, ev_r=ev, retries=retries)
    real_write = w._tx.write

    def torn_write(mv, *chaos):     # the reference's takes a chaos hook
        if len(mv) > 8:             # a payload part, not a header
            bad = bytearray(mv)
            bad[len(bad) // 2] ^= 0x01
            mv = memoryview(bad)
        return real_write(mv, *chaos)
    w._tx.write = torn_write
    w.sendall(b"x" * 512)
    with pytest.raises(BASE[pkg_r].IntegrityError) as info:
        r.recv_exact(512)
    assert isinstance(info.value, BASE[pkg_r].LinkError)
    assert info.value.link is r
    assert ev.counts == {"integrity.detected": 1,
                         **({"integrity.retry": retries} if retries
                            else {})}
    w.close()
    r.close()


@pytest.mark.parametrize("pkg_w,pkg_r", PAIRS, ids=PAIR_IDS)
def test_swallowed_doorbell_is_absorbed_by_the_wait_slice(tmp_path, pkg_w,
                                                          pkg_r):
    """The reader sleeps with its waiter flag up; the writer publishes
    but its wakeup byte is lost.  The reader's bounded wait slice
    re-polls the ring and takes the bytes long before the timeout."""
    w, r = _pair(tmp_path, pkg_w, pkg_r)
    rang = []
    w._doorbell = lambda: rang.append(1)    # the wakeup never leaves
    out = []
    t = threading.Thread(target=lambda: out.append(bytes(r.recv_exact(11))))
    t0 = time.monotonic()
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while not w._tx.reader_waiting and time.monotonic() < deadline:
        time.sleep(0.0005)      # the reader has gone to sleep on its fd
    w.sendall(b"wakeup-less")
    t.join(timeout=TIMEOUT)
    assert out == [b"wakeup-less"] and rang
    assert time.monotonic() - t0 < 5
    w.close()
    r.close()


def test_peer_death_on_the_doorbell_is_a_link_error(tmp_path):
    """A reader waiting on a ring whose peer closed its end raises a
    LinkError attributed to its link, not a hang."""
    w, r = _pair(tmp_path)
    w.close()
    with pytest.raises(tbase.LinkError, match="closed the link") as info:
        r.recv_exact(4)
    assert info.value.link is r and not r.healthy()
    r.close()


@pytest.mark.parametrize("frames", [True, False], ids=["framed", "plain"])
def test_bytes_published_before_a_close_are_read_differs_on_purpose(
        tmp_path, frames):
    """The writer publishes its last bytes and closes before the reader
    looks again; the reader's next wait drains the doorbell channel
    first and meets EOF.  The reference raises there, though the bytes
    are in the ring; the port's reader takes them, and the read after
    them raises "closed the link"."""
    payload = np.random.default_rng(9).integers(0, 256, 3000,
                                                dtype=np.uint8).tobytes()
    for pkg in ("jax", "torch"):
        w, r = _pair(tmp_path, "torch", pkg, frames=frames)
        w.sendall(payload)
        w.close()
        if pkg == "jax":
            with pytest.raises(jbase.LinkError, match="closed the link"):
                r.drain_wakeups()
        else:
            r.drain_wakeups()
            assert bytes(r.recv_exact(len(payload))) == payload
            with pytest.raises(tbase.LinkError, match="closed the link"):
                r.recv_exact(1)
            assert not r.healthy()
        r.close()


def test_a_dead_peers_partial_frame_fails_at_once(tmp_path):
    """A peer that dies halfway through a frame leaves bytes that will
    never make a frame: the reader raises on the close at once, not
    after its link timeout."""
    w, r = _pair(tmp_path)
    w._tx.write(memoryview(struct.pack("<I", 100) + b"half a frame"))
    w.close()
    t0 = time.monotonic()
    with pytest.raises(tbase.LinkError, match="closed the link"):
        r.recv_exact(100)
    assert time.monotonic() - t0 < 1.0
    r.close()


@pytest.mark.parametrize("how", ["blocking", "pump"])
def test_a_writer_blocked_on_a_closed_peer_fails_at_once(tmp_path, how):
    """The peer left a byte in our rx ring and closed while our send
    waits for ring space it will never free: the send raises at once
    (a 4 KiB ring, 100 KB to send)."""
    from rabit_tpu_torch.transport import pump

    w, r = _pair(tmp_path, ring=4096)
    r.sendall(b"x")
    r.close()
    payload = memoryview(bytes(100_000))
    t0 = time.monotonic()
    with pytest.raises(tbase.LinkError, match="closed the link"):
        if how == "blocking":
            w.sendall(payload)
        else:
            pump.exchange(w, [payload], w, [], TIMEOUT)
    assert time.monotonic() - t0 < 1.0
    w.close()


# ----------------------------------------------------- factory handshake
def tcp_pair():
    with socket.socket() as lst:
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        a = socket.create_connection(lst.getsockname(), timeout=TIMEOUT)
        b, _ = lst.accept()
    b.settimeout(TIMEOUT)
    return a, b


def factory(pkg, rank, groups, events=None, **cfg):
    kw = {}
    if events is not None:
        kw["events"] = events
    f = FACTORY[pkg].LinkFactory(BASE[pkg].TransportConfig(**cfg),
                                 timeout=TIMEOUT, **kw)
    f.set_topology(rank, list(groups))
    return f


def handshake(dialer, acceptor):
    a, b = tcp_pair()
    out, errors = {}, []

    def run(key, fn):
        try:
            out[key] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(
                   "dial", lambda: dialer.dial(a, peer=acceptor.rank))),
               threading.Thread(target=run, args=(
                   "accept", lambda: acceptor.accept(b)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    if errors:
        raise errors[0]
    return out["dial"], out["accept"][0]


def _exchange(x, y):
    p = np.random.default_rng(5).integers(0, 256, 70_000,
                                          dtype=np.uint8).tobytes()
    t = threading.Thread(target=lambda: x.sendall(p))
    t.start()
    got = bytes(y.recv_exact(len(p)))
    t.join(TIMEOUT)
    assert got == p


@pytest.mark.parametrize("groups,kind", [([0, 0], "shm"), ([0, 1], "tcp")],
                         ids=["same-group", "cross-group"])
@pytest.mark.parametrize("integrity", ["off", "crc32c"])
@pytest.mark.parametrize("dial_pkg,acc_pkg", PAIRS,
                         ids=[f"{a}-dials-{b}" for a, b in PAIRS])
def test_negotiation_picks_shm_within_a_group(tmp_path, dial_pkg, acc_pkg,
                                             integrity, groups, kind):
    """Same host group: shm on both ends, rings made by the dialer and
    unlinked once the acceptor acked; cross group: TCP, no ring made.
    Integrity framing rides either."""
    evs = (_Counters(), _Counters())
    kw = dict(transport="shm", integrity=integrity, shm_dir=str(tmp_path))
    dialer = factory(dial_pkg, 0, groups, evs[0], **kw)
    acceptor = factory(acc_pkg, 1, groups, evs[1], **kw)
    x, y = handshake(dialer, acceptor)
    try:
        for link, peer in ((x, 1), (y, 0)):
            assert link.kind == kind and link.peer == peer
            assert link._frames == (integrity != "off")
        _exchange(x, y)
        _exchange(y, x)
        assert list(tmp_path.iterdir()) == []
        for ev in evs:
            assert ev.counts == {f"transport.links.{kind}": 1}
    finally:
        x.close()
        y.close()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_accept_refuses_degenerate_rings(tmp_path, pkg):
    """A dialer shipping rings under the floor is refused at attach: the
    dialer is told 0 and the acceptor falls back."""
    a, b = socket.socketpair()
    ev = _Counters()
    lf = factory(pkg, 0, [0, 0], ev, transport="shm")
    tiny = [SHM[pkg].ShmRing.create(str(tmp_path), 16) for _ in range(2)]
    answers = []

    def dialer():
        for _ring, path in tiny:
            P.send_str(a, path)
        answers.append(P.recv_u32(a))

    t = threading.Thread(target=dialer)
    t.start()
    assert lf._accept_shm(b, 1, frames=False) is None
    t.join(timeout=TIMEOUT)
    assert answers == [0]
    assert ev.counts == {"transport.shm.fallback": 1}
    for ring, _path in tiny:
        ring.close()
    a.close()
    b.close()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_dial_rejects_a_tiny_negotiated_ring(pkg):
    """A negotiated ring under the floor takes the dialer-abort path: an
    empty path on the wire, no ring made, the fallback counted."""
    a, b = socket.socketpair()
    ev = _Counters()
    lf = factory(pkg, 0, [0, 0], ev, transport="shm")
    assert lf._dial_shm(a, 1, {"shm": 16}, frames=False) is None
    assert JP.recv_str(b, max_len=4096) == ""
    assert ev.counts == {"transport.shm.fallback": 1}
    a.close()
    b.close()


@pytest.mark.parametrize("bad", ["missing", "a-file"])
@pytest.mark.parametrize("dial_pkg,acc_pkg", PAIRS,
                         ids=[f"{a}-dials-{b}" for a, b in PAIRS])
def test_unwritable_shm_dir_falls_back_to_tcp(tmp_path, dial_pkg, acc_pkg,
                                              bad, capfd):
    """A dialer whose ``rabit_shm_dir`` cannot hold a ring builds no
    ring, aborts the upgrade, and both ends land on TCP with the
    fallback counted (logged where ``rabit_transport=shm``)."""
    shm_dir = tmp_path / "missing"
    if bad == "a-file":
        shm_dir = tmp_path / "file"
        shm_dir.write_bytes(b"")
    evs = (_Counters(), _Counters())
    dialer = factory(dial_pkg, 0, [0, 0], evs[0], transport="shm",
                     shm_dir=str(shm_dir))
    acceptor = factory(acc_pkg, 1, [0, 0], evs[1], transport="auto",
                       shm_dir=str(tmp_path))
    x, y = handshake(dialer, acceptor)
    try:
        assert x.kind == y.kind == "tcp"
        _exchange(x, y)
        for ev in evs:
            assert ev.counts == {"transport.shm.fallback": 1,
                                 "transport.links.tcp": 1}
        if dial_pkg == "torch":
            err = capfd.readouterr().err
            assert "shm ring creation failed" in err
            assert "fell back to tcp (create_failed)" in err
    finally:
        x.close()
        y.close()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_second_ring_failure_differs_on_purpose(tmp_path, monkeypatch,
                                                pkg):
    """The dialer's second ring fails after its first was made: both
    packages abort the upgrade and count the fallback, but the port
    also unlinks and unmaps the first ring, where the reference leaves
    its file behind (a tmpfs file is RAM until the directory is
    cleaned)."""
    real, made = SHM[pkg].ShmRing.create, []

    def second_fails(dir_path, size):
        if made:
            raise OSError("no space left on device")
        made.append(real(dir_path, size))
        return made[-1]
    monkeypatch.setattr(SHM[pkg].ShmRing, "create",
                        staticmethod(second_fails))
    a, b = socket.socketpair()
    ev = _Counters()
    lf = factory(pkg, 0, [0, 0], ev, transport="shm",
                 shm_dir=str(tmp_path))
    assert lf._dial_shm(a, 1, {"shm": 1 << 20}, frames=False) is None
    assert JP.recv_str(b, max_len=4096) == ""
    assert ev.counts == {"transport.shm.fallback": 1}
    left = [p.name for p in tmp_path.iterdir()]
    if pkg == "torch":
        assert left == []
    else:
        assert left == [os.path.basename(made[0][1])]
        made[0][0].close()
    a.close()
    b.close()


def test_denied_peer_is_offered_tcp_and_failover_off_denies_nothing():
    lf = factory("torch", 0, [0, 0, 1], transport="auto")
    assert "shm" in lf._offer(1) and "shm" not in lf._offer(2)
    assert lf.deny(1) and not lf.deny(1)
    assert "shm" not in lf._offer(1) and lf.denied == {1}
    off = factory("torch", 0, [0, 0], transport="shm", failover=False)
    assert not off.deny(1) and "shm" in off._offer(1)


# ---------------------------------------------------------- engine worlds
def _run_world(kinds, body, params, tracker=Tracker):
    """One engine per entry of ``kinds`` on a thread against one
    in-process tracker; ``body(eng, kind)`` runs between init and
    shutdown.  Returns {rank: body's result}."""
    world = len(kinds)
    trk = tracker(world, "127.0.0.1", 0)
    trk.start()
    out, errs = {}, []
    # A reference reader takes a peer's close for its death even while
    # the peer's last bytes sit in the ring (ROADMAP §C), so in a world
    # with reference ranks nobody shuts down before every body is done.
    done = threading.Barrier(world, timeout=JOIN_SEC)
    hold = any(not k.startswith("torch") for k in kinds)

    def run(i):
        eng = ENGINES[kinds[i]]()
        try:
            eng.init({"rabit_tracker_uri": "127.0.0.1",
                      "rabit_tracker_port": trk.port,
                      "rabit_task_id": str(i), "rabit_world_size": world,
                      "rabit_timeout_sec": 20, "rabit_obs": 0,
                      **params[i]})
            out[eng.rank] = body(eng, kinds[i].split("-")[0])
            if hold:
                done.wait()
            eng.shutdown()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append((i, e))
            done.abort()
            eng._close_links()          # let the peers fail, not hang
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(world)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_SEC
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    alive = [t for t in threads if t.is_alive()]
    trk.stop()
    assert not alive, f"{len(alive)} rank thread(s) still running"
    assert not errs, errs
    assert sorted(out) == list(range(world))
    return out


def _links(eng):
    return {peer: link.kind for peer, link in eng._links.items()}


def _parity_ladder(eng, kind):
    """The reference's ``sched_parity`` ladder (exact-arithmetic int64
    SUM, float32 MAX and float64 SUM of small integers at zero, one and
    odd sizes) plus a float32 SUM of seeded normals, whose bits depend
    on the reduction order; returns the results and the link kinds."""
    codes = OPCODES[kind]
    rank, res = eng.rank, {}
    for size in SIZES:
        res[size, "i64"] = (np.arange(size, dtype=np.int64) * (rank + 1)) % 97
        res[size, "f32max"] = (np.arange(size, dtype=np.float32) + rank) % 11.0
        res[size, "f64"] = np.asarray((np.arange(size) * (rank + 2)) % 53,
                                      np.float64)
        res[size, "f32"] = np.random.default_rng([rank, size]).standard_normal(
            size).astype(np.float32)
        eng.allreduce(res[size, "i64"], codes.SUM)
        eng.allreduce(res[size, "f32max"], codes.MAX)
        eng.allreduce(res[size, "f64"], codes.SUM)
        eng.allreduce(res[size, "f32"], codes.SUM)
    return res, _links(eng)


def _ladder_want(world):
    want = {}
    for size in SIZES:
        idx = np.arange(size)
        want[size, "i64"] = sum((idx.astype(np.int64) * (r + 1)) % 97
                                for r in range(world)).astype(np.int64)
        want[size, "f32max"] = (np.max([(idx.astype(np.float32) + r) % 11.0
                                        for r in range(world)], axis=0)
                                if size else np.zeros(0, np.float32))
        want[size, "f64"] = sum(((idx * (r + 2)) % 53).astype(np.float64)
                                for r in range(world))
    return want


@pytest.mark.parametrize("sched", ["tree", "ring", "halving", "hier"])
@pytest.mark.parametrize("world", [2, 4, 5])
def test_parity_ladder_over_shm(tmp_path, world, sched):
    """Every schedule over an all-shm same-host world with a 4 KB
    reduce buffer (every schedule chunks): the exact-arithmetic ladder
    equals numpy's, and every result, the order-dependent float32 sums
    too, has the bits of a reference world over shm."""
    params = [{"rabit_transport": "shm", "rabit_sched": sched,
               "rabit_reduce_buffer": "4KB",
               "rabit_shm_dir": str(tmp_path)}] * world
    got = _run_world(["torch"] * world, _parity_ladder, params)
    ref = _run_world(["jax"] * world, _parity_ladder, params,
                     tracker=JTracker)
    want = _ladder_want(world)
    for rank in range(world):
        res, kinds = got[rank]
        assert kinds and set(kinds.values()) == {"shm"}
        assert ref[rank][1] == kinds
        for key, a in res.items():
            b = ref[rank][0][key]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
            assert a.tobytes() == got[0][0][key].tobytes(), key
            if key in want:
                np.testing.assert_array_equal(a, want[key], err_msg=str(key))
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("integrity", ["off", "crc32c"])
def test_largest_level_wraps_small_rings(tmp_path, integrity):
    """The largest GBDT level's 4,210,688 B through 64 KiB rings (each
    direction wraps dozens of times, the pump's partial ring writes and
    reads on every hop): a port world of 3 and a mixed one give a
    reference world's bits, and integer-valued sums are exact."""
    n = 1_052_672

    def body(eng, kind):
        a = np.random.default_rng(eng.rank).standard_normal(n).astype(
            np.float32)
        b = np.full(n, eng.rank + 1, np.float32)
        eng.allreduce(a, OPCODES[kind].SUM)
        eng.allreduce(b, OPCODES[kind].SUM)
        return a, b, _links(eng)

    params = [{"rabit_transport": "shm", "rabit_wire_integrity": integrity,
               "rabit_shm_ring_bytes": "64KB",
               "rabit_shm_dir": str(tmp_path)}] * 3
    got = _run_world(["torch"] * 3, body, params)
    mixed = _run_world(["jax", "torch", "jax"], body, params)
    ref = _run_world(["jax"] * 3, body, params, tracker=JTracker)
    for rank in range(3):
        for world in (got, mixed):
            a, b, links = world[rank]
            assert set(links.values()) == {"shm"}
            assert a.tobytes() == ref[rank][0].tobytes()
            np.testing.assert_array_equal(b, np.full(n, 6, np.float32))


def _mixed_body(eng, kind):
    codes = OPCODES[kind]
    out = {}
    for size in (7, 4097, 20000, 300_000):
        for op in ("SUM", "PROD"):
            a = np.random.default_rng([eng.rank, size]).standard_normal(size)
            eng.allreduce(a, getattr(codes, op))
            out[size, op] = a
    out["bcast"] = eng.broadcast(b"m" * 70000 if eng.rank == 2 else None, 2)
    out["gather"] = eng.allgather(np.array([eng.rank], np.int32))
    out["links"] = _links(eng)
    return out


@pytest.mark.parametrize("integrity", ["off", "crc32c"])
def test_mixed_world_over_shm(tmp_path, integrity):
    """Port ranks 1 and 3 with reference ranks 0 and 2 in one world of
    4, every link shm (rings made by either package, read by the
    other): the bits of an all-reference world."""
    params = [{"rabit_transport": "shm", "rabit_wire_integrity": integrity,
               "rabit_shm_dir": str(tmp_path)}] * 4
    mixed = _run_world(["jax", "torch", "jax", "torch"], _mixed_body,
                       params)
    ref = _run_world(["jax"] * 4, _mixed_body, params, tracker=JTracker)
    for rank in range(4):
        assert set(mixed[rank]["links"].values()) == {"shm"}
        for key, a in ref[rank].items():
            b = mixed[rank][key]
            if isinstance(a, np.ndarray):
                assert a.tobytes() == b.tobytes(), (rank, key)
            else:
                assert a == b, (rank, key)


@pytest.mark.parametrize("kinds", [["torch"] * 4,
                                   ["torch", "jax", "jax", "torch"]],
                         ids=["port", "mixed"])
def test_auto_follows_the_host_groups(tmp_path, monkeypatch, kinds):
    """``rabit_transport=auto`` in a simulated two-host world of 4: a
    link is shm exactly when its two ranks share a host group, and the
    sums are exact (the reference's test_cross_group_peers_stay_tcp)."""
    monkeypatch.setenv("RABIT_TRACKER_GROUPS", "0,0,1,1")
    groups = [0, 0, 1, 1]

    def body(eng, kind):
        a = np.arange(1000, dtype=np.float64) + eng.rank
        eng.allreduce(a, OPCODES[kind].SUM)
        np.testing.assert_array_equal(a, 4 * np.arange(1000) + 6)
        return _links(eng), list(eng._groups)

    params = [{"rabit_transport": "auto",
               "rabit_shm_dir": str(tmp_path)}] * 4
    got = _run_world(kinds, body, params)
    kinds = set()
    for rank, (links, handed) in got.items():
        assert handed == groups
        for peer, kind in links.items():
            assert kind == ("shm" if groups[peer] == groups[rank]
                            else "tcp"), (rank, peer)
            kinds.add(kind)
    assert kinds == {"shm", "tcp"}


def test_counters_of_a_world_over_shm(tmp_path):
    """Each rank counts its links by kind; nothing falls back."""
    params = [{"rabit_transport": "shm",
               "rabit_shm_dir": str(tmp_path)}] * 3
    got = _run_world(["torch"] * 3, lambda eng, kind:
                     eng.transport_counters(), params)
    assert all(c == {"transport.links.shm": 2} for c in got.values()), got


def _tear_once(monkeypatch):
    """The test seam for a torn ring write: the first payload part (not a
    4-byte frame header or trailer) that rank 1's link to rank 0 puts in
    its ring lands with its last byte damaged, the writer's buffer
    intact.  Returns the list the torn write's length lands in."""
    real, torn = tshm.ShmLink._ring_write, []

    def tearing(self, mv):
        if self.peer == 0 and not torn and len(mv) > 8 \
                and self._tx.space() > 0:
            bad = bytearray(mv[:min(len(mv), self._tx.space())])
            bad[-1] ^= 0x40
            torn.append(len(bad))
            mv = memoryview(bad)
        return real(self, mv)
    monkeypatch.setattr(tshm.ShmLink, "_ring_write", tearing)
    return torn


def test_torn_write_fails_over_to_tcp(tmp_path, monkeypatch):
    """A ``pyrobust`` world of 2 over framed shm links: rank 1's first
    ring write of a payload part is torn (``_tear_once``), so rank 0's
    reader raises IntegrityError.  Both ends deny the peer, the recover
    rendezvous re-dials the link as TCP, the sums stay exact, the
    failover is counted, and a later recover rendezvous keeps the link
    TCP."""
    torn = _tear_once(monkeypatch)

    def body(eng, kind):
        kinds = [_links(eng)]
        for i in range(4):
            a = np.arange(50_000, dtype=np.float64) * (eng.rank + 1) + i
            eng.allreduce(a, ReduceOp.SUM)
            np.testing.assert_array_equal(
                a, np.arange(50_000, dtype=np.float64) * 3 + 2 * i)
            kinds.append(_links(eng))
        eng._rendezvous_recover()               # a later rendezvous
        b = np.full(10, eng.rank + 1.0)
        eng.allreduce(b, ReduceOp.SUM)
        np.testing.assert_array_equal(b, np.full(10, 3.0))
        kinds.append(_links(eng))
        return kinds, eng.transport_counters(), set(eng._lf.denied)

    params = [{"rabit_transport": "shm", "rabit_wire_integrity": "crc32c",
               "rabit_timeout_sec": 15,
               "rabit_shm_dir": str(tmp_path)}] * 2
    got = _run_world(["torch-robust"] * 2, body, params)
    assert torn
    for rank, (kinds, counts, denied) in got.items():
        peer = 1 - rank
        assert kinds[0] == {peer: "shm"}
        assert kinds[-1] == kinds[-2] == {peer: "tcp"}
        assert denied == {peer}
        assert counts["transport.failover.shm_to_tcp"] == 1
        assert counts["transport.failover"] == 1
        assert counts["transport.links.shm"] == 1
        assert counts["transport.links.tcp"] == 2
    assert got[0][1]["integrity.detected"] == 1
    assert got[0][1]["integrity.retry"] == 3
    assert list(tmp_path.iterdir()) == []


def test_failover_off_redials_shm(tmp_path, monkeypatch):
    """With ``rabit_transport_failover=0`` the same torn write still
    sends both ranks through recovery with exact sums, but nothing is
    denied: the re-dialed link is shm again."""
    torn = _tear_once(monkeypatch)

    def body(eng, kind):
        for i in range(3):
            a = np.arange(50_000, dtype=np.float64) * (eng.rank + 1) + i
            eng.allreduce(a, ReduceOp.SUM)
            np.testing.assert_array_equal(
                a, np.arange(50_000, dtype=np.float64) * 3 + 2 * i)
        return _links(eng), eng.transport_counters()

    params = [{"rabit_transport": "shm", "rabit_wire_integrity": "crc32c",
               "rabit_transport_failover": "0", "rabit_timeout_sec": 15,
               "rabit_shm_dir": str(tmp_path)}] * 2
    got = _run_world(["torch-robust"] * 2, body, params)
    assert torn
    for rank, (links, counts) in got.items():
        assert links == {1 - rank: "shm"}
        assert counts["transport.links.shm"] == 2
        assert "transport.failover" not in counts
