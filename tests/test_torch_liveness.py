"""The port's liveness layer against rabit_tpu's, on threads in one process.

The heartbeat channel (``rabit_heartbeat_sec``), the tracker's dead
verdicts, registrant sweep, stall watchdog and orphan GC, and the
launcher's hung-rank killers.  Every tracker case gives the port's
``Tracker`` and ``rabit_tpu``'s the same stimulus over loopback sockets
on port 0 and compares what they decide: ``on_dead`` and ``on_stall``
calls, the job's liveness events, which parked registrants go and which
stay.  Engines' heartbeat bytes are captured by a stub tracker and held
byte for byte against the reference engine's; mixed worlds run port
engines under the reference tracker and the reference's under the
port's.  A rank "hangs" on a thread the way a SIGSTOP'd process does:
its heartbeat stops and its next op blocks with its sockets open, until
the tracker's verdict "kills" it (its links and channel close with no
goodbye) and the harness starts its next life with the same trial.
"""
import json
import socket
import struct
import threading
import time
import types

import numpy as np
import pytest

from rabit_tpu.engine.pysocket import PySocketEngine as JEngine
from rabit_tpu.engine.robust import PyRobustEngine as JRobust
from rabit_tpu.tracker import launch_local as ref_launch
from rabit_tpu.tracker import tracker as jtracker_mod
from rabit_tpu_torch.engine.pysocket import PySocketEngine
from rabit_tpu_torch.engine.robust import PyRobustEngine
from rabit_tpu_torch.tracker import launch_local as port_launch
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker import tracker as tracker_mod
from rabit_tpu_torch.utils import RabitError
from test_torch_pysocket_learn import KM_K
from test_torch_robust import _app, _killable, _Killed, _results
from test_torch_robust import per_thread  # noqa: F401 — fixture
from torch_ref import ref_engine

PKGS = ("torch", "jax")
MODS = {"torch": tracker_mod, "jax": jtracker_mod}
ENGINES = {"torch": PySocketEngine, "jax": ref_engine(JEngine)}
ROBUST = {"torch": _killable(PyRobustEngine),
          "jax": _killable(ref_engine(JRobust))}
WAIT_SEC = 10.0
JOIN_SEC = 30.0
_REF_WORLD = {}      # the all-reference k-means world, run once


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Ranks pinned to task ids; no liveness knob from the outside."""
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    monkeypatch.setenv("RABIT_TPU_LOG_TAG", "")
    for var in ("RABIT_TRACKER_SHUFFLE", "RABIT_TRACKER_GROUPS",
                "RABIT_TIMEOUT_SEC", "RABIT_OBS", "RABIT_SCHED",
                "RABIT_MOCK", "RABIT_NUM_TRIAL", "RABIT_HEARTBEAT_SEC",
                "RABIT_HEARTBEAT_MISS", "RABIT_JOB_GC_SEC",
                "RABIT_ELASTIC", "RABIT_CKPT_DIR"):
        monkeypatch.delenv(var, raising=False)


def _wait(pred, sec=WAIT_SEC):
    deadline = time.monotonic() + sec
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _tracker(pkg, world, **kw):
    t = MODS[pkg].Tracker(world, "127.0.0.1", 0, **kw)
    t.start()
    return t


def _stop(t):
    """Stop a tracker and wait for run(): the reference's stop() does not
    wake a blocked accept(), so the listener is shut down first."""
    try:
        t._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    t.stop()
    t.join(5)
    assert not t._thread.is_alive()


def _hello(t, cmd, task, job="default", world=2, period_ms=None):
    """One tracker command connection; the caller owns the socket."""
    s = socket.create_connection((t.host, t.port), timeout=WAIT_SEC)
    P.send_hello(s, cmd, task, world, job=job)
    if period_ms is not None:
        P.send_u32(s, period_ms)
    return s


def _park(t, task, job="default", world=2, cmd=P.CMD_START):
    """A registrant parked in the rendezvous barrier."""
    s = _hello(t, cmd, task, job=job, world=world)
    P.send_str(s, "127.0.0.1")
    P.send_u32(s, 9000)
    return s


def _job(t, name="default"):
    """A job's state, finished or not."""
    with t._jobs_lock:
        return t._jobs.get(name)


def _pending(t, name="default"):
    job = _job(t, name)
    with job._pending_lock:
        return sorted(r.task_id for r in job._pending)


def _phases(t, task, job="default", keys=()):
    """The job's liveness events of one task: (phase, *keys)."""
    return [(e["phase"],) + tuple(e.get(k) for k in keys)
            for e in list(_job(t, job)._events)
            if e.get("name") == "liveness" and e.get("task") == task]


def _closed_by_peer(s, sec=WAIT_SEC):
    s.settimeout(sec)
    try:
        return s.recv(1) == b""
    except OSError:
        return True


def _pair(fn):
    """``{pkg: fn(pkg)}`` for the port and the reference, run side by
    side on two threads (each on its own tracker or stub and sockets)."""
    got, errs = {}, []

    def run(pkg):
        try:
            got[pkg] = fn(pkg)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)
    threads = [threading.Thread(target=run, args=(pkg,), daemon=True)
               for pkg in PKGS]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_SEC)
    assert not any(th.is_alive() for th in threads), "a scenario hung"
    if errs:
        raise errs[0]
    return got


def _both(scenario):
    """Run ``scenario(pkg)`` for the port's tracker and the reference's;
    each must give the same summary."""
    got = _pair(scenario)
    assert got["torch"] == got["jax"], got
    return got["torch"]


# ------------------------------------------------------ the engine's bytes
class _Buf:
    """recv() over captured bytes, for the protocol's readers."""

    def __init__(self, data):
        self.data = memoryview(data)

    def recv(self, n):
        out, self.data = bytes(self.data[:n]), self.data[n:]
        return out


class _ByteStub:
    """A tracker that answers one registration with a world-1 topology
    and records every later connection's bytes raw, to EOF.  With
    ``drop_after`` it closes the first heartbeat connection after that
    many bytes."""

    def __init__(self, drop_after=None):
        self.conns = []           # raw bytes of each later connection
        self.drop_after = drop_after
        self.lst = socket.socket()
        self.lst.bind(("127.0.0.1", 0))
        self.lst.listen(16)
        self.port = self.lst.getsockname()[1]
        self.threads = []
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        first = True
        while True:
            try:
                sock, _ = self.lst.accept()
            except OSError:
                return
            if first:
                first = False
                with sock:
                    P.recv_hello(sock)
                    P.recv_str(sock)
                    P.recv_u32(sock)
                    P.TopologyReply(rank=0, world=1, parent=P.NONE,
                                    ring_prev=0, ring_next=0).send(sock)
                continue
            buf = bytearray()
            self.conns.append(buf)
            th = threading.Thread(target=self._record, args=(sock, buf),
                                  daemon=True)
            th.start()
            self.threads.append(th)

    def _record(self, sock, buf):
        with sock:
            sock.settimeout(WAIT_SEC)
            while True:
                try:
                    chunk = sock.recv(4096)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                if (self.drop_after is not None and buf is self.conns[0]
                        and len(buf) >= self.drop_after):
                    return

    def close(self):
        try:
            self.lst.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.lst.close()
        for th in self.threads:
            th.join(WAIT_SEC)


def _parse_channel(raw):
    """(hello, period_ms, beats) of one heartbeat connection."""
    buf = _Buf(raw)
    hello = P.recv_hello(buf)
    period = P.recv_u32(buf)
    rest = bytes(buf.data)
    beats = list(struct.unpack(f"<{len(rest) // 4}I", rest))
    return hello, period, beats, len(raw) - len(rest)


def _engine_channels(kind, params, run_sec, drop_after=None):
    stub = _ByteStub(drop_after)
    try:
        eng = ENGINES[kind]()
        eng.init({"rabit_tracker_uri": "127.0.0.1",
                  "rabit_tracker_port": stub.port, "rabit_timeout_sec": 5,
                  "rabit_backoff_base_ms": 1, "rabit_obs": 0, **params})
        time.sleep(run_sec)
        eng.shutdown()
        assert _wait(lambda: any(_cmd_of(c) == P.CMD_SHUTDOWN
                                 for c in list(stub.conns)))
    finally:
        stub.close()
    return [bytes(c) for c in stub.conns]


def _cmd_of(raw):
    try:
        return P.recv_hello(_Buf(bytes(raw)))[1]
    except (OSError, ValueError):     # not all of it yet
        return None


@pytest.mark.parametrize("job,task,world,sec", [
    ("default", "0", 0, 0.05), ("tenant-a", "3", 3, 0.05),
    ("default", "7", 2, 0.3)])
def test_heartbeat_bytes_match_reference(job, task, world, sec):
    """The channel's hello, its u32 period, beats 1..n and the bye on
    shutdown, then the shutdown command: the port engine's bytes are the
    reference engine's, byte for byte up to the number of beats."""
    params = {"rabit_task_id": task, "rabit_world_size": world,
              "rabit_heartbeat_sec": sec}
    if job != "default":
        params["rabit_job_id"] = job
    got = _pair(lambda kind: _engine_channels(kind, params, 4.5 * sec))
    for kind, conns in got.items():
        assert len(conns) == 2, (kind, conns)   # heartbeat, shutdown
        hello, period, beats, head = _parse_channel(conns[0])
        assert hello == (job, P.CMD_HEARTBEAT, task, world)
        assert period == int(sec * 1000)
        n = len(beats) - 1
        assert n >= 3 and beats == list(range(1, n + 1)) + [
            P.HEARTBEAT_BYE], (kind, beats)
        assert P.recv_hello(_Buf(conns[1])) == (job, P.CMD_SHUTDOWN, task,
                                                world)
    assert got["torch"][0][:head] == got["jax"][0][:head]
    assert got["torch"][1] == got["jax"][1]


def test_heartbeat_redials_after_the_channel_drops():
    """A tracker that drops the channel is dialled again within a period
    or two; beats keep counting up across the channels, and only the
    last carries the bye — for both engines."""
    shapes = {}
    got = _pair(lambda kind: _engine_channels(
        kind, {"rabit_heartbeat_sec": 0.05}, 1.0, drop_after=38))
    for kind, conns in got.items():
        channels = [_parse_channel(c) for c in conns[:-1]]
        assert len(channels) >= 2, (kind, len(conns))
        beats = [b for ch in channels for b in ch[2]]
        assert beats[-1] == P.HEARTBEAT_BYE
        assert all(b != P.HEARTBEAT_BYE for ch in channels[:-1]
                   for b in ch[2])
        seq = beats[:-1]
        assert seq == sorted(set(seq)) and seq[0] == 1, (kind, seq)
        shapes[kind] = [ch[:2] for ch in channels[:2]]
    assert shapes["torch"] == shapes["jax"]


@pytest.mark.parametrize("value", ["0", 0, None])
def test_heartbeat_off_opens_no_channel(value):
    """``rabit_heartbeat_sec`` unset or 0: no channel, only the
    shutdown command, from either engine."""
    params = {} if value is None else {"rabit_heartbeat_sec": value}
    for kind in PKGS:
        conns = _engine_channels(kind, params, 0.1)
        assert [_cmd_of(c) for c in conns] == [P.CMD_SHUTDOWN], kind


def test_negative_period_fails_its_check():
    for kind, err in (("torch", RabitError), ("jax", Exception)):
        with pytest.raises(err, match="rabit_heartbeat_sec must be >= 0"):
            ENGINES[kind]().init({"rabit_tracker_uri": "127.0.0.1",
                                  "rabit_tracker_port": 1,
                                  "rabit_heartbeat_sec": -1})


def test_pyrobust_beats_while_it_runs_and_says_bye():
    """The pyrobust engine keeps the channel (the knob it refused
    before): the port's tracker sees it alive, then its clean shutdown,
    and the job finishes."""
    t = _tracker("torch", 1)
    try:
        eng = PyRobustEngine()
        eng.init({"rabit_tracker_uri": "127.0.0.1",
                  "rabit_tracker_port": t.port, "rabit_task_id": "0",
                  "rabit_heartbeat_sec": 0.05})
        assert _wait(lambda: _phases(t, "0") == [("alive",)])
        time.sleep(0.2)
        _settle_after_bye(eng)
        eng.shutdown()
        assert _phases(t, "0") == [("alive",), ("shutdown",)]
        t.join(WAIT_SEC)
        assert not t._thread.is_alive()
    finally:
        _stop(t)


def test_empty_engine_has_no_heartbeat():
    import rabit_tpu_torch

    rabit_tpu_torch.init(rabit_engine="empty", rabit_heartbeat_sec=1)
    try:
        assert not [th for th in threading.enumerate()
                    if th.name == "rabit-heartbeat"]
    finally:
        rabit_tpu_torch.finalize()


# ---------------------------------------------------- the tracker's verdicts
def test_deadline_marks_dead_and_evicts_registrant():
    """``tests/test_tracker.py``'s deadline case: beats stop with the
    socket open (the SIGSTOP shape), the verdict comes within the miss
    budget, the parked registrant is evicted and closed, and on_dead
    names the task."""
    def scenario(pkg):
        dead = []
        t = _tracker(pkg, 2, heartbeat_miss=2.0, on_dead=dead.append)
        try:
            reg = _park(t, "0")
            hb = _hello(t, P.CMD_HEARTBEAT, "0", period_ms=100)
            for i in range(3):
                P.send_u32(hb, i + 1)
                time.sleep(0.05)
            assert _wait(lambda: dead)
            assert _wait(lambda: not _pending(t))
            out = (dead[0], _closed_by_peer(reg), _phases(t, "0"),
                   "0" in _job(t)._lost_tasks)
            hb.close()
            reg.close()
            return out
        finally:
            _stop(t)
    assert _both(scenario) == ("0", True, [("alive",), ("dead",)], True)


def test_bye_and_relaunch_transitions():
    """``tests/test_tracker.py``'s bye case: a clean bye never earns a
    verdict, and a second channel for the task is its relaunched life."""
    def scenario(pkg):
        dead = []
        t = _tracker(pkg, 2, heartbeat_miss=2.0, on_dead=dead.append)
        try:
            hb = _hello(t, P.CMD_HEARTBEAT, "1", period_ms=50)
            P.send_u32(hb, 1)
            P.send_u32(hb, P.HEARTBEAT_BYE)
            hb.close()
            time.sleep(0.5)         # several miss budgets
            hb2 = _hello(t, P.CMD_HEARTBEAT, "1", period_ms=50)
            P.send_u32(hb2, 1)
            assert _wait(lambda: len(_phases(t, "1")) == 3)
            P.send_u32(hb2, P.HEARTBEAT_BYE)
            hb2.close()
            assert _wait(lambda: len(_phases(t, "1")) == 4)
            return dead, _phases(t, "1", keys=("relaunched",))
        finally:
            _stop(t)
    assert _both(scenario) == ([], [("alive", None), ("shutdown", None),
                                    ("alive", 1), ("shutdown", None)])


def test_eof_without_bye_is_lost_without_eviction():
    """A channel that ends without the bye is a lost process: a "lost"
    event and a loss verdict, but no on_dead (the launcher sees the
    process itself) and no eviction by the heartbeat layer."""
    def scenario(pkg):
        dead = []
        t = _tracker(pkg, 2, heartbeat_miss=2.0, on_dead=dead.append)
        try:
            reg = _park(t, "0")
            hb = _hello(t, P.CMD_HEARTBEAT, "0", period_ms=50)
            P.send_u32(hb, 1)
            time.sleep(0.05)
            hb.close()
            assert _wait(lambda: ("lost",) in _phases(t, "0"))
            time.sleep(0.4)
            out = (dead, _pending(t), _phases(t, "0"),
                   sorted(_job(t)._lost_tasks))
            reg.close()
            return out
        finally:
            _stop(t)
    assert _both(scenario) == ([], ["0"], [("alive",), ("lost",)], ["0"])


def test_beats_after_a_verdict_clear_it():
    """The SIGCONT shape: beats that resume on the same channel withdraw
    the verdict, with a "resumed" alive event."""
    def scenario(pkg):
        dead = []
        t = _tracker(pkg, 2, heartbeat_miss=2.0, on_dead=dead.append)
        try:
            hb = _hello(t, P.CMD_HEARTBEAT, "0", period_ms=50)
            P.send_u32(hb, 1)
            assert _wait(lambda: dead)
            lost = "0" in _job(t)._lost_tasks
            for b in range(2, 6):
                P.send_u32(hb, b)
                time.sleep(0.02)
            assert _wait(lambda: len(_phases(t, "0")) == 3)
            out = (dead[:1], lost, "0" in _job(t)._lost_tasks,
                   _phases(t, "0", keys=("resumed",)))
            P.send_u32(hb, P.HEARTBEAT_BYE)
            hb.close()
            return out
        finally:
            _stop(t)
    assert _both(scenario) == (["0"], True, False,
                               [("alive", None), ("dead", None),
                                ("alive", 1)])


def test_standing_verdict_renotifies_without_evicting_the_next_life():
    """While a verdict stands, on_dead is called again once every miss
    budget (at least 0.5 s apart); the eviction was the first verdict's
    only, so the registrant the task's next life parks stays."""
    def scenario(pkg):
        calls = []
        t = _tracker(pkg, 2, heartbeat_miss=2.0,
                     on_dead=lambda task: calls.append(time.monotonic()))
        try:
            reg = _park(t, "0")
            hb = _hello(t, P.CMD_HEARTBEAT, "0", period_ms=100)
            P.send_u32(hb, 1)
            assert _wait(lambda: calls)
            assert _wait(lambda: not _pending(t))
            nxt = _park(t, "0")       # the next life, same task
            assert _wait(lambda: len(calls) >= 3, 3.0)
            gaps = np.diff(calls[:3])
            out = (bool((gaps >= 0.45).all()), _pending(t),
                   _closed_by_peer(reg, 0.5),
                   [p for p in _phases(t, "0") if p == ("dead",)])
            for s in (hb, reg, nxt):
                s.close()
            return out
        finally:
            _stop(t)
    assert _both(scenario) == (True, ["0"], True, [("dead",)])


def _obs_frame(payload):
    raw = json.dumps(payload).encode()
    raw += b" " * (-len(raw) % 4)
    return struct.pack("<II", P.HEARTBEAT_OBS, len(raw)) + raw


def test_obs_frames_keep_a_peer_alive_and_are_not_echoed():
    """A streaming reference worker's obs frames count as beats: frames
    alone keep it alive past the miss budget.  The reference then echoes
    each beat (for its ``hb.rtt``); the port drops the payload and
    never echoes, which such a worker reads as no samples."""
    echoes = {}

    def scenario(pkg):
        dead = []
        t = _tracker(pkg, 2, heartbeat_miss=2.0, on_dead=dead.append)
        try:
            hb = _hello(t, P.CMD_HEARTBEAT, "0", period_ms=100)
            P.send_u32(hb, 1)
            for _ in range(8):           # 0.8 s of frames, no beat
                hb.sendall(_obs_frame({"rank": 0, "world": 2}))
                time.sleep(0.1)
            hb.settimeout(0.08)
            echoes[pkg] = b""
            for b in range(2, 6):     # beats, each waiting for its echo
                P.send_u32(hb, b)
                try:
                    echoes[pkg] += hb.recv(64)
                except socket.timeout:
                    pass
            P.send_u32(hb, P.HEARTBEAT_BYE)
            assert _wait(lambda: len(_phases(t, "0")) == 2)
            hb.close()
            return dead, _phases(t, "0")
        finally:
            _stop(t)
    assert _both(scenario) == ([], [("alive",), ("shutdown",)])
    assert echoes == {"torch": b"", "jax": struct.pack("<4I", 2, 3, 4, 5)}


def test_split_frames_and_beats_wait_for_their_bytes():
    """A beat and an obs frame cut at odd byte offsets are read whole
    once their bytes arrive: no verdict, no lost channel."""
    def scenario(pkg):
        dead = []
        t = _tracker(pkg, 2, heartbeat_miss=3.0, on_dead=dead.append)
        try:
            hb = _hello(t, P.CMD_HEARTBEAT, "0", period_ms=200)
            stream = (struct.pack("<I", 1) + _obs_frame({"rank": 0})
                      + struct.pack("<II", 2, P.HEARTBEAT_BYE))
            for cut in (3, 6, 9, 15, len(stream) - 5, len(stream)):
                hb.sendall(stream[:cut])
                stream = stream[cut:]
                time.sleep(0.08)
                if not stream:
                    break
            assert _wait(lambda: len(_phases(t, "0")) == 2)
            hb.close()
            return dead, _phases(t, "0")
        finally:
            _stop(t)
    assert _both(scenario) == ([], [("alive",), ("shutdown",)])


def test_oversized_obs_frame_drops_the_channel():
    def scenario(pkg):
        t = _tracker(pkg, 2, heartbeat_miss=2.0)
        try:
            hb = _hello(t, P.CMD_HEARTBEAT, "0", period_ms=100)
            P.send_u32(hb, 1)
            hb.sendall(struct.pack("<II", P.HEARTBEAT_OBS,
                                   P.MAX_PRINT_LEN + 1))
            closed = _closed_by_peer(hb)
            hb.close()
            with _job(t)._hb_lock:
                peers = dict(_job(t)._hb_peers)
            return closed, peers, _phases(t, "0")
        finally:
            _stop(t)
    assert _both(scenario) == (True, {}, [("alive",)])


def test_heartbeat_for_an_unknown_job_is_closed():
    def scenario(pkg):
        t = _tracker(pkg, 2)
        try:
            hb = _hello(t, P.CMD_HEARTBEAT, "0", job="ghost",
                        period_ms=100)
            closed = _closed_by_peer(hb)
            hb.close()
            return closed, t._job_get("ghost")
        finally:
            _stop(t)
    assert _both(scenario) == (True, None)


def test_verdicts_stay_in_their_job():
    """Task "0" lives in two jobs: its beats stop in one only.  That
    job's registrant goes and its timeline says dead; the other job's
    "0" stays parked and alive."""
    def scenario(pkg):
        dead = []
        t = _tracker(pkg, 2, heartbeat_miss=2.0, on_dead=dead.append)
        try:
            regs = [_park(t, "0", job=j) for j in ("ja", "jb")]
            hbs = {j: _hello(t, P.CMD_HEARTBEAT, "0", job=j, period_ms=50)
                   for j in ("ja", "jb")}
            P.send_u32(hbs["ja"], 1)
            for b in range(1, 20):
                P.send_u32(hbs["jb"], b)
                time.sleep(0.03)
            assert _wait(lambda: not _pending(t, "ja"))
            # the snapshot comes before the bye: a bye drained first
            # would add a "shutdown" to jb's phases
            out = (sorted(set(dead)), _pending(t, "jb"),
                   _phases(t, "0", "ja"), _phases(t, "0", "jb"))
            P.send_u32(hbs["jb"], P.HEARTBEAT_BYE)
            for s in regs + list(hbs.values()):
                s.close()
            return out
        finally:
            _stop(t)
    assert _both(scenario) == (["0"], ["0"], [("alive",), ("dead",)],
                               [("alive",)])


# ------------------------------------------------------- registrant sweep
def test_sweep_drops_a_closed_registrant_and_the_round_reopens():
    """A registrant that dies while parked is dropped with a "lost"
    event (barrier=1); its relaunch and the last rank complete the
    round."""
    def scenario(pkg):
        t = _tracker(pkg, 3)
        try:
            r0, r1 = _park(t, "0", world=3), _park(t, "1", world=3)
            r0.close()
            assert _wait(lambda: _pending(t) == ["1"])
            phases = _phases(t, "0", keys=("barrier",))
            lost = sorted(_job(t)._lost_tasks)
            socks = [r1, _park(t, "0", world=3), _park(t, "2", world=3)]
            ranks = []
            for s in socks:
                ranks.append(P.TopologyReply.recv(s).rank)
                s.close()
            return phases, lost, ranks, sorted(_job(t)._lost_tasks)
        finally:
            _stop(t)
    assert _both(scenario) == ([("lost", 1)], ["0"], [1, 0, 2], [])


@pytest.mark.parametrize("parked,world", [(2, 2), (1, 2), (2, 3)])
def test_sweep_and_eviction_leave_a_full_round(parked, world):
    """``sweep_registrants_once`` and ``_evict_registrant`` on parked
    sockets whose peers closed: a full round is the reply loop's and is
    never touched; a partial one loses them, with their events."""
    def scenario(pkg):
        job = MODS[pkg].JobState(types.SimpleNamespace(), "j", world)
        pairs = [socket.socketpair() for _ in range(parked)]
        job._pending = [MODS[pkg]._Registrant(a, str(i), "h", 1)
                        for i, (a, _) in enumerate(pairs)]
        for _, b in pairs:
            b.close()
        job._evict_registrant("0", "test")
        after_evict = sorted(r.task_id for r in job._pending)
        job.sweep_registrants_once()
        out = (after_evict, sorted(r.task_id for r in job._pending),
               [(e["phase"], e["task"], e.get("barrier"))
                for e in job._events], sorted(job._lost_tasks))
        for a, _ in pairs:
            a.close()
        return out
    assert _both(scenario) == {
        (2, 2): (["0", "1"], ["0", "1"], [], []),
        (1, 2): ([], [], [], []),
        (2, 3): (["1"], [], [("lost", "1", 1)], ["1"])}[(parked, world)]


# ------------------------------------------------------------- watchdog
def test_watchdog_names_present_and_finished_and_rearms():
    """After a full round, task "2" shuts down and "0" and "1" come back
    to recover: the round sits partly filled, and on_stall gets the
    present and finished task sets, again only after another full
    period, until the round fills."""
    def scenario(pkg):
        calls = []
        t = _tracker(pkg, 3, watchdog_sec=0.4,
                     on_stall=lambda p, f: calls.append(
                         (time.monotonic(), sorted(p), sorted(f))))
        try:
            socks = [_park(t, str(i), world=3) for i in range(3)]
            for s in socks:
                P.TopologyReply.recv(s)
                s.close()
            _hello(t, P.CMD_SHUTDOWN, "2", world=3).close()
            assert _wait(lambda: "2" in _job(t)._shutdown_tasks)
            time.sleep(0.6)
            quiet = list(calls)
            regs = [_park(t, str(i), world=3, cmd=P.CMD_RECOVER)
                    for i in range(2)]
            assert _wait(lambda: len(calls) >= 3, 3.0)
            regs.append(_park(t, "2", world=3))
            for s in regs:
                P.TopologyReply.recv(s)
                s.close()
            n = len(calls)
            time.sleep(0.6)
            gaps = np.diff([c[0] for c in calls[:3]])
            return (quiet, calls[0][1:], bool((gaps >= 0.38).all()),
                    len(calls) == n)
        finally:
            _stop(t)
    assert _both(scenario) == ([], (["0", "1"], ["2"]), True, True)


def test_watchdog_is_quiet_on_empty_and_full_rounds():
    def scenario(pkg):
        calls = []
        t = _tracker(pkg, 2, watchdog_sec=0.2,
                     on_stall=lambda p, f: calls.append(p))
        try:
            time.sleep(0.5)
            socks = [_park(t, "0"), _park(t, "1")]
            for s in socks:
                P.TopologyReply.recv(s)
                s.close()
            time.sleep(0.5)
            return calls
        finally:
            _stop(t)
    assert _both(scenario) == []


def test_watchdog_survives_a_failing_callback():
    def scenario(pkg):
        calls = []

        def on_stall(present, finished):
            calls.append(sorted(present))
            raise RuntimeError("launcher bug")
        t = _tracker(pkg, 2, watchdog_sec=0.3, on_stall=on_stall)
        try:
            reg = _park(t, "0")
            assert _wait(lambda: len(calls) >= 2, 3.0)
            reg.close()
            return calls[:2]
        finally:
            _stop(t)
    assert _both(scenario) == [["0"], ["0"]]


# ------------------------------------------------- orphan GC and job scope
def _round(t, tasks, job, world):
    socks = [_park(t, task, job=job, world=world) for task in tasks]
    for s in socks:
        P.TopologyReply.recv(s)
        s.close()


def test_orphan_gc_collects_a_vanished_job_and_run_returns():
    """``tests/test_tenant.py``'s orphan case: a named job whose members'
    channels all end without a bye is collected, its timeline reads
    created then orphan_gc, and the tracker's run() returns."""
    def scenario(pkg):
        t = _tracker(pkg, 2, job_gc_sec=1.0)
        try:
            _round(t, ("s0", "s1"), "doomed", 2)
            job = t._job_get("doomed")
            hbs = []
            for task in ("s0", "s1"):
                hb = _hello(t, P.CMD_HEARTBEAT, task, job="doomed",
                            period_ms=50)
                P.send_u32(hb, 1)
                hbs.append(hb)
            time.sleep(0.3)
            for hb in hbs:
                hb.close()
            assert _wait(lambda: job.done, 15)
            t.join(30)
            return ([e["phase"] for e in job._events
                     if e["name"] == "job"],
                    not t._thread.is_alive())
        finally:
            _stop(t)
    assert _both(scenario) == (["created", "orphan_gc"], True)


def test_orphan_gc_without_heartbeats_needs_every_member_noted():
    """Without heartbeats only the supervisor's note_dead is evidence:
    one member noted keeps the job, both collect it.  A notice for a
    job the tracker does not know is ignored."""
    def scenario(pkg):
        t = _tracker(pkg, 2, job_gc_sec=0.5)
        try:
            _round(t, ("a", "b"), "j", 2)
            job = t._job_get("j")
            t.note_dead("a", job="j")
            t.note_dead("a", job="nope")
            time.sleep(1.5)
            one = job.done
            t.note_dead("b", job="j")
            assert _wait(lambda: job.done, 5)
            return one, sorted(job._lost_tasks)
        finally:
            _stop(t)
    assert _both(scenario) == (False, ["a", "b"])


def _peer(pkg, dead):
    return MODS[pkg]._HbPeer(None, "a", 0.1, 0.0, dead=dead)


@pytest.mark.parametrize("case", [
    "untouched", "recent", "idle-no-evidence", "lost-before-round",
    "hb-before-round", "members-accounted", "hb-gone-idle",
    "live-channel", "parked", "done"])
def test_orphaned_matches_reference(case):
    """``JobState.orphaned`` on the states it decides between."""
    def scenario(pkg):
        job = MODS[pkg].JobState(
            types.SimpleNamespace(_job_gc_sec=1.0), "j", 2)
        now = time.monotonic()
        job.touched = case != "untouched"
        job.last_activity = now - (0.5 if case == "recent" else 5.0)
        if case in ("members-accounted", "hb-gone-idle", "live-channel",
                    "parked", "done"):
            job._members = {"a", "b"}
        if case == "members-accounted":
            job._shutdown_tasks, job._lost_tasks = {"a"}, {"b"}
        if case in ("lost-before-round",):
            job._lost_tasks = {"a"}
        if case in ("hb-before-round", "hb-gone-idle", "live-channel"):
            job._hb_seen = {"a"}
        if case == "live-channel":
            job._hb_peers = {"a": _peer(pkg, False)}
        if case == "hb-gone-idle":
            job._hb_peers = {"a": _peer(pkg, True)}
        if case == "parked":
            job._lost_tasks = {"a", "b"}
            job._pending = [MODS[pkg]._Registrant(None, "a", "h", 1)]
        job.done = case == "done"
        return job.orphaned(now)
    got = _both(scenario)
    assert (got is None) == (case in ("untouched", "recent",
                                      "idle-no-evidence", "live-channel",
                                      "parked", "done"))


@pytest.mark.parametrize("kw,env,want", [
    ({}, {}, (3.0, 30.0)),
    ({}, {"RABIT_HEARTBEAT_MISS": "0.2", "RABIT_JOB_GC_SEC": "0.1"},
     (1.0, 0.5)),
    ({}, {"RABIT_HEARTBEAT_MISS": "x", "RABIT_JOB_GC_SEC": "y"},
     (3.0, 30.0)),
    ({}, {"RABIT_HEARTBEAT_MISS": "5", "RABIT_JOB_GC_SEC": "7"},
     (5.0, 7.0)),
    ({"heartbeat_miss": 2, "job_gc_sec": 4},
     {"RABIT_HEARTBEAT_MISS": "5"}, (2.0, 4.0)),
    ({"heartbeat_miss": 0, "job_gc_sec": 0}, {}, (1.0, 0.5))])
def test_liveness_knobs_match_reference(kw, env, want, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    for pkg in PKGS:
        t = MODS[pkg].Tracker(2, "127.0.0.1", 0, **kw)
        got[pkg] = (t._hb_miss, t._job_gc_sec)
        t.stop()
    assert got["torch"] == got["jax"] == want


def test_stop_logs_no_spurious_eof(capfd):
    """Channels that close after stop() are teardown, not deaths: the
    monitor stays quiet, and the port's run() returns."""
    for pkg in PKGS:
        t = _tracker(pkg, 1, heartbeat_miss=2.0)
        hb = _hello(t, P.CMD_HEARTBEAT, "0", world=1, period_ms=50)
        P.send_u32(hb, 1)
        assert _wait(lambda: _phases(t, "0") == [("alive",)])
        if pkg == "jax":            # its stop() leaves accept() blocked
            t._listener.shutdown(socket.SHUT_RDWR)
        t.stop()
        time.sleep(0.3)
        hb.close()
        time.sleep(0.3)
        t.join(WAIT_SEC)
        assert not t._thread.is_alive()
        assert _phases(t, "0") == [("alive",)], pkg
    assert "lost (EOF)" not in capfd.readouterr().err


# --------------------------------------------------------- mixed worlds
def _settle_after_bye(eng):
    """The tracker reads a bye on its monitor thread and the shutdown
    command on its accept thread, and the last rank's goodbye closes the
    job with its channels: a pause between the two lets every bye land
    on the timeline first."""
    stop = eng._stop_heartbeat

    def stop_heartbeat():
        stop()
        time.sleep(0.3)
    eng._stop_heartbeat = stop_heartbeat


def _hb_world(kinds, body, tracker, hang=None, on_dead_kill=False):
    """One pyrobust rank thread per entry of ``kinds`` with heartbeats
    at 0.1 s against one tracker with a miss budget of 3.  ``hang``
    (rank, version, seqno): that rank's first life hangs there (see
    ``_Hangable``) until the tracker's verdict kills it; its next life
    has the same trial.  Returns (records, lives, tracker events,
    on_dead calls)."""
    world = len(kinds)
    lives, recs, errs, dead = [0] * world, [{} for _ in kinds], [], []
    kill = {}

    def on_dead(task):
        dead.append(task)
        if on_dead_kill and task in kill:
            kill.pop(task).set()
    t = MODS[tracker].Tracker(world, "127.0.0.1", 0, heartbeat_miss=3.0,
                              on_dead=on_dead)
    t.start()
    hung = threading.Event()        # the marker: one hang in the job

    def run(i):
        while True:
            if hang is not None and hang[0] == i and not hung.is_set():
                kill[str(i)] = threading.Event()
                eng = _Hangable(hang[1:], kill[str(i)], hung)
            else:
                eng = ROBUST[kinds[i]]()
            lives[i] += 1
            _settle_after_bye(eng)
            try:
                eng.init({"rabit_tracker_uri": "127.0.0.1",
                          "rabit_tracker_port": t.port,
                          "rabit_task_id": str(i),
                          "rabit_world_size": world,
                          "rabit_heartbeat_sec": 0.1, "rabit_obs": 0})
                body(eng, kinds[i], 0, recs[i])
                eng.shutdown()
                return
            except _Killed:
                continue
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append((i, e))
                eng._close_links()
                return
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(world)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + JOIN_SEC
    for th in threads:
        th.join(max(deadline - time.monotonic(), 0.0))
    alive = [th for th in threads if th.is_alive()]
    job = t._default_job()
    events = [(e["task"], e["phase"]) for e in list(job._events)
              if e.get("name") == "liveness"]
    _stop(t)
    assert not alive, f"{len(alive)} rank thread(s) still running"
    assert not errs, errs
    return recs, lives, events, dead


@pytest.mark.parametrize("kinds,tracker", [
    (("torch",) * 3, "jax"), (("jax",) * 3, "torch"),
    (("torch", "jax", "torch"), "torch")],
    ids=["port-ranks-ref-tracker", "ref-ranks-port-tracker",
         "mixed-ranks-port-tracker"])
def test_mixed_worlds_beat_through_kmeans(per_thread, kinds, tracker):
    """k-means at world 3 with every rank beating: no verdict, and each
    rank's channel opens and closes with a bye on the timeline.  Every
    rank gets the same model, and against the all-reference world the
    stats' counts are exact and the float32 sums within the bar."""
    run = _app(per_thread, "kmeans")
    recs, lives, events, dead = _hb_world(kinds, run, tracker)
    assert lives == [1, 1, 1] and dead == []
    for task in ("0", "1", "2"):
        assert [p for tk, p in events if tk == task] == [
            "alive", "shutdown"], events
    assert len({r["model"] for r in recs}) == 1
    if "ref" not in _REF_WORLD:
        _REF_WORLD["ref"] = _hb_world(("jax",) * 3, run, "jax")[0]
    for got, want in zip(recs, _REF_WORLD["ref"]):
        assert sorted(k for k in got if k[0] == "ar") == sorted(
            k for k in want if k[0] == "ar")
        for key in (k for k in got if k[0] == "ar" and k[2]):
            g, w = (np.frombuffer(rec[key], np.float32).reshape(KM_K, -1)
                    for rec in (got, want))
            np.testing.assert_array_equal(g[:, -1], w[:, -1])
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(
            np.frombuffer(got["model"], np.float32),
            np.frombuffer(want["model"], np.float32), rtol=1e-4, atol=1e-3)


# -------------------------------------------------- a hung rank on threads
class _Gate:
    """The heartbeat socket of a rank that may hang: once ``frozen`` is
    set its sends block (the process is stopped), and a send after the
    kill fails as a dead process's would."""

    def __init__(self, sock, frozen, killed):
        self.sock, self.frozen, self.killed = sock, frozen, killed

    def sendall(self, data):
        while self.frozen.is_set() and not self.killed.is_set():
            time.sleep(0.01)
        if self.killed.is_set():
            raise OSError("the process is dead")
        self.sock.sendall(data)

    def close(self):
        self.sock.close()


class _Hangable(PyRobustEngine):
    """A port rank whose first life hangs at (version, seqno): its beats
    stop and its op blocks with every socket open, the shape of a
    SIGSTOP, until ``kill`` is set; then its links, listener and
    channel close with no goodbye and it raises, as a killed process
    ends."""

    def __init__(self, at, kill, hung):
        super().__init__()
        self._at, self._kill, self._hung = at, kill, hung
        self._frozen = threading.Event()
        self._gates = []

    def _hb_dial(self):
        gate = _Gate(super()._hb_dial(), self._frozen, self._kill)
        self._gates.append(gate)
        return gate

    def _verify(self, seqno):
        if (self._version, seqno) == tuple(self._at) \
                and not self._hung.is_set():
            self._hung.set()
            self._frozen.set()
            if not self._kill.wait(JOIN_SEC):
                raise AssertionError("no dead verdict for the hung rank")
            self._hb_stop.set()
            for gate in self._gates:
                gate.close()
            self._close_links()
            with self._aq_cv:
                self._aq.append(None)
                self._aq_cv.notify_all()
            raise _Killed(f"rank {self._rank} hung at v{self._version} "
                          f"seq {seqno}")
        super()._verify(seqno)


@pytest.mark.parametrize("which,hang", [
    # rank 1 hangs entering iteration 2's stats allreduce
    ("kmeans", (1, 1, 0)),
    # rank 0 hangs before round 2's third collective
    ("gbdt", (0, 1, 2))])
def test_hung_rank_is_declared_dead_and_replaced(per_thread, which, hang):
    """With the default 600 s link timeout only the heartbeat can free
    the survivors: the port's tracker declares the hung rank dead, the
    "kill" closes its sockets, the survivors recover on pyrobust with
    its next life, and the apps' results are the fault-free run's bit
    for bit."""
    run = _app(per_thread, which)
    clean = _hb_world(("torch",) * 3, run, "torch")[0]
    t0 = time.monotonic()
    recs, lives, events, dead = _hb_world(("torch",) * 3, run, "torch",
                                          hang=hang, on_dead_kill=True)
    assert time.monotonic() - t0 < 20
    rank = hang[0]
    assert lives == [2 if r == rank else 1 for r in range(3)]
    assert dead and set(dead) == {str(rank)}
    mine = [p for tk, p in events if tk == str(rank)]
    assert mine[:3] == ["alive", "dead", "relaunch"], events
    assert mine[-2:] == ["alive", "shutdown"], events
    for r in range(3):
        assert [p for tk, p in events if tk == str(r)].count("dead") == (
            r == rank)
        assert _results(recs[r]) == _results(clean[r]), r


# ------------------------------------------------------ the launcher's units
class _Proc:
    """A fake worker process: ``poll`` gives ``code``; ``kill`` records
    or raises."""

    def __init__(self, code=None, fail=False):
        self.code, self.fail, self.kills = code, fail, 0

    def poll(self):
        return self.code

    def kill(self):
        self.kills += 1
        if self.fail:
            raise ProcessLookupError("gone")


def test_watchdog_exit_matches_reference():
    for code in (-15, -9, -6, -2, -1, 0, 1, 2, 3, 124, 137, 143, 254, 255):
        assert port_launch.is_watchdog_exit(code) is \
            ref_launch.is_watchdog_exit(code), code


def _run_killer(mod, make, procs, ages, call):
    now = time.monotonic()
    live = {w: p for w, p in procs.items()}
    started = {w: now - age for w, age in ages.items()}
    marked = set()
    fn = make(mod, live, started, marked)
    try:
        fn(*call)
        err = None
    except Exception as e:  # noqa: BLE001 — compared below
        err = type(e).__name__
    return (sorted(w for w, p in procs.items() if p.kills), sorted(marked),
            err)


DEAD_CASES = [
    ("kills", 0.5, {1: {}}, {1: 10.0}, "1"),
    ("grace-default", 0.5, {1: {}}, {1: 1.5}, "1"),
    ("grace-3-periods", 1.0, {1: {}}, {1: 2.5}, "1"),
    ("past-grace", 0.5, {1: {}}, {1: 2.5}, "1"),
    ("already-dead", 0.5, {1: {"code": -9}}, {1: 10.0}, "1"),
    ("not-live", 0.5, {1: {}}, {1: 10.0}, "2"),
    ("not-a-worker-id", 0.5, {1: {}}, {1: 10.0}, "w1"),
    ("kill-fails", 0.5, {1: {"fail": True}}, {1: 10.0}, "1")]


@pytest.mark.parametrize("case,hb,procs,ages,task", DEAD_CASES,
                         ids=[c[0] for c in DEAD_CASES])
def test_dead_killer_matches_reference(case, hb, procs, ages, task):
    """``make_dead_killer`` on fake processes: which worker is killed
    and marked for a free restart, and whether a failing kill
    surfaces."""
    got = {}
    for name, mod in (("torch", port_launch), ("jax", ref_launch)):
        got[name] = _run_killer(
            mod, lambda m, live, started, marked: m.make_dead_killer(
                live, started, threading.Lock(), marked, hb,
                *(("t",) if m is ref_launch else ())),
            {w: _Proc(**kw) for w, kw in procs.items()}, ages, (task,))
    assert got["torch"] == got["jax"]
    killed = case in ("kills", "past-grace", "kill-fails")
    assert got["torch"][0] == ([1] if killed else [])
    assert got["torch"][2] == ("ProcessLookupError"
                               if case == "kill-fails" else None)


STALL_CASES = [
    ("at-most-one", {0: {}, 1: {}, 2: {}}, {}, {"0"}, set()),
    ("present-and-finished", {0: {}, 1: {}, 2: {}}, {}, {"0"}, {"1"}),
    ("fresh-life", {0: {}, 1: {}, 2: {}}, {1: 1.0}, {"0"}, set()),
    ("already-dead", {0: {}, 1: {"code": 0}, 2: {}}, {}, {"0"}, set()),
    ("not-live", {0: {}, 2: {}}, {}, {"0"}, set()),
    ("nobody-silent", {0: {}, 1: {}, 2: {}}, {}, {"0", "1"}, {"2"}),
    ("kill-fails", {0: {}, 1: {"fail": True}, 2: {}}, {}, {"0"}, set())]


@pytest.mark.parametrize("case,procs,ages,present,finished", STALL_CASES,
                         ids=[c[0] for c in STALL_CASES])
def test_stall_killer_matches_reference(case, procs, ages, present,
                                        finished):
    """``make_stall_killer`` (watchdog 2 s) on fake processes: at most
    one kill a stall, never a present, finished, dead or freshly started
    worker."""
    ages = {w: ages.get(w, 10.0) for w in procs}
    got = {}
    for name, mod in (("torch", port_launch), ("jax", ref_launch)):
        got[name] = _run_killer(
            mod, lambda m, live, started, marked: m.make_stall_killer(
                3, live, started, threading.Lock(), marked, 2.0,
                *(("t",) if m is ref_launch else ())),
            {w: _Proc(**kw) for w, kw in procs.items()}, ages,
            (present, finished))
    assert got["torch"] == got["jax"]
    want = {"at-most-one": [1], "present-and-finished": [2],
            "fresh-life": [2], "already-dead": [2], "not-live": [2],
            "nobody-silent": [], "kill-fails": [1]}[case]
    assert got["torch"][:2] == (want, want)


@pytest.mark.parametrize("policy", ["port", "reference"])
def test_a_relaunch_that_registers_late_is_killed_once(policy):
    """A hung worker is killed by the watchdog and relaunched at once;
    each life registers three periods after its start unless it was
    killed first.  The watchdog rearms every period while the round
    waits, so the reference's one-period grace kills every such life
    and the round never fills; the port's killer, told when the tracker
    last saw each task register, spares a life until it registers, and
    the round fills after one kill."""
    period = 0.3
    live, started, marked, lock = {}, {}, set(), threading.Lock()
    kills, regs, timers = [], [], []
    box = {}

    class Proc(_Proc):
        def __init__(self, wid):
            super().__init__()
            self.wid = wid

        def kill(self):
            super().kill()
            self.code = -9
            kills.append(self.wid)
            nxt = Proc(self.wid)   # the keepalive's relaunch
            with lock:
                live[self.wid] = nxt
                started[self.wid] = time.monotonic()

            def register():
                if nxt.code is None:   # a killed life never registers
                    regs.append(_park(box["t"], str(self.wid), world=3))
            timers.append(threading.Timer(3 * period, register))
            timers[-1].start()

    registered_at = ((lambda tid: box["t"].registered_at(tid))
                     if policy == "port" else None)
    on_stall = port_launch.make_stall_killer(
        3, live, started, lock, marked, period, registered_at=registered_at)
    t = box["t"] = _tracker("torch", 3, watchdog_sec=period,
                            on_stall=on_stall)
    try:
        for i in range(3):
            live[i], started[i] = Proc(i), time.monotonic() - 10.0
        socks = [_park(t, str(i), world=3) for i in range(3)]
        for sk in socks:
            P.TopologyReply.recv(sk)
            sk.close()
        # worker 1 hangs; 0 and 2 come back to the recover round
        socks = [_park(t, str(i), world=3, cmd=P.CMD_RECOVER)
                 for i in (0, 2)]
        filled = _wait(lambda: regs, 8 * period)
        for sk in socks + regs:
            if filled:
                P.TopologyReply.recv(sk)
            sk.close()
    finally:
        for tm in timers:
            tm.cancel()
            tm.join()
        _stop(t)
    if policy == "port":
        assert (filled, kills) == (True, [1])
    else:
        assert not filled and len(kills) >= 2 and set(kills) == {1}
