"""The port's pysocket engine against rabit_tpu's, on threads in one process.

Every world runs ``world`` engines on threads against an in-process
tracker on 127.0.0.1 port 0, as the JAX package's own transport tests
build ``PySocketEngine`` (``tests/test_transport.py``).  A port world and
a reference world run the same seeded inputs, and every allreduce must
give the same bits; mixed worlds put port and reference ranks in one
job.  A stub tracker, written with the port's ``protocol.py``, drives
registration through rejects, redirects and a late listener.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from rabit_tpu.engine.pysocket import PySocketEngine as JEngine
from rabit_tpu.ops import ReduceOp as JOp
from rabit_tpu.tracker.tracker import Tracker as JTracker
from rabit_tpu_torch import engine as engine_mod
from rabit_tpu_torch.engine.pysocket import (CHUNK_BYTES, AdmissionError,
                                             PySocketEngine, ShardMovedError,
                                             TrackerLostError)
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker
from torch_ref import ref_engine

JOIN_SEC = 60.0
SIZES = [0, 1, 2, 3, 5, 7, 13, 100, 1001, 4097]
OVER = 20000            # elements: over the 64 KiB crossover in every dtype
DTYPES = [np.int64, np.float32, np.float64]
OPS = ["SUM", "MAX", "MIN", "PROD"]
ENGINES = {"torch": PySocketEngine, "jax": ref_engine(JEngine)}
TRACKERS = {"torch": Tracker, "jax": JTracker}
OPCODES = {"torch": ReduceOp, "jax": JOp}

# Per-rank engine configs, cycled over the ranks of every parity world:
# the default pipeline, a deep window of small chunks, the serial hop
# loop, and a reduce buffer so small that every schedule chunks.  The
# wire is config-independent, so mixed configs must still agree.
CONFIGS = [{},
           {"rabit_pipeline_depth": 4, "rabit_pipeline_chunk": 256},
           {"rabit_pipeline_depth": 1},
           {"rabit_reduce_buffer": 1024, "rabit_pipeline_chunk": 64}]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Ranks pinned to task ids, so that a port world and a reference
    world hand every input to the same rank; the engines' log tag is
    restored afterwards."""
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    monkeypatch.setenv("RABIT_TPU_LOG_TAG", "")
    for var in ("RABIT_TRACKER_SHUFFLE", "RABIT_TRACKER_GROUPS",
                "RABIT_TIMEOUT_SEC", "RABIT_OBS", "RABIT_SCHED"):
        monkeypatch.delenv(var, raising=False)


def _run_world(kinds, body, params=None, tracker="torch"):
    """One engine per entry of ``kinds`` ("torch" or "jax"), each on a
    thread, against one in-process tracker; ``body(eng, kind)`` runs
    between init and shutdown.  Returns {rank: body's result}."""
    world = len(kinds)
    trk = TRACKERS[tracker](world, "127.0.0.1", 0)
    trk.start()
    out, errs = {}, []

    def run(i):
        eng = ENGINES[kinds[i]]()
        try:
            p = {"rabit_tracker_uri": "127.0.0.1",
                 "rabit_tracker_port": trk.port, "rabit_task_id": str(i),
                 "rabit_world_size": world, "rabit_timeout_sec": 30,
                 "rabit_obs": 0, **(params[i] if params else {})}
            eng.init(p)
            out[eng.rank] = body(eng, kinds[i])
            eng.shutdown()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append((i, e))
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


def _inputs(rank, size, dtype, op):
    rng = np.random.default_rng([rank, size, np.dtype(dtype).num,
                                 OPS.index(op)])
    if dtype == np.int64:
        hi = 3 if op == "PROD" else 1000
        return rng.integers(-hi, hi + 1, size).astype(np.int64)
    return rng.standard_normal(size).astype(dtype)


def _ladder(eng, kind):
    """Every size, dtype and op of the parity matrix; returns the
    results and the schedule each payload rode."""
    codes = OPCODES[kind]
    res, rode = {}, {}
    for size in SIZES + [OVER]:
        for dtype in DTYPES:
            for op in OPS:
                a = _inputs(eng.rank, size, dtype, op)
                eng.allreduce(a, getattr(codes, op))
                res[size, np.dtype(dtype).name, op] = a
                rode[size, np.dtype(dtype).name] = eng._op_sched
    return res, rode


@pytest.mark.parametrize("world", [2, 3, 4, 5])
@pytest.mark.parametrize("sched", ["tree", "ring", "halving", "static"])
def test_schedule_bit_parity(sched, world):
    """A forced schedule gives the reference's bits at every size, dtype
    and op, with mixed pipeline depths and reduce buffers in one world;
    integer sums are exact."""
    params = [dict(CONFIGS[r % len(CONFIGS)], rabit_sched=sched)
              for r in range(world)]
    got = _run_world(["torch"] * world, _ladder, params)
    want = _run_world(["jax"] * world, _ladder, params)
    for rank in range(world):
        res, rode = got[rank]
        assert rode == want[rank][1]
        for key, a in res.items():
            b = want[rank][0][key]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
            assert a.tobytes() == got[0][0][key].tobytes(), key
    for size in SIZES + [OVER]:
        exact = sum(_inputs(r, size, np.int64, "SUM") for r in range(world))
        np.testing.assert_array_equal(got[0][0][size, "int64", "SUM"], exact)
    if sched != "static":
        # the forced schedule applied wherever it could
        assert got[0][1][OVER, "float32"] == sched
    else:
        assert got[0][1][OVER, "float64"] == ("tree" if world == 2
                                              else "ring")
        assert got[0][1][1001, "float64"] == "tree"


def _collectives(eng, kind):
    """Broadcasts from every root at the chunk edges, an allgather and
    a chunked allreduce's scratch peak."""
    w = eng.world_size
    got = {}
    for root in range(w):
        for n in (0, 1, CHUNK_BYTES - 1, CHUNK_BYTES, CHUNK_BYTES + 1):
            data = bytes(np.random.default_rng([root, n]).integers(
                0, 256, n, dtype=np.uint8))
            got[root, n] = eng.broadcast(data if eng.rank == root else None,
                                         root)
    mine = np.arange(12, dtype=np.float32).reshape(3, 4) * (eng.rank + 1)
    got["gather"] = eng.allgather(mine)
    a = np.ones(100_000, np.float64)
    eng.allreduce(a, OPCODES[kind].SUM)
    got["sum"] = a
    got["peak"] = eng.scratch_peak_bytes
    return got


@pytest.mark.parametrize("world", [3, 4])
def test_broadcast_allgather_and_scratch_budget(world):
    """Any-root broadcast at 0, 1 and 256 KiB +- 1 bytes, allgather and
    the reduce-buffer contract (0 < scratch peak <= budget), port world
    against the expected values and the reference world."""
    budget = 4096
    params = [{"rabit_reduce_buffer": budget}] * world
    got = _run_world(["torch"] * world, _collectives, params)
    want = _run_world(["jax"] * world, _collectives, params)
    for rank in range(world):
        g = got[rank]
        for root in range(world):
            for n in (0, 1, CHUNK_BYTES - 1, CHUNK_BYTES, CHUNK_BYTES + 1):
                expect = bytes(np.random.default_rng([root, n]).integers(
                    0, 256, n, dtype=np.uint8))
                assert g[root, n] == expect == want[rank][root, n]
        gather = np.stack([np.arange(12, dtype=np.float32).reshape(3, 4)
                           * (r + 1) for r in range(world)])
        np.testing.assert_array_equal(g["gather"], gather)
        np.testing.assert_array_equal(g["sum"], np.full(100_000, world))
        assert 0 < g["peak"] <= budget
        assert 0 < want[rank]["peak"] <= budget


def _mixed_body(eng, kind):
    codes = OPCODES[kind]
    out = {}
    for size in (7, 4097, OVER):
        for op in ("SUM", "PROD"):
            a = _inputs(eng.rank, size, np.float64, op)
            eng.allreduce(a, getattr(codes, op))
            out[size, op] = a
    out["bcast"] = eng.broadcast(b"m" * 70000 if eng.rank == 2 else None, 2)
    out["gather"] = eng.allgather(np.array([eng.rank], np.int32))
    return out


@pytest.mark.parametrize("integrity", ["off", "crc32c"])
@pytest.mark.parametrize("tracker", ["torch", "jax"])
def test_mixed_world(tracker, integrity):
    """Port ranks 1 and 3 with reference ranks 0 and 2 in one world of 4
    complete under either tracker, plain and framed, with the bits of an
    all-reference world."""
    params = [{"rabit_wire_integrity": integrity}] * 4
    mixed = _run_world(["jax", "torch", "jax", "torch"], _mixed_body,
                       params, tracker=tracker)
    ref = _run_world(["jax"] * 4, _mixed_body, params, tracker="jax")
    for rank in range(4):
        for key, a in ref[rank].items():
            b = mixed[rank][key]
            if isinstance(a, np.ndarray):
                assert a.tobytes() == b.tobytes(), (rank, key)
            else:
                assert a == b, (rank, key)


# ------------------------------------------------------------ registration
class _StubTracker:
    """A tracker that answers registrations with scripted replies written
    by the port's ``protocol.py``: each entry of ``replies`` is a
    RejectReply or TopologyReply (sent to the next start/recover), and a
    shutdown is accepted and closed."""

    def __init__(self, replies, port=0):
        self.replies = list(replies)
        self.hellos = []
        self.lst = socket.socket()
        self.lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lst.bind(("127.0.0.1", port))
        self.lst.listen(16)
        self.port = self.lst.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                sock, _ = self.lst.accept()
            except OSError:
                return
            with sock:
                sock.settimeout(10)
                job, cmd, task, world = P.recv_hello(sock)
                self.hellos.append(cmd)
                if cmd in (P.CMD_START, P.CMD_RECOVER):
                    P.recv_str(sock)
                    P.recv_u32(sock)
                    self.replies.pop(0).send(sock)

    def wait_hellos(self, n):
        """The first ``n`` commands received (bounded wait)."""
        deadline = time.monotonic() + 10
        while len(self.hellos) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        return self.hellos[:n]

    def close(self):
        try:
            self.lst.shutdown(socket.SHUT_RDWR)   # wakes accept()
        except OSError:
            pass
        self.lst.close()
        self.thread.join(5)
        assert not self.thread.is_alive()


def _solo_topology():
    return P.TopologyReply(rank=0, world=1, parent=P.NONE, ring_prev=0,
                           ring_next=0)


def _stub_params(port, **kw):
    return {"rabit_tracker_uri": "127.0.0.1", "rabit_tracker_port": port,
            "rabit_task_id": "0", "rabit_timeout_sec": 5,
            "rabit_backoff_base_ms": 1, "rabit_obs": 0, **kw}


def test_bad_handshake_reject_raises_at_once():
    stub = _StubTracker([P.RejectReply(P.REJECT_BAD_HANDSHAKE, "garbage")])
    try:
        with pytest.raises(AdmissionError, match="garbage") as err:
            PySocketEngine().init(_stub_params(stub.port,
                                               rabit_admission_retries=5))
        assert err.value.code == P.REJECT_BAD_HANDSHAKE
        assert stub.hellos == [P.CMD_START]
    finally:
        stub.close()


def test_capacity_reject_then_topology_succeeds():
    stub = _StubTracker([P.RejectReply(P.REJECT_MAX_JOBS, "full"),
                         P.RejectReply(P.REJECT_MAX_WORKERS, "full"),
                         _solo_topology()])
    eng = PySocketEngine()
    try:
        eng.init(_stub_params(stub.port))
        assert (eng.rank, eng.world_size) == (0, 1)
        a = np.arange(5, dtype=np.float32)
        assert eng.allreduce(a, ReduceOp.SUM) is a
        eng.shutdown()
        assert stub.wait_hellos(4) == [P.CMD_START] * 3 + [P.CMD_SHUTDOWN]
    finally:
        stub.close()


def test_capacity_rejects_exhaust_the_admission_budget():
    stub = _StubTracker([P.RejectReply(P.REJECT_MAX_JOBS, "full")] * 3)
    try:
        with pytest.raises(AdmissionError, match="3 time"):
            PySocketEngine().init(_stub_params(stub.port,
                                               rabit_admission_retries=2))
    finally:
        stub.close()


def test_shard_moved_retargets_the_tracker():
    owner = _StubTracker([_solo_topology()])
    first = _StubTracker([P.RejectReply(
        P.REJECT_SHARD_MOVED,
        P.shard_moved_reason(3, 1, "127.0.0.1", owner.port))] * 2)
    eng = PySocketEngine()
    try:
        eng.init(_stub_params(first.port))
        assert eng._tracker_addr == ("127.0.0.1", owner.port)
        eng.shutdown()
        assert owner.wait_hellos(2) == [P.CMD_START, P.CMD_SHUTDOWN]
        with pytest.raises(ShardMovedError) as err:
            PySocketEngine().init(_stub_params(first.port,
                                               rabit_shard_retries=0))
        assert (err.value.generation, err.value.shard) == (3, 1)
    finally:
        owner.close()
        first.close()


def test_late_tracker_is_reached_through_the_connect_retries():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    result = {}
    eng = PySocketEngine()

    def run():
        try:
            eng.init(_stub_params(port, rabit_connect_retries=40,
                                  rabit_backoff_base_ms=20))
            result["world"] = eng.world_size
        except Exception as e:  # noqa: BLE001 — asserted below
            result["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.3)
    stub = _StubTracker([_solo_topology()], port=port)
    try:
        t.join(JOIN_SEC)
        assert not t.is_alive()
        assert result == {"world": 1}
        eng.shutdown()
    finally:
        stub.close()


def test_no_tracker_raises_tracker_lost():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(TrackerLostError):
        PySocketEngine().init(_stub_params(port, rabit_connect_retries=1))


class _StrayEngine(PySocketEngine):
    """Rank 0 opens stray clients on its own link listener before it
    registers, so they sit in the accept queue ahead of every peer: an
    HTTP request, a worker's tracker hello, a client that closes at
    once, and link hellos naming rank 0 itself and a rank past the
    world."""

    strays: list = []

    def _register(self, cmd, my_host, my_port):
        if self._task_id == "0":
            for send in (
                    lambda s: s.sendall(b"GET /directory HTTP/1.1\r\n\r\n"),
                    lambda s: P.send_hello(s, P.CMD_START, "w0", 3),
                    lambda s: s.close(),
                    lambda s: s.sendall(struct.pack("<II", P.MAGIC, 0)),
                    lambda s: s.sendall(struct.pack("<III", 0x7AB17912, 99,
                                                    0))):
                s = socket.create_connection(("127.0.0.1", my_port))
                send(s)
                self.strays.append(s)
        return super()._register(cmd, my_host, my_port)


def _sums(eng, kind):
    out = []
    for size in (7, OVER):
        a = _inputs(eng.rank, size, np.int64, "SUM")
        eng.allreduce(a, OPCODES[kind].SUM)
        out.append(a)
    return sorted(eng._links), out


def test_stray_connections_on_the_link_listener_are_dropped(monkeypatch):
    """A client that is not a peer of this world — another process
    dialing an ephemeral port it once knew — reaches a rank's link
    listener before the peers do: the rank drops it and wires its real
    links, and the world's sums are exact."""
    monkeypatch.setitem(ENGINES, "torch", _StrayEngine)
    monkeypatch.setattr(_StrayEngine, "strays", [])
    try:
        got = _run_world(["torch"] * 3, _sums)
    finally:
        for s in _StrayEngine.strays:
            s.close()
    assert len(_StrayEngine.strays) == 5
    for rank in range(3):
        links, sums = got[rank]
        assert links == [r for r in range(3) if r != rank]
        for size, a in zip((7, OVER), sums):
            np.testing.assert_array_equal(
                a, sum(_inputs(r, size, np.int64, "SUM") for r in range(3)))


def test_live_schedule_directive_is_refused():
    topo = _solo_topology()
    topo.sched = "65536:ring"
    stub = _StubTracker([topo])
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            PySocketEngine().init(_stub_params(stub.port))
    finally:
        stub.close()


# ------------------------------------------------------ refusals and state
@pytest.mark.parametrize("key,value,item", [
    ("rabit_sched", "auto", "A8"), ("rabit_sched", "swing", "A8"),
    ("rabit_sched", "synth", "A8"),
    ("rabit_tune_dir", "/nonexistent", "A8"),
    ("rabit_synth_plan", "plan.json", "A8"),
    ("rabit_wire_codec", "int8", "A8"), ("rabit_wire_dtype", "bf16", "A8"),
    ("rabit_codec_block", "64", "A8"), ("rabit_codec_impl", "numpy", "A8"),
    ("rabit_codec_min_bytes", "4096", "A8"),
    ("rabit_chaos", "reset@io:1", "A8"),
    ("rabit_obs", "1", "A8"), ("rabit_obs_dir", "obs", "A8"),
    ("rabit_trace_sample", "4", "A8"), ("rabit_trace_dir", "trace", "A8"),
    ("rabit_directory", "127.0.0.1:1", "A8"),
    ("rabit_link_mbps", "100", "A8"),
])
def test_unported_knobs_raise(key, value, item):
    """Each knob outside the slice, set to anything but its off value,
    raises before any connection is tried (the tracker port is closed)."""
    params = _stub_params(1, **{key: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        PySocketEngine().init(params)


def test_off_values_are_accepted_and_bad_values_checked():
    eng = PySocketEngine()
    off = dict(rabit_obs="0", rabit_heartbeat_sec="0", rabit_link_mbps=0,
               rabit_wire_codec="none", rabit_wire_dtype="native",
               rabit_trace_sample=0, rabit_sched="halving",
               rabit_connect_retries=0)
    with pytest.raises(TrackerLostError):      # got as far as dialing
        eng.init(_stub_params(1, **off))
    # the shm transport's knobs are served (A8b)
    served = dict(rabit_transport="shm", rabit_shm_ring_bytes="64KB",
                  rabit_transport_failover="off", rabit_shm_retries=0,
                  rabit_shm_dir="/nonexistent", rabit_connect_retries=0)
    eng = PySocketEngine()
    with pytest.raises(TrackerLostError):
        eng.init(_stub_params(1, **served))
    cfg = eng._lf.cfg
    assert (cfg.transport, cfg.shm_ring_bytes, cfg.failover,
            cfg.shm_retries, cfg.shm_dir) == ("shm", 65536, False, 0,
                                              "/nonexistent")
    from rabit_tpu_torch.utils import RabitError

    for bad in (dict(rabit_sched="bogus"), dict(rabit_pipeline_depth=65),
                dict(rabit_pipeline_depth=0), dict(rabit_wire_dtype="fp8"),
                dict(rabit_connect_retries=-1),
                dict(rabit_job_id="../etc"), dict(rabit_transport="rdma"),
                dict(rabit_shm_ring_bytes="1KB"),
                dict(rabit_shm_retries=-1)):
        with pytest.raises(RabitError):
            PySocketEngine().init(_stub_params(1, **bad))


def test_tensor_payloads_raise_before_any_byte_moves():
    eng = PySocketEngine()
    for call in (lambda: eng.allreduce(torch.zeros(4), ReduceOp.SUM),
                 lambda: eng.allgather(torch.zeros(4))):
        with pytest.raises(TypeError, match="torch.Tensor"):
            call()


def _state(eng, kind):
    assert eng.load_checkpoint() == (0, None, None)
    eng.checkpoint(b"g1")
    eng.checkpoint(b"g2", b"l2")
    return (eng.version_number, eng.load_checkpoint(), eng.epoch,
            eng.was_relaunched)


def test_checkpoint_state_matches_reference():
    got = _run_world(["torch"] * 2, _state)
    want = _run_world(["jax"] * 2, _state)
    assert got == want
    assert got[0] == (2, (2, b"g2", b"l2"), 0, False)


def test_make_engine_builds_pysocket_and_autodetect_still_raises(monkeypatch):
    """``pysocket`` is built by name; a tracker URI with no engine name
    picks ``pyrobust`` (the name is kept from when the port refused
    there), and no tracker picks ``empty``."""
    from rabit_tpu_torch.engine.robust import PyRobustEngine

    assert type(engine_mod._make_engine("pysocket")) is PySocketEngine
    assert type(engine_mod._make_engine("pyrobust")) is PyRobustEngine
    monkeypatch.delenv("RABIT_TRACKER_URI", raising=False)
    assert engine_mod._autodetect({}) == "empty"
    assert engine_mod._autodetect({"rabit_tracker_uri": "h"}) == "pyrobust"
    monkeypatch.setenv("RABIT_TRACKER_URI", "127.0.0.1")
    assert engine_mod._autodetect({}) == "pyrobust"


@pytest.mark.parametrize("raw", ["256MB", "64KB", "1.5M", " 2 g ", "7b", 4096,
                                 1e3, "0", "-1", "12XB", "", "inf",
                                 float("nan"), "9e20"])
def test_parse_byte_size_matches_reference(raw):
    from rabit_tpu.utils.units import parse_byte_size as want
    from rabit_tpu_torch.utils.units import parse_byte_size as got

    try:
        expect = want(raw)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            got(raw)
        assert str(err.value) == str(e)
    else:
        assert got(raw) == expect


def test_routable_ip_keeps_loopback():
    from rabit_tpu.utils.net import routable_ip as want
    from rabit_tpu_torch.utils.net import routable_ip as got

    for host in ("127.0.0.1", "localhost"):
        assert got((host, 9091)) == want((host, 9091)) == "127.0.0.1"
