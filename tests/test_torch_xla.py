"""The port's device-plane engine (``rabit_engine="xla"``) on the CPU.

World 1 without a tracker is the identity the reference's
``tests/test_xla_engine.py`` pins.  Worlds of 2 and 3 run their ranks
on threads of this process against the port's in-process tracker on
127.0.0.1 port 0, each rank an ``XLAEngine`` over the ``pyrobust`` host
engine whose device plane is a gloo group of its own: tensors reduce on
the group and must match the numpy reduction of the same inputs, exact
for integers and within the float32 bar for floats.  The backend rule,
the runtime-failure filter and the refusals are checked as functions.
``run_world`` and ``die`` are the thread harness that
``tests/test_torch_xla_faults.py`` also uses.
"""
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import rabit_tpu_torch
from rabit_tpu_torch import engine as engine_mod
from rabit_tpu_torch.engine import xla
from rabit_tpu_torch.engine.xla import XLAEngine
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.tracker.tracker import Tracker

JOIN_SEC = 60.0
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Ranks pinned to task ids; nothing of the caller's environment
    reaches the engines."""
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    for var in ("RABIT_TRACKER_SHUFFLE", "RABIT_TRACKER_GROUPS",
                "RABIT_TIMEOUT_SEC", "RABIT_MOCK", "RABIT_NUM_TRIAL",
                "RABIT_RELAUNCH", "RABIT_DEVICE_REFORM",
                "RABIT_XLA_DIE_FORMATION", "RABIT_FORM_TIMEOUT_SEC",
                "RABIT_DEVICE_IMPL", "RABIT_TRACKER_URI",
                "RABIT_TRACKER_PORT", "RABIT_TASK_ID", "RABIT_OBS",
                "RABIT_HEARTBEAT_SEC", "RABIT_CKPT_DIR"):
        monkeypatch.delenv(var, raising=False)


# ------------------------------------------------------------ the harness
class Killed(Exception):
    """A rank's death, inside this process."""


def die(eng):
    """What a process death leaves its peers: the device group aborted
    (its gloo pairs close), the host links and the listener closed with
    no goodbye, the async pump told to stop."""
    eng._drop_group()
    inner = eng._inner
    inner._close_links()
    with inner._aq_cv:
        inner._aq.append(None)
        inner._aq_cv.notify_all()
    raise Killed(f"rank {eng.rank}")


class ThreadXLA(XLAEngine):
    """The engine, whose formation-window death hook kills the thread's
    rank instead of the process."""

    def _die_in_formation(self):
        die(self)


def run_world(world, body, params=None, tracker_kw=None, engine=None):
    """One rank thread per rank against one in-process tracker.  Each
    life of rank i builds a fresh engine (``rabit_num_trial`` one higher
    after a death, as the keepalive launcher relaunches a process) and
    runs ``body(eng, trial, rec)`` between init and shutdown; ``rec`` is
    the rank's record, kept across its lives.  Returns (records, lives)
    by rank.  ``engine`` is the engine class (default: the device-plane
    engine)."""
    trk = Tracker(world, "127.0.0.1", 0, **(tracker_kw or {}))
    trk.start()
    recs = [{} for _ in range(world)]
    lives = [0] * world
    errs = []

    def run(i):
        trial = 0
        while True:
            eng = (engine or ThreadXLA)()
            lives[i] += 1
            p = {"rabit_tracker_uri": "127.0.0.1",
                 "rabit_tracker_port": trk.port, "rabit_task_id": str(i),
                 "rabit_world_size": world, "rabit_timeout_sec": 20,
                 "rabit_num_trial": trial, **(params or {})}
            try:
                eng.init(p)
                body(eng, trial, recs[i])
                eng.shutdown()
                return
            except Killed:
                trial += 1
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append((i, trial, e))
                if isinstance(eng, XLAEngine):
                    eng._drop_group()
                    inner_eng = eng._inner
                else:
                    inner_eng = eng
                if inner_eng is not None and hasattr(inner_eng,
                                                     "_close_links"):
                    inner_eng._close_links()   # let the peers fail
                return
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
    return recs, lives


class PerThread:
    """Stands in for the engine module's singleton, so that the apps'
    api calls on each rank thread reach that thread's engine; its
    ``__class__`` is the engine's, so ``is_device_plane()`` sees it."""

    def __init__(self):
        self._tl = threading.local()

    def set(self, eng):
        self._tl.eng = eng

    @property
    def __class__(self):
        return type(self._tl.eng)

    def __getattr__(self, name):
        return getattr(self._tl.eng, name)


@pytest.fixture
def per_thread(monkeypatch):
    proxy = PerThread()
    monkeypatch.setattr(engine_mod, "_engine", proxy)
    return proxy


# ------------------------------------------------------------------ world 1
@pytest.fixture
def xla_world1():
    if rabit_tpu_torch.initialized():
        rabit_tpu_torch.finalize()
    rabit_tpu_torch.init(rabit_engine="xla")
    yield
    rabit_tpu_torch.finalize()


def test_world1_identity(xla_world1):
    assert rabit_tpu_torch.get_world_size() == 1
    assert rabit_tpu_torch.get_rank() == 0
    assert not engine_mod.is_device_plane()
    x = torch.arange(8, dtype=torch.float32)
    out = rabit_tpu_torch.allreduce(x, rabit_tpu_torch.SUM)
    np.testing.assert_array_equal(out.numpy(), np.arange(8, dtype=np.float32))
    a = np.ones(4)
    assert rabit_tpu_torch.allreduce(a, rabit_tpu_torch.MAX) is a
    g = rabit_tpu_torch.allgather(torch.tensor([3, 4]))
    assert g.tolist() == [[3, 4]]


def test_world1_prepare_fun_called(xla_world1):
    called = []
    x = torch.zeros(3)
    rabit_tpu_torch.allreduce(x, rabit_tpu_torch.SUM,
                              prepare_fun=lambda: called.append(1))
    assert called == [1]


def test_world1_checkpoint_roundtrip(xla_world1):
    version, model = rabit_tpu_torch.load_checkpoint()
    assert version == 0 and model is None
    rabit_tpu_torch.checkpoint({"w": [1, 2, 3]})
    version, model = rabit_tpu_torch.load_checkpoint()
    assert version == 1 and model == {"w": [1, 2, 3]}
    assert rabit_tpu_torch.device_epoch() == 0


def test_world1_broadcast(xla_world1):
    assert rabit_tpu_torch.broadcast({"k": 7}, 0) == {"k": 7}


# ------------------------------------------------------------ worlds 2 and 3
DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.int32,
          torch.int64, torch.uint8]


def _inputs(rank, dtype):
    """Rank ``rank``'s input: small integers, so every reduction of the
    float dtypes is exact too, bfloat16 included."""
    rng = np.random.default_rng([11, rank])
    hi = 4 if dtype in (torch.uint8, torch.bfloat16) else 50
    vals = rng.integers(1, hi, (3, 7))
    return torch.from_numpy(vals).to(dtype)


def _numpy_reduce(op, parts):
    fn = {ReduceOp.MAX: np.maximum, ReduceOp.MIN: np.minimum,
          ReduceOp.SUM: np.add, ReduceOp.PROD: np.multiply,
          ReduceOp.BITOR: np.bitwise_or, ReduceOp.BITAND: np.bitwise_and,
          ReduceOp.BITXOR: np.bitwise_xor}[op]
    acc = parts[0].copy()
    for p in parts[1:]:
        acc = fn(acc, p)
    return acc


@pytest.mark.parametrize("world", [2, 3])
def test_device_collectives_match_numpy(world):
    """Every op on every dtype it applies to, then allgather, on the
    device plane: equal to numpy's reduction of the same inputs, the
    inputs left as they were, every op counted on the device path."""
    cases = [(op, dt) for op in ReduceOp for dt in DTYPES
             if not (op in xla._BITWISE and dt.is_floating_point)]

    def body(eng, trial, rec):
        assert engine_mod.is_device_plane() is False  # no global engine
        assert eng.backend == "gloo" and eng.group is not None
        for op, dt in cases:
            x = _inputs(eng.rank, dt)
            before = x.clone()
            out = eng.allreduce(x, op)
            assert torch.equal(x, before)
            rec[(op, dt)] = out.to(torch.float64).numpy()
            assert out.dtype == dt and out.device == x.device
        for dt in DTYPES:
            g = eng.allgather(_inputs(eng.rank, dt))
            rec[("gather", dt)] = g.to(torch.float64).numpy()
        a = np.arange(5, dtype=np.float64) + eng.rank
        eng.allreduce(a, ReduceOp.SUM)        # numpy: the host engine
        rec["host"] = a
        rec["stats"] = dict(eng.path_stats)

    recs, lives = run_world(world, body)
    assert lives == [1] * world
    parts = {dt: [_inputs(r, dt).to(torch.float64).numpy()
                  for r in range(world)] for dt in DTYPES}
    for r in range(world):
        for op, dt in cases:
            want = _numpy_reduce(op, [
                _inputs(q, dt).to(torch.float64 if dt.is_floating_point
                                  else dt).numpy() for q in range(world)])
            got = recs[r][(op, dt)]
            if dt.is_floating_point:
                np.testing.assert_allclose(got, want.astype(np.float64),
                                           **F32_TOL)
            else:
                np.testing.assert_array_equal(got, want.astype(np.float64))
        for dt in DTYPES:
            np.testing.assert_array_equal(recs[r][("gather", dt)],
                                          np.stack(parts[dt]))
        np.testing.assert_array_equal(
            recs[r]["host"], world * np.arange(5.0) + world * (world - 1) / 2)
        assert recs[r]["stats"] == {"device_ops": len(cases) + len(DTYPES),
                                    "host_ops": 0, "backend": "gloo"}


def test_is_device_plane_and_api_at_world3(per_thread):
    """Through the api: ``init(rabit_engine="xla")`` engines at world 3
    report the device plane, tensors come back reduced on their device
    and a numpy payload stays in place on the host engine."""
    def body(eng, trial, rec):
        per_thread.set(eng)
        rec["plane"] = engine_mod.is_device_plane()
        out = rabit_tpu_torch.allreduce(torch.full((4,), eng.rank + 1.0))
        rec["sum"] = out.tolist()
        h = np.array([eng.rank], np.int64)
        rabit_tpu_torch.allreduce(h, rabit_tpu_torch.MAX)
        rec["max"] = int(h[0])
        rec["stats"] = dict(eng.path_stats)

    recs, _ = run_world(3, body)
    for rec in recs:
        assert rec["plane"] is True
        assert rec["sum"] == [6.0] * 4 and rec["max"] == 2
        assert rec["stats"] == {"device_ops": 1, "host_ops": 0,
                                "backend": "gloo"}


# --------------------------------------------------------- the backend rule
@pytest.mark.parametrize("devices,want", [
    (["cpu"], "gloo"),
    (["cpu", "cpu", "cpu"], "gloo"),
    (["cuda:a", "cuda:b", "cuda:c"], "nccl"),
    (["cuda:a"], "nccl"),
    (["cuda:a", "cuda:a", "cuda:a"], "gloo"),
    (["cuda:a", "cuda:b", "cuda:a"], "gloo"),
    (["cuda:a", "cpu"], "gloo")])
def test_backend_rule(devices, want):
    assert xla.backend_for(devices) == want


def test_device_identity():
    ident = xla.device_identity()
    if torch.cuda.is_available():
        assert ident.startswith("cuda:")
    else:
        assert ident == "cpu"


# ----------------------------------------------------- the failure filter
@pytest.mark.parametrize("exc,runtime", [
    (dist.DistStoreError("wait timeout after 3000ms"), True),
    (dist.DistNetworkError("connection lost"), True),
    (OSError("reset"), True),
    (RuntimeError("[pair.cc:553] Connection closed by peer [::1]:1"), True),
    (RuntimeError("Timed out waiting 1000ms for recv operation"), True),
    (RuntimeError("Cannot use ReduceOp.BOR with non-integral dtype"), False),
    (TypeError("shape bug"), False),
    (ValueError("connection closed"), False)])
def test_runtime_failure_filter(exc, runtime):
    assert xla._is_runtime_failure(exc) is runtime


def test_programming_error_raises_and_peer_failure_degrades():
    """A reduction the dtype lacks raises before any byte moves and
    leaves the engine on the device plane; a dropped peer makes the
    next device op degrade to the host engine, which still gives every
    live rank the right sum as a tensor."""
    ready = threading.Barrier(3)

    def body(eng, trial, rec):
        with pytest.raises(TypeError, match="integer"):
            eng.allreduce(torch.ones(3), ReduceOp.BITOR)
        with pytest.raises(TypeError, match="dtype"):
            eng.allreduce(torch.ones(3, dtype=torch.complex64),
                          ReduceOp.SUM)
        assert not eng._degraded
        rec["first"] = eng.allreduce(torch.ones(2), ReduceOp.SUM).tolist()
        if eng.rank == 0:
            # a transport failure injected into rank 0's device op only:
            # its degrade aborts its group, which fails the others' op
            def broken(*a, **k):
                raise RuntimeError("[pair.cc:553] Connection closed by "
                                   "peer [127.0.0.1]:1")
            eng._device_collective = broken
        ready.wait(JOIN_SEC)
        out = eng.allreduce(torch.full((2,), eng.rank + 1.0), ReduceOp.SUM)
        rec["second"] = (out.tolist(), out.device.type, eng._degraded,
                         dict(eng.path_stats))

    recs, _ = run_world(3, body)
    for r, rec in enumerate(recs):
        assert rec["first"] == [3.0, 3.0]
        out, dev, degraded, stats = rec["second"]
        assert out == [6.0, 6.0] and dev == "cpu" and degraded
        assert stats["host_ops"] == 1 and stats["device_ops"] == 1, r


# ----------------------------------------------------------- refusals
def test_pallas_ring_is_refused():
    with pytest.raises(NotImplementedError, match="A7"):
        XLAEngine().init({"rabit_device_impl": "pallas_ring"})
    with pytest.raises(Exception, match="rabit_device_impl"):
        XLAEngine().init({"rabit_device_impl": "warp"})
    with pytest.raises(Exception, match="rabit_pallas_min_bytes"):
        XLAEngine().init({"rabit_pallas_min_bytes": "lots"})


def test_native_inner_is_refused():
    trk = Tracker(1, "127.0.0.1", 0)
    trk.start()
    try:
        for name in ("native", "mock"):
            with pytest.raises(NotImplementedError, match="A8"):
                XLAEngine().init({"rabit_tracker_uri": "127.0.0.1",
                                  "rabit_tracker_port": trk.port,
                                  "rabit_inner_engine": name})
        with pytest.raises(ValueError, match="cannot back"):
            XLAEngine().init({"rabit_tracker_uri": "127.0.0.1",
                              "rabit_tracker_port": trk.port,
                              "rabit_inner_engine": "xla"})
    finally:
        trk.stop()


def test_mpi_and_telemetry_are_refused():
    with pytest.raises(NotImplementedError, match="A8"):
        XLAEngine().init({"rabit_jax_cpu_collectives": "mpi"})
    XLAEngine().init({"rabit_jax_cpu_collectives": "gloo"})
    for key, val in (("rabit_obs", "1"), ("rabit_trace_dir", "/x"),
                     ("rabit_obs_dir", "/x")):
        with pytest.raises(NotImplementedError, match="A8"):
            XLAEngine().init({key: val})
    XLAEngine().init({"rabit_obs": "0"})


def test_pysocket_names_the_device_plane_engine():
    from rabit_tpu_torch.engine.pysocket import PySocketEngine

    with pytest.raises(TypeError, match='rabit_engine="xla"'):
        PySocketEngine._host_only(torch.ones(1), "allreduce")


def test_reference_tracker_store_differs_on_purpose():
    """The reference tracker answers ``jaxsvc`` with the same u32, but
    the port names a JAX coordination service there, not a
    ``TCPStore``: a port engine's store client fails on it with a
    runtime failure, so under a reference tracker the port's device
    plane never forms and every tensor rides the host plane, degraded
    (ROADMAP §C)."""
    import datetime
    import socket

    from rabit_tpu.tracker import protocol as JP
    from rabit_tpu.tracker.tracker import Tracker as JTracker

    trk = JTracker(1, "127.0.0.1", 0)
    trk.start()
    try:
        sock = socket.create_connection(("127.0.0.1", trk.port), timeout=30)
        JP.send_hello(sock, "jaxsvc", "init", 1)
        port = JP.recv_u32(sock)
        sock.close()
        assert port
        with pytest.raises(dist.DistError) as err:
            dist.TCPStore("127.0.0.1", port, None, False,
                          datetime.timedelta(seconds=2),
                          wait_for_workers=False)
        assert xla._is_runtime_failure(err.value)
    finally:
        trk._listener.shutdown(socket.SHUT_RDWR)
        trk.stop()
        trk.join(30)
