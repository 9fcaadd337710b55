"""The device-plane engine's adopt and mixed modes on the CPU.

A ``torch.distributed`` default group is one a process, so each world
is three launched processes that call ``init_process_group("gloo")``
themselves, as ``torchrun`` leaves them; this file, run as a script, is
the rank worker (below, under ``if __name__ == "__main__":``).  The
reference's cases (``tests/test_xla_engine.py``, its workers
``tests/workers/adopt_worker.py`` and ``mixed_worker.py``):

* adopt: no tracker; rank and world adopted from the group; numpy
  allreduce in place, allgather, and byte and object broadcasts all on
  the group; then, engine initialised again, rank 1 dies and both
  survivors' next collective raises ``RuntimeError`` (no host
  transport) -- one launch;
* mixed: the port's tracker with ``RABIT_TRACKER_PIN_RANKS=1`` and the
  workers' own group: aligned (tensors on the group, numpy and
  checkpoints on the host engine), task ids reversed (every rank
  degrades by consensus) and a relaunch (adopted, degraded for good).

One in-process case holds that a world mismatch every rank can see
degrades without a collective.
"""
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import rabit_tpu_torch  # noqa: E402
from rabit_tpu_torch import engine as engine_mod  # noqa: E402

WORLD = 3
PROC_SEC = 120          # each rank process's time limit
GROUP_SEC = 30          # the workers' group timeout
RAISE_SEC = 20.0        # a survivor's death -> RuntimeError bar


# ---------------------------------------------------------------- worker
def _init_group(rank, port):
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=GROUP_SEC))


def _collectives(rank, world, rec, device_plane):
    """numpy in place, a tensor MAX, allgather, byte and object
    broadcasts from roots other than 0, async resolves."""
    eng = engine_mod.get_engine()
    a = np.arange(8, dtype=np.float32) + rank
    out = rabit_tpu_torch.allreduce(a, rabit_tpu_torch.SUM)
    np.testing.assert_array_equal(
        a, np.arange(8, dtype=np.float32) * world + sum(range(world)))
    assert out is a, "numpy allreduce must fill the caller's buffer"
    b = np.array([rank, -rank], np.int64)
    rabit_tpu_torch.allreduce(b, rabit_tpu_torch.MAX)
    assert b.tolist() == [world - 1, 0]
    before = dict(eng.path_stats)
    x = torch.full((16,), float(rank + 1))
    got = rabit_tpu_torch.allreduce(x, rabit_tpu_torch.MAX)
    assert torch.equal(got, torch.full((16,), float(world)))
    if device_plane:
        assert eng.path_stats["device_ops"] > before["device_ops"]
        assert eng.path_stats["host_ops"] == 0
    else:
        assert eng.path_stats["device_ops"] == 0
        assert eng.path_stats["host_ops"] > before["host_ops"]
    rows = rabit_tpu_torch.allgather(np.full(3, rank, np.int32))
    assert rows.tolist() == [[r] * 3 for r in range(world)]
    obj = {"weights": list(range(500)), "from": 1} if rank == 1 else None
    assert rabit_tpu_torch.broadcast(obj, 1) == {
        "weights": list(range(500)), "from": 1}
    raw = bytes(range(256)) * 3 if rank == 2 else None
    assert eng.broadcast(raw, 2) == bytes(range(256)) * 3
    assert eng.broadcast(b"" if rank == 0 else None, 0) == b""
    h = rabit_tpu_torch.allreduce_async(np.ones(5), rabit_tpu_torch.SUM,
                                        fuse=False, codec=False)
    assert h.wait().tolist() == [float(world)] * 5
    rec["ops"] = dict(eng.path_stats)


def _adopt(rank, out):
    rabit_tpu_torch.init(rabit_engine="xla")
    eng = engine_mod.get_engine()
    rec = dict(rank=rabit_tpu_torch.get_rank(),
               world=rabit_tpu_torch.get_world_size(),
               adopted=eng._adopted, no_host=eng._no_host_transport,
               plane=engine_mod.is_device_plane(),
               inner=type(eng._inner).__name__, backend=eng.backend)
    _collectives(rank, WORLD, rec, device_plane=True)
    # checkpoints are the EmptyEngine's, in memory
    rabit_tpu_torch.checkpoint({"iter": 3})
    rec["ckpt"] = [rabit_tpu_torch.version_number(),
                   rabit_tpu_torch.load_checkpoint()]
    rabit_tpu_torch.finalize()
    # the caller's group outlives the engine: adopt it again, then die
    assert dist.is_initialized()
    rabit_tpu_torch.init(rabit_engine="xla")
    if rank == 1:
        os._exit(7)
    t0 = time.monotonic()
    try:
        for _ in range(50):
            rabit_tpu_torch.allreduce(np.ones(4), rabit_tpu_torch.SUM)
        rec["raised"] = None
    except RuntimeError as e:
        rec["raised"] = str(e)
    rec["raise_s"] = time.monotonic() - t0
    with open(os.path.join(out, f"adopt.{rank}"), "w") as f:
        json.dump(rec, f)
    # the group is broken: skip its teardown
    os._exit(0)


def _mixed(mode, rank, out):
    extra = ({"rabit_task_id": str(WORLD - 1 - rank)} if mode == "mismatch"
             else {})
    rabit_tpu_torch.init(rabit_engine="xla", rabit_inner_engine="pysocket",
                         **extra)
    eng = engine_mod.get_engine()
    me = rabit_tpu_torch.get_rank()
    rec = dict(rank=me, world=rabit_tpu_torch.get_world_size(),
               adopted=eng._adopted, degraded=eng._degraded,
               group=eng.group is not None,
               inner=type(eng._inner).__name__)
    _collectives(me, WORLD, rec, device_plane=mode == "ok")
    # the host engine's checkpoints are what mixed mode adds to adopt
    model = {"iter": 3, "w": [float(me)]}
    rabit_tpu_torch.checkpoint(model)
    rec["ckpt"] = [rabit_tpu_torch.version_number(),
                   rabit_tpu_torch.load_checkpoint()]
    rabit_tpu_torch.finalize()
    with open(os.path.join(out, f"{mode}.{rank}"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def _worker(kind, rank, port, out):
    _init_group(rank, port)
    if kind == "adopt":
        return _adopt(rank, out)
    return _mixed(kind, rank, out)


# ------------------------------------------------------------------ tests
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(kind, out, env_extra=None):
    """Three worker processes of this file; returns their exit codes."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env.update(PYTHONPATH=ROOT, **(env_extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), kind, str(r), str(port),
         str(out)], cwd=ROOT, env=env) for r in range(WORLD)]
    try:
        return [p.wait(timeout=PROC_SEC) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _records(out, kind):
    return {r: json.loads((out / f"{kind}.{r}").read_text())
            for r in range(WORLD) if (out / f"{kind}.{r}").exists()}


@pytest.fixture(scope="module")
def adopt_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("adopt")
    return _launch("adopt", out), _records(out, "adopt")


def test_adopt_mode_world3(adopt_run):
    """Rank and world are the group's; every op rides the group (numpy
    in place, allgather, broadcasts from roots 1 and 2, an empty one);
    checkpoints are the EmptyEngine's; the engine adopts again after
    finalize."""
    codes, recs = adopt_run
    assert sorted(recs) == [0, 2], codes
    for r, rec in recs.items():
        assert (rec["rank"], rec["world"]) == (r, WORLD)
        assert rec["adopted"] and rec["no_host"] and rec["plane"]
        assert (rec["inner"], rec["backend"]) == ("EmptyEngine", "gloo")
        assert rec["ops"]["host_ops"] == 0
        assert rec["ops"]["device_ops"] == 5
        assert rec["ckpt"] == [1, [1, {"iter": 3}]]


def test_adopt_mode_peer_death_raises(adopt_run):
    """A peer's death surfaces as the documented RuntimeError on both
    survivors' next collective, within RAISE_SEC, never a hang."""
    codes, recs = adopt_run
    assert codes == [0, 7, 0]
    for rec in recs.values():
        assert rec["raised"] is not None and \
            "no host transport" in rec["raised"], rec["raised"]
        assert rec["raise_s"] < RAISE_SEC


@pytest.fixture
def mixed_tracker(monkeypatch):
    from rabit_tpu_torch.tracker.tracker import Tracker

    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    trk = Tracker(WORLD, "127.0.0.1", 0)
    trk.start()
    yield trk
    trk.stop()


@pytest.mark.parametrize("mode", ["ok", "mismatch", "relaunch"])
def test_mixed_mode_world3(mode, mixed_tracker, tmp_path):
    """ok: registered as ``dist.get_rank()``, pinned, tensors on the
    group; mismatch (task ids reversed: rank 1 matches itself) and
    relaunch (``RABIT_RELAUNCH=1``): every rank adopted and degraded,
    tensors on the host engine.  numpy ops, broadcasts and checkpoints
    ride the host engine in every mode."""
    env = {"RABIT_TRACKER_URI": "127.0.0.1",
           "RABIT_TRACKER_PORT": str(mixed_tracker.port)}
    if mode == "relaunch":
        env["RABIT_RELAUNCH"] = "1"
    codes = _launch(mode, tmp_path, env)
    assert codes == [0, 0, 0]
    recs = _records(tmp_path, mode)
    for r, rec in recs.items():
        want = WORLD - 1 - r if mode == "mismatch" else r
        assert (rec["rank"], rec["world"]) == (want, WORLD)
        assert rec["adopted"] and rec["inner"] == "PySocketEngine"
        assert rec["degraded"] is (mode != "ok")
        assert rec["group"] is (mode == "ok")
        assert rec["ckpt"] == [1, [1, {"iter": 3, "w": [float(want)]}]]


def test_mixed_world_mismatch_degrades_without_a_collective(monkeypatch):
    """A ``torch.distributed`` world of 2 under a tracker world of 3: all
    three ranks degrade at start, with no op on the external group, and
    a tensor allreduce rides the host engine."""
    from test_torch_xla import run_world

    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    for var in ("RABIT_TRACKER_URI", "RABIT_TRACKER_PORT", "RABIT_TASK_ID",
                "RABIT_RELAUNCH", "RABIT_NUM_TRIAL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 0)

    def no_collective(*a, **k):
        raise AssertionError("the mismatch entered a collective")
    monkeypatch.setattr(dist, "get_backend", no_collective)
    lock = threading.Lock()

    def body(eng, trial, rec):
        assert eng._adopted and eng._degraded and eng.group is None
        out = eng.allreduce(torch.full((4,), float(eng.rank)),
                            rabit_tpu_torch.SUM)
        with lock:
            rec.update(out=out.tolist(), stats=dict(eng.path_stats))
    recs, lives = run_world(3, body)
    assert lives == [1, 1, 1]
    for rec in recs:
        assert rec["out"] == [3.0] * 4
        assert rec["stats"] == {"device_ops": 0, "host_ops": 1,
                                "backend": None}


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                     sys.argv[4]))
