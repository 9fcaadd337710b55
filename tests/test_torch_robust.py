"""The port's fault-tolerant pyrobust engine against rabit_tpu's, on threads.

Every world runs its ranks on threads of this process against an
in-process tracker on 127.0.0.1 port 0, as ``tests/test_torch_pysocket.py``
does.  A rank dies at its ``RABIT_MOCK`` kill-point the way a process
dies for its peers: a test-side subclass of both engines overrides
``_verify`` to close every link and the listener without a goodbye,
stop the async pump and raise; the harness then builds a fresh engine
with the same task id and ``rabit_num_trial`` one higher, as the
keepalive launcher relaunches a process.  The scenario matrix is
``tests/test_recovery.py``'s, its workers' bodies
(``tests/workers/model_recover.py``, ``local_recover.py``,
``lazy_recover.py``, ``replay_flag.py``, ``replay_cache.py``) rewritten
as functions on the engine: every result a rank sees, in every life, is
held bit for bit against the fault-free run and against a world of
``rabit_tpu``'s ``PyRobustEngine`` killed at the same points.

Seqno map per iteration (seq resets at each checkpoint):
  model_recover: 0 = MAX allreduce, 1 = broadcast, 2 = SUM allreduce
  local_recover: 0 = MAX allreduce (lazy prepare), 1 = SUM allreduce
  lazy_recover:  0 = SUM allreduce
  (1<<20) = at checkpoint, (1<<20)+1 = at load_checkpoint
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from rabit_tpu import engine as jengine_mod
from rabit_tpu.engine.robust import PyRobustEngine as JRobust
from rabit_tpu.learn import boosting as jgb
from rabit_tpu.learn import kmeans as jkm
from rabit_tpu.learn.data import SparseMat as JSparseMat
from rabit_tpu.ops import ReduceOp as JOp
from rabit_tpu.tracker.tracker import Tracker as JTracker
from rabit_tpu_torch import engine as engine_mod
from rabit_tpu_torch.engine.robust import (K_CHECK_ACK, K_CHECKPOINT,
                                           K_LOAD_CHECK, K_LOCAL_CHK,
                                           K_SHUTDOWN, SEQ_CHECKPOINT,
                                           SEQ_LOAD_CHECK, PyRobustEngine,
                                           RecoveryError)
from rabit_tpu_torch.learn import boosting as gb
from rabit_tpu_torch.learn import kmeans as km
from rabit_tpu_torch.learn.data import SparseMat
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.tracker.tracker import Tracker
from test_torch_pysocket_learn import (GB_DEPTH, GB_NBIN, KM_K, gbdt_shard,
                                       kmeans_shard)
from torch_ref import ref_engine

CKPT, LOAD = SEQ_CHECKPOINT, SEQ_LOAD_CHECK
JOIN_SEC = 30.0
TRACKERS = {"torch": Tracker, "jax": JTracker}
OPCODES = {"torch": ReduceOp, "jax": JOp}


class _Killed(Exception):
    """A rank's death at its kill-point, inside this process."""


def _killable(base):
    class Killable(base):
        def _verify(self, seqno):
            if (self._version, seqno, self._num_trial) in self._kill_points:
                # What a process death leaves its peers: links and the
                # listener closed with no shutdown handshake, so they
                # read EOF; the async pump told to stop.
                self._close_links()
                with self._aq_cv:
                    self._aq.append(None)
                    self._aq_cv.notify_all()
                raise _Killed(f"rank {self._rank} at v{self._version} "
                              f"seq {seqno} trial {self._num_trial}")
    Killable.__name__ = f"Killable{base.__name__}"
    return Killable


ENGINES = {"torch": _killable(PyRobustEngine),
           "jax": _killable(ref_engine(JRobust))}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Ranks pinned to task ids, so that the same rank dies in every
    world; no kill-point or trial from the environment."""
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    monkeypatch.setenv("RABIT_TPU_LOG_TAG", "")
    for var in ("RABIT_TRACKER_SHUFFLE", "RABIT_TRACKER_GROUPS",
                "RABIT_TIMEOUT_SEC", "RABIT_OBS", "RABIT_SCHED",
                "RABIT_MOCK", "RABIT_NUM_TRIAL", "RABIT_REDUCE_BUFFER",
                "RABIT_GLOBAL_REPLICA", "RABIT_LOCAL_REPLICA",
                "RABIT_ELASTIC", "RABIT_ADAPT", "RABIT_CKPT_DIR"):
        monkeypatch.delenv(var, raising=False)


def _mock(points):
    return ";".join(",".join(map(str, p)) for p in points)


def _run_world(kinds, body, mock=(), params=None, tracker="torch"):
    """One rank thread per entry of ``kinds`` ("torch" or "jax") against
    one in-process tracker.  Each life of rank i builds a fresh engine
    and runs ``body(eng, kind, trial, rec)`` between init and shutdown;
    ``rec`` is the rank's record, kept across its lives.  Returns
    (records, lives) by rank."""
    world = len(kinds)
    trk = TRACKERS[tracker](world, "127.0.0.1", 0)
    trk.start()
    recs = [{} for _ in range(world)]
    lives = [0] * world
    errs = []

    def run(i):
        trial = 0
        while True:
            eng = ENGINES[kinds[i]]()
            lives[i] += 1
            p = {"rabit_tracker_uri": "127.0.0.1",
                 "rabit_tracker_port": trk.port, "rabit_task_id": str(i),
                 "rabit_world_size": world, "rabit_timeout_sec": 20,
                 "rabit_obs": 0, "rabit_num_trial": trial,
                 "rabit_mock": _mock(mock), **(params or {})}
            try:
                eng.init(p)
                body(eng, kinds[i], trial, recs[i])
                eng.shutdown()
                return
            except _Killed:
                trial += 1
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append((i, trial, e))
                eng._close_links()      # let the peers fail, not hang
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


def _put(rec, key, value):
    """Record a result; a later life must see the same bits."""
    if key in rec:
        assert rec[key] == value, key
    rec[key] = value


def _blob(obj):
    return json.dumps(obj, sort_keys=True).encode()


# ---------------------------------------------------------------- bodies
def model_recover(eng, kind, trial, rec, ndata=1000, niter=3):
    """``tests/workers/model_recover.py``: a MAX allreduce, a rotating
    root broadcast and a SUM allreduce an iteration, then a checkpoint."""
    op = OPCODES[kind]
    rank, world = eng.rank, eng.world_size
    version, g, _ = eng.load_checkpoint()
    start = json.loads(g)["iter"] if g is not None else 0
    assert version == start, (version, g)
    rec.setdefault("starts", []).append(start)
    for it in range(start, niter):
        a = np.arange(ndata, dtype=np.float32) + rank + it
        eng.allreduce(a, op.MAX)
        np.testing.assert_array_equal(
            a, np.arange(ndata, dtype=np.float32) + world - 1 + it)
        root = it % world
        obj = eng.broadcast(_blob({"iter": it, "root": root})
                            if rank == root else None, root)
        assert json.loads(obj) == {"iter": it, "root": root}
        b = np.ones(ndata, dtype=np.float64) * (rank + 1)
        eng.allreduce(b, op.SUM)
        np.testing.assert_array_equal(b, world * (world + 1) / 2)
        _put(rec, it, (a.tobytes(), obj, b.tobytes()))
        eng.checkpoint(_blob({"iter": it + 1}))
        assert eng.version_number == it + 1
    _put(rec, "end", eng.version_number)


def local_recover(eng, kind, trial, rec, ndata=1000, niter=3):
    """``tests/workers/local_recover.py``: a (global, local) checkpoint
    pair; the local model is this rank's own state, back from its ring
    replicas after its death; the MAX allreduce fills lazily."""
    op = OPCODES[kind]
    rank, world = eng.rank, eng.world_size
    version, g, local = eng.load_checkpoint()
    start = json.loads(g)["iter"] if g is not None else 0
    rec.setdefault("starts", []).append(start)
    if start > 0:
        assert local is not None, "local model lost"
        assert json.loads(local) == {"rank": rank,
                                     "state": [rank * 100 + start] * 4}
    for it in range(start, niter):
        a = np.empty(ndata, dtype=np.float32)

        def prep(a=a, it=it):
            a[:] = np.arange(ndata, dtype=np.float32) + rank + it
        eng.allreduce(a, op.MAX, prepare_fun=prep)
        np.testing.assert_array_equal(
            a, np.arange(ndata, dtype=np.float32) + world - 1 + it)
        b = np.full(ndata, float(rank + 1), dtype=np.float64)
        eng.allreduce(b, op.SUM)
        np.testing.assert_array_equal(b, world * (world + 1) / 2)
        _put(rec, it, (a.tobytes(), b.tobytes()))
        eng.checkpoint(_blob({"iter": it + 1}),
                       _blob({"rank": rank,
                              "state": [rank * 100 + it + 1] * 4}))
    _put(rec, "end", eng.version_number)


def lazy_recover(eng, kind, trial, rec, ndata=1000, niter=3):
    """``tests/workers/lazy_recover.py``: checkpoints through
    ``lazy_global``, serialized only when a loader needs them."""
    op = OPCODES[kind]
    rank, world = eng.rank, eng.world_size
    version, g, _ = eng.load_checkpoint()
    start = json.loads(g)["iter"] if g is not None else 0
    assert version == start, (version, g)
    rec.setdefault("starts", []).append(start)
    for it in range(start, niter):
        a = np.arange(ndata, dtype=np.float32) * (it + 1) + rank
        eng.allreduce(a, op.SUM)
        base = np.arange(ndata, dtype=np.float32) * (it + 1)
        np.testing.assert_array_equal(
            a, world * base + np.float32(world * (world - 1) / 2))
        _put(rec, it, a.tobytes())
        eng.checkpoint(None, None,
                       lazy_global=lambda it=it: _blob({"iter": it + 1}))
    _put(rec, "end", eng.version_number)


BODIES = {"model": model_recover, "local": local_recover,
          "lazy": lazy_recover}


def _scenario(name, world, mock, body=None, params=None, ckpt_root=None):
    """The port world killed at ``mock`` against its fault-free run and
    against the reference world killed at the same points: every rank's
    record equal bit for bit, the same lives, and each life resuming at
    the same checkpoint.  ``body`` holds the worker's size arguments,
    ``params`` engine knobs; ``ckpt_root`` gives each of the three
    worlds a durable store of its own under it.  Returns the lives by
    rank and the iteration each life started at."""
    def run(eng, kind, trial, rec):
        BODIES[name](eng, kind, trial, rec, **(body or {}))

    def knobs(world_name):
        if ckpt_root is None:
            return params
        return {**(params or {}),
                "rabit_ckpt_dir": os.path.join(ckpt_root, world_name)}
    clean, clean_lives = _run_world(["torch"] * world, run, (),
                                    knobs("clean"))
    got, lives = _run_world(["torch"] * world, run, mock, knobs("port"))
    want, want_lives = _run_world(["jax"] * world, run, mock, knobs("ref"))
    starts = [rec.pop("starts") for rec in got]
    assert starts == [rec.pop("starts") for rec in want]
    assert [rec.pop("starts") for rec in clean] == [[0]] * world
    assert clean_lives == [1] * world
    assert lives == want_lives
    assert got == want == clean
    died = {p[0] for p in mock if p[3] == 0}
    assert all(lives[r] > 1 for r in died), lives
    return lives, starts


# ------------------------------------------------------------ the matrix
@pytest.mark.parametrize("body", ["model", "local", "lazy"])
def test_no_faults(body):
    assert _scenario(body, 4, []) == ([1] * 4, [[0]] * 4)


def test_model_recover_single_death():
    # rank 0 dies at version 0 seq 1 (mid-iteration, before broadcast)
    assert _scenario("model", 4, [(0, 0, 1, 0)]) == (
        [2, 1, 1, 1], [[0, 0], [0], [0], [0]])


def test_model_recover_two_deaths_different_versions():
    # rank 0 dies at v0, rank 1 at v1
    # (reference: test/test.mk model_recover_10_10k)
    assert _scenario("model", 4, [(0, 0, 1, 0), (1, 1, 1, 0)]) == (
        [2, 2, 1, 1], [[0, 0], [0, 1], [0], [0]])


def test_death_at_checkpoint_and_death_at_load():
    # rank 2 dies entering version 1's commit: the survivors at the
    # barrier commit first, so its relaunch loads version 2 and redoes
    # nothing; rank 3 dies at its very first load_checkpoint
    assert _scenario("model", 4, [(2, 1, CKPT, 0)]) == (
        [1, 1, 2, 1], [[0], [0], [0, 2], [0]])
    assert _scenario("model", 4, [(3, 0, LOAD, 0)]) == (
        [1, 1, 1, 2], [[0], [0], [0], [0]])


def test_model_recover_die_same():
    # several ranks die at the same collective
    # (reference: test/test.mk model_recover_10_10k_die_same)
    assert _scenario("model", 4, [(0, 1, 0, 0), (1, 1, 0, 0),
                                  (3, 1, 0, 0)])[0] == [2, 2, 1, 2]


def test_model_recover_die_hard():
    # rank 1 dies, restarts, and dies again during recovery; rank 0 also
    # dies at the same point
    assert _scenario("model", 4, [(1, 1, 1, 0), (0, 1, 1, 0),
                                  (1, 1, 1, 1)]) == (
        [2, 3, 1, 1], [[0, 1], [0, 1, 1], [0], [0]])


def test_repeated_deaths_across_versions():
    # rank 2 dies at v0 on its first life; its later kill-points name
    # life 0 too, so the relaunch runs through (the reference's case)
    _scenario("model", 4, [(2, 0, 0, 0), (2, 1, 1, 0), (2, 2, 2, 0)],
              body={"niter": 4})
    # the same rank dying on each of three lives, at three versions
    assert _scenario("model", 4, [(2, 0, 0, 0), (2, 1, 1, 1),
                                  (2, 2, 2, 2)], body={"niter": 4}) == (
        [1, 1, 4, 1], [[0], [0], [0, 0, 1, 2], [0]])


def test_local_recover_death_and_adjacent_deaths():
    # the dying rank's local model comes back from its ring replicas,
    # also when two adjacent ranks die at once (rabit_local_replica 2)
    assert _scenario("local", 4, [(1, 1, 0, 0)])[0] == [1, 2, 1, 1]
    assert _scenario("local", 4, [(1, 1, 0, 0), (2, 1, 0, 0)]) == (
        [1, 2, 2, 1], [[0], [0, 1], [0, 1], [0]])


def test_lazy_recover_death_and_die_same():
    assert _scenario("lazy", 4, [(2, 1, 0, 0)])[0] == [1, 1, 2, 1]
    assert _scenario("lazy", 4, [(0, 1, 0, 0), (2, 1, 0, 0)]) == (
        [2, 1, 2, 1], [[0, 1], [0], [0, 1], [0]])


def test_recover_with_chunked_collectives():
    """Deaths while payloads are 30x and 60x the 64 KB
    ``rabit_reduce_buffer``: the chunked tree/ring paths fail cleanly
    mid-stream and replay correctly."""
    assert _scenario("model", 4, [(0, 0, 1, 0), (1, 1, 1, 0)],
                     body={"ndata": 500_000},
                     params={"rabit_reduce_buffer": "64KB"})[0] == [
        2, 2, 1, 1]


def test_model_recover_world10_striped():
    """World 10 with the default ``rabit_global_replica`` (5): the
    stripe round is 2, so each result is cached on half the ranks, and
    replay must find it on a striped holder."""
    assert _scenario("model", 10, [(0, 1, 1, 0), (5, 2, 2, 0)],
                     body={"ndata": 10_000}) == (
        [2, 1, 1, 1, 1, 2, 1, 1, 1, 1],
        [[0, 1], [0], [0], [0], [0], [0, 2], [0], [0], [0], [0]])


# ------------------------------------------------------------ mixed worlds
@pytest.mark.parametrize("tracker", ["torch", "jax"])
@pytest.mark.parametrize("dying", ["torch", "jax"])
@pytest.mark.parametrize("body", ["model", "local"])
def test_mixed_world_recovers_both_ways(body, dying, tracker):
    """Two port and two reference ranks in one world.  A rank of the
    ``dying`` package dies twice (at v0 before the broadcast, then on
    its second life at v1), and the lowest live holder — a rank of the
    other package — serves it the checkpoint and the cached results;
    for ``local`` the dying rank's local model comes back from a ring
    successor of each package."""
    other = "jax" if dying == "torch" else "torch"
    kinds = [dying, other, dying, other]
    mock = ([(0, 0, 1, 0), (0, 1, 1, 1)] if body == "model"
            else [(2, 1, 0, 0), (2, 2, 1, 1)])

    def run(eng, kind, trial, rec):
        BODIES[body](eng, kind, trial, rec)
    got, lives = _run_world(kinds, run, mock, tracker=tracker)
    clean, _ = _run_world(["torch"] * 4, run)
    starts = [rec.pop("starts") for rec in got]
    assert [rec.pop("starts") for rec in clean] == [[0]] * 4
    assert got == clean
    if body == "model":
        assert (lives, starts) == ([3, 1, 1, 1], [[0, 0, 1], [0], [0], [0]])
    else:
        assert (lives, starts) == ([1, 1, 3, 1], [[0], [0], [0, 1, 2], [0]])


# ------------------------------------------------------ replay semantics
def _replay_flag(eng, kind, trial, rec):
    """``tests/workers/replay_flag.py``: rank 1 dies at v0 seq 1; its
    relaunch is served seq 0 from the cache (``last_op_replayed``) and
    rejoins seq 1 mid-flight (fresh), like every op after it."""
    op = OPCODES[kind]
    rank, world = eng.rank, eng.world_size
    version, _g, _l = eng.load_checkpoint()
    assert version == 0
    for i in range(4):
        a = np.full(16, float(i + 1), np.float64)
        eng.allreduce(a, op.SUM)
        np.testing.assert_array_equal(a, world * (i + 1))
        _put(rec, (trial, i), eng.last_op_replayed)


def _replay_cache(eng, kind, trial, rec):
    """``tests/workers/replay_cache.py``: a replayed op skips its
    ``prepare_fun``; the cache holds results within a version span and
    is empty (seq 0) right after each commit."""
    op = OPCODES[kind]
    rank, world = eng.rank, eng.world_size
    version, g, _ = eng.load_checkpoint()
    start = json.loads(g)["iter"] if g is not None else 0
    for it in range(start, 2):
        calls = [0]
        a = np.empty(8, dtype=np.float64)

        def prep(it=it, calls=calls, a=a):
            calls[0] += 1
            a[:] = rank + it
        eng.allreduce(a, op.MAX, prepare_fun=prep)
        np.testing.assert_array_equal(a, np.full(8, world - 1.0 + it))
        _put(rec, (trial, it, "seq0"), (eng.last_op_replayed, calls[0]))
        b = np.full(8, float(rank + 1), dtype=np.float64)
        eng.allreduce(b, op.SUM)
        np.testing.assert_array_equal(b, np.full(8, world * (world + 1) / 2))
        _put(rec, (trial, it, "seq1"), eng.last_op_replayed)
        cached = len(eng._cache)
        eng.checkpoint(_blob({"iter": it + 1}))
        _put(rec, (trial, it, "cache"), (cached > 0, len(eng._cache),
                                         eng._seq))


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_last_op_replayed_contract(kind):
    recs, lives = _run_world([kind] * 3, _replay_flag, [(1, 0, 1, 0)])
    assert lives == [1, 2, 1]
    for rank, rec in enumerate(recs):
        for (trial, i), replayed in rec.items():
            assert replayed == (rank == 1 and trial == 1 and i == 0), (
                rank, trial, i)
    assert set(recs[1]) == {(0, 0)} | {(1, i) for i in range(4)}


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_replay_prepare_skip_and_cache_clear(kind):
    recs, lives = _run_world([kind] * 3, _replay_cache, [(1, 0, 1, 0)])
    assert lives == [1, 2, 1]
    for rank, rec in enumerate(recs):
        for key, val in rec.items():
            trial, it, what = key
            if what == "seq0":
                replay = rank == 1 and trial == 1 and it == 0
                assert val == ((True, 0) if replay else (False, 1)), key
            elif what == "seq1":
                assert val is False, key
            else:
                assert val == (True, 0, 0), key
    assert (1, 0, "seq0") in recs[1] and (0, 0, "seq0") in recs[1]


# ------------------------------------------------- k-means and GBDT at 3
class _PerThread:
    """Stands in for an engine module's singleton, so that the apps'
    api calls on each rank thread reach that thread's engine."""

    def __init__(self):
        self._tl = threading.local()

    def set(self, eng):
        self._tl.eng = eng

    def __getattr__(self, name):
        return getattr(self._tl.eng, name)


@pytest.fixture
def per_thread(monkeypatch):
    proxies = {"torch": _PerThread(), "jax": _PerThread()}
    monkeypatch.setattr(engine_mod, "_engine", proxies["torch"])
    monkeypatch.setattr(jengine_mod, "_engine", proxies["jax"])
    return proxies


def _recorded(eng, rec):
    """Every allreduce result this life sees, keyed by its (version,
    seqno); the ops served from the replay cache apart, by life."""
    real = eng._allreduce_blocking

    def allreduce(buf, *a, **k):
        key = (eng._version, eng._seq)
        out = real(buf, *a, **k)
        _put(rec, ("ar",) + key, np.array(out).tobytes())
        if eng.last_op_replayed:
            _put(rec, ("replayed", eng._num_trial) + key, True)
        return out
    eng._allreduce_blocking = allreduce


def _app(proxies, which):
    def run(eng, kind, trial, rec):
        proxies[kind].set(eng)
        _recorded(eng, rec)
        rank = eng.rank
        if which == "kmeans":
            sm = (SparseMat if kind == "torch" else JSparseMat)(
                **kmeans_shard(rank))
            mod, kw = (km, {"device": "cpu"}) if kind == "torch" else (
                jkm, {})
            model = mod.run(sm, KM_K, 3, **kw)
            _put(rec, "model", np.asarray(model.centroids).tobytes())
        else:
            x, y = gbdt_shard(rank)
            mod, kw = (gb, {"device": "cpu"}) if kind == "torch" else (
                jgb, {"use_pallas": False})
            model = mod.train(x, y, num_round=3, max_depth=GB_DEPTH,
                              nbin=GB_NBIN, **kw)
            _put(rec, "model", [[(n.feature, n.bin_threshold, n.left,
                                  n.right, bool(n.default_left),
                                  float(n.value)) for n in t]
                                for t in model.trees])
        _put(rec, "version", eng.version_number)
        _put(rec, ("relaunched", trial), eng.was_relaunched)
    return run


def _results(rec):
    return {k: v for k, v in rec.items()
            if not (isinstance(k, tuple) and k[0] in ("replayed",
                                                      "relaunched"))}


@pytest.mark.parametrize("which,mock", [
    # rank 1 dies entering iteration 2's stats allreduce
    ("kmeans", [(1, 1, 0, 0)]),
    # rank 0 dies before round 2's third collective (level 2's histogram)
    ("gbdt", [(0, 1, 2, 0)])])
def test_apps_world3_one_death(per_thread, which, mock):
    """``kmeans.run`` (dense tier) and ``boosting.train`` at world 3
    through one death: every result each rank sees, in every life, and
    its model bit for bit the port's fault-free run's; the relaunched
    life replays exactly what the survivors completed; the reference
    world killed at the same point has the same lives, the same
    allreduce sequence and, as its fault-free run does, counts and
    splits exact and float32 sums within the JAX tests' bar."""
    run = _app(per_thread, which)
    clean, _ = _run_world(["torch"] * 3, run)
    got, lives = _run_world(["torch"] * 3, run, mock)
    want, want_lives = _run_world(["jax"] * 3, run, mock)
    dead = mock[0][0]
    assert lives == want_lives == [2 if r == dead else 1 for r in range(3)]
    for r in range(3):
        assert _results(got[r]) == _results(clean[r]), r
        assert set(_results(got[r])) == set(_results(want[r])), r
        assert got[r].get(("relaunched", 0)) is (None if r == dead
                                                 else False)
        assert got[r].get(("relaunched", 1)) is (True if r == dead
                                                 else None)
        for rec in (got[r], want[r]):
            replayed = sorted(k[1:] for k in rec if k[0] == "replayed")
            # gbdt: the survivors completed (1, 0) and (1, 1) before
            # rank 0 died at (1, 2); k-means' rank 1 died before (1, 0)
            # completed anywhere
            assert replayed == ([(1, 1, 0), (1, 1, 1)]
                                if which == "gbdt" and r == dead else [])
        if which == "kmeans":
            for key in (k for k in got[r] if k[0] == "ar" and k[2]):
                g, w = (np.frombuffer(rec[key], np.float32).reshape(KM_K, -1)
                        for rec in (got[r], want[r]))
                np.testing.assert_array_equal(g[:, -1], w[:, -1])
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(
                np.frombuffer(got[r]["model"], np.float32),
                np.frombuffer(want[r]["model"], np.float32),
                rtol=1e-4, atol=1e-3)
        else:
            g, w = got[r]["model"], want[r]["model"]
            assert [[n[:5] for n in t] for t in g] == [
                [n[:5] for n in t] for t in w]
            np.testing.assert_allclose([n[5] for t in g for n in t],
                                       [n[5] for t in w for n in t],
                                       rtol=1e-4, atol=1e-3)


# ------------------------------------------------------- the wire parity
@pytest.mark.parametrize("op", list(ReduceOp), ids=lambda o: o.name)
def test_fingerprint_matches_reference(op):
    """The op fingerprints of every collective, the port's against
    ``rabit_tpu``'s, for every reduce op and the dtypes and shapes the
    apps send: a difference would set K_DIFF_OP in a mixed world."""
    jop = JOp(int(op))
    for dtype in (np.float32, np.float64, np.int32, np.int64, np.uint8,
                  np.uint32, np.uint64):
        ds = np.dtype(dtype).str
        for n in (0, 1, 8, 65_792, 4_210_688):
            assert PyRobustEngine._fingerprint("allreduce", int(op), ds, n) \
                == JRobust._fingerprint("allreduce", int(jop), ds, n)
        for sizes in ((1,), (7, 7, 3), (32_896,) * 7):
            assert PyRobustEngine._fingerprint(
                "fused_allreduce", int(op), ds, sizes) == \
                JRobust._fingerprint("fused_allreduce", int(jop), ds, sizes)
        for shape in ((3,), (64, 257), (32, 64, 257, 2)):
            assert PyRobustEngine._fingerprint("custom", ds, shape) == \
                JRobust._fingerprint("custom", ds, shape)
            nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
            assert PyRobustEngine._fingerprint("allgather", ds, nb) == \
                JRobust._fingerprint("allgather", ds, nb)
    for root in range(12):
        assert PyRobustEngine._fingerprint("broadcast", root) == \
            JRobust._fingerprint("broadcast", root)
    assert PyRobustEngine._fingerprint("x") != 0


def test_merge_word_matches_reference():
    """The consensus merge on a seeded table of word pairs, flags of
    every kind, near-equal seqnos and versions, and fingerprints that
    agree, differ or are 0."""
    rng = np.random.default_rng(14)
    flags = [0, K_LOAD_CHECK, K_CHECKPOINT, K_CHECKPOINT | K_LOCAL_CHK,
             K_CHECK_ACK, K_SHUTDOWN, 256, 511]
    port, ref = PyRobustEngine(), JRobust()
    for _ in range(2000):
        pair = [np.array([rng.choice(flags), rng.integers(0, 3),
                          rng.integers(0, 3),
                          rng.choice([0, 1, 7, 0xFFFFFFFF])], np.uint32)
                for _ in range(2)]
        a, b = pair[0].copy(), pair[0].copy()
        port._merge_word(a, pair[1])
        ref._merge_word(b, pair[1])
        assert a.tolist() == b.tolist(), pair


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("key,value,item", [
    ("rabit_adapt", "1", "A8"), ("rabit_adapt", "true", "A8"),
    ("rabit_adapt", "yes", "A8"), ("rabit_wire_codec", "int8", "A8")])
def test_unported_knobs_raise(key, value, item):
    """Each knob outside the slice raises before any connection is tried
    (the tracker port is closed)."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        PyRobustEngine().init({"rabit_tracker_uri": "127.0.0.1",
                               "rabit_tracker_port": 1, key: value})


@pytest.mark.parametrize("case", ["dir", "keep-0", "writers-0", "env"])
def test_ckpt_knobs_are_served(case, tmp_path, monkeypatch):
    """The durable tier's knobs, read as the reference reads them, at
    world 1: ``rabit_ckpt_dir`` builds the store on the ``{rank}``-
    expanded directory with ``rabit_ckpt_keep`` (default 3) and
    ``rabit_ckpt_writers`` (default 1 + ``rabit_local_replica``); an
    explicit 0 for either fails its ``>= 1`` check once the rank is
    known; the environment stands in for absent params."""
    from rabit_tpu_torch.utils import RabitError

    knobs = {"dir": {"rabit_ckpt_dir": str(tmp_path / "d{rank}")},
             "keep-0": {"rabit_ckpt_dir": str(tmp_path), "rabit_ckpt_keep": 0},
             "writers-0": {"rabit_ckpt_dir": str(tmp_path),
                           "rabit_ckpt_writers": "0"},
             "env": {}}[case]
    if case == "env":
        monkeypatch.setenv("RABIT_CKPT_DIR", str(tmp_path / "e{rank}"))
        monkeypatch.setenv("RABIT_CKPT_KEEP", "5")
        monkeypatch.setenv("RABIT_CKPT_WRITERS", "2")
    trk = Tracker(1, "127.0.0.1", 0)
    trk.start()
    eng = PyRobustEngine()
    try:
        params = {"rabit_tracker_uri": "127.0.0.1",
                  "rabit_tracker_port": trk.port, "rabit_world_size": 1,
                  **knobs}
        if case in ("keep-0", "writers-0"):
            with pytest.raises(RabitError, match=">= 1"):
                eng.init(params)
            eng._close_links()
            return
        eng.init(params)
        store = eng._ckpt_store
        root, keep, writers = {"dir": ("d0", 3, 3),
                               "env": ("e0", 5, 2)}[case]
        assert (store.root, store.rank, store.keep, eng._ckpt_writers) == (
            str(tmp_path / root), 0, keep, writers)
        eng.checkpoint(b"G1")
        assert store.load_latest().global_blob == b"G1"
        eng.shutdown()
    finally:
        trk.stop()


def test_off_values_pass_and_bad_values_are_checked(monkeypatch):
    """``rabit_elastic``/``rabit_adapt`` read as the reference reads
    them pass when off (registration then fails on the closed port);
    budgets below 1 fail their checks."""
    from rabit_tpu_torch.engine.pysocket import TrackerLostError
    from rabit_tpu_torch.utils import RabitError

    base = {"rabit_tracker_uri": "127.0.0.1", "rabit_tracker_port": 1,
            "rabit_connect_retries": 0, "rabit_timeout_sec": 2}
    with pytest.raises(TrackerLostError):
        PyRobustEngine().init(dict(base, rabit_elastic="0",
                                   rabit_adapt="no"))
    for bad in ("rabit_global_replica", "rabit_local_replica",
                "rabit_recover_attempts"):
        with pytest.raises(RabitError, match=">= 1"):
            PyRobustEngine().init(dict(base, **{bad: -1}))


def test_recovery_error_once_the_tracker_is_gone():
    """A survivor whose peer died after the tracker went away exhausts
    its recover budget and raises RecoveryError with one history entry
    per failed attempt, within seconds."""
    trk = Tracker(2, "127.0.0.1", 0)
    trk.start()
    engines, errs = [None, None], []

    def run(i):
        eng = PyRobustEngine()
        try:
            eng.init({"rabit_tracker_uri": "127.0.0.1",
                      "rabit_tracker_port": trk.port,
                      "rabit_task_id": str(i), "rabit_world_size": 2,
                      "rabit_timeout_sec": 5, "rabit_recover_attempts": 3,
                      "rabit_connect_retries": 0,
                      "rabit_backoff_base_ms": 1})
            engines[i] = eng
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_SEC)
    assert not errs and all(engines)
    trk.stop()
    engines[1]._close_links()           # rank 1 dies without a goodbye
    t0 = time.monotonic()
    with pytest.raises(RecoveryError) as err:
        engines[0].allreduce(np.ones(4), ReduceOp.SUM)
    assert time.monotonic() - t0 < 30
    hist = err.value.history
    assert [h[0] for h in hist] == [1, 2, 3]
    assert all(isinstance(h[1], float) and h[2] for h in hist)
    assert "budget 3 attempts" in str(err.value)
    engines[0]._close_links()
