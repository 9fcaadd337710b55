"""The port's durable checkpoint tier against rabit_tpu's, on the CPU.

The store (``rabit_tpu_torch.ckpt``) is held byte for byte against
``rabit_tpu.ckpt``: the same blobs, the same file names and manifest
bytes, and each package reads a directory the other wrote.  The
reference's store cases (``tests/test_ckpt.py``) run on the port's
store.  The engine's side runs in rank worlds on threads against an
in-process tracker, as ``tests/test_torch_robust.py`` does: a rank that
dies closes its links and listener without a goodbye, and the harness
starts a fresh engine with the same task id, as the launcher relaunches
a process.  In a kill-all every rank dies right after a commit, so no
in-memory replica survives and the relaunched world must resume from
disk: ``tests/workers/cold_restart.py``'s body, rewritten as a function
on the engine, in port, reference and mixed worlds under both trackers.
One case runs the port's launcher CLI with real processes; this file,
run as a script, is its worker.
"""
import json
import os
import pickle
import shutil
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from rabit_tpu import ckpt as jckpt
from rabit_tpu_torch import RabitError
from rabit_tpu_torch import ckpt
from rabit_tpu_torch.ckpt import (CheckpointSkewError, CheckpointStore,
                                  expand_dir, pack_blob, unpack_blob)
from rabit_tpu_torch.engine.robust import SEQ_CHECKPOINT
from test_torch_pysocket_learn import KM_K
from test_torch_robust import (BODIES, ENGINES, OPCODES, TRACKERS, _app,
                               _blob, _Killed, _put, _results, _scenario)
from test_torch_robust import per_thread  # noqa: F401 — fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_SEC = 30.0
STORES = {"torch": ckpt, "jax": jckpt}
KINDS = {"port": ("torch",) * 3, "ref": ("jax",) * 3,
         "mixed": ("torch", "jax", "torch"),
         "mixed-rev": ("jax", "torch", "jax")}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Ranks pinned to task ids; no knob or kill-point from outside."""
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    monkeypatch.setenv("RABIT_TPU_LOG_TAG", "")
    for var in [v for v in os.environ if v.startswith("RABIT_")
                and v not in ("RABIT_TRACKER_PIN_RANKS",
                              "RABIT_TPU_LOG_TAG")]:
        monkeypatch.delenv(var)


# ------------------------------------------------------- store, byte parity
def _blob_case(seed):
    """Seeded (version, world, writer, global, locals): empty globals, no
    locals, one local and several."""
    rng = np.random.default_rng(seed)
    nloc = [0, 0, 1, 3, 5][seed % 5]
    glen = [0, 1, 37, 4096, 70_001][seed % 5]
    world = int(rng.integers(1, 9))
    locals_ = {int(o): rng.bytes(int(rng.integers(0, 300)))
               for o in rng.choice(16, nloc, replace=False)}
    return (int(rng.integers(0, 1 << 31)), world,
            int(rng.integers(0, world)), rng.bytes(glen), locals_)


@pytest.mark.parametrize("seed", range(10))
def test_pack_blob_bytes_match_reference(seed):
    version, world, writer, g, locals_ = _blob_case(seed)
    raw = pack_blob(version, world, writer, g, locals_)
    assert raw == jckpt.pack_blob(version, world, writer, g, locals_)
    for unpack in (unpack_blob, jckpt.unpack_blob):
        dc = unpack(raw)
        assert (dc.version, dc.world, dc.writer, dc.global_blob,
                dc.locals, dc.raw) == (version, world, writer, g, locals_,
                                       raw)
    for bad in (raw[:-1], raw[:5], raw[:-4] + b"\0\0\0\0",
                b"\0" + raw[1:]):
        for unpack in (unpack_blob, jckpt.unpack_blob):
            with pytest.raises(ValueError):
                unpack(bad)


def _persist_all(mod, root, keep, rank=0):
    """One seeded persist sequence: versions out of order and a version
    persisted twice, so retention and replacement both act."""
    store = mod.CheckpointStore(str(root), rank=rank, keep=keep)
    rng = np.random.default_rng(keep)
    for v in (1, 2, 3, 5, 4, 6, 6, 7):
        store.persist(v, 4, rng.bytes(int(rng.integers(0, 200))),
                      {o: rng.bytes(9) for o in range(v % 3)})
    return store


@pytest.mark.parametrize("keep", [2, 3])
@pytest.mark.parametrize("rank", [0, 2])
def test_store_files_match_reference(tmp_path, keep, rank):
    """After the same persists both stores hold the same file names, the
    same manifest bytes and the same blob bytes."""
    for name, mod in STORES.items():
        _persist_all(mod, tmp_path / name, keep, rank)
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len([n for n in names if n.endswith(".ckpt")]) == keep
    assert ("manifest.json" if rank == 0 else f"manifest.r{rank}.json") \
        in names
    for n in names:
        assert (tmp_path / "torch" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_reads_the_others_store(tmp_path, writer):
    """Two writers of one package share a directory; the other package's
    loader sees the same newest version, versions, scan and blobs, and
    falls back past a corrupt blob the same way."""
    mod = STORES[writer]
    _persist_all(mod, tmp_path, 3, rank=0)
    mod.CheckpointStore(str(tmp_path), rank=1, keep=2).persist(
        9, 4, b"w1", {1: b"L"})
    views = {}
    for name, m in STORES.items():
        s = m.CheckpointStore(str(tmp_path), rank=3)
        dc = s.load_latest()
        views[name] = (dc.version, dc.writer, dc.global_blob, dc.locals,
                       s.versions(), s.scan(), s.newest_version(),
                       s.newest_version(min_version=9),
                       s.load_version(6).raw, s.load_version(8))
    assert views["torch"] == views["jax"]
    assert views["torch"][:2] == (9, 1)
    p = tmp_path / "v00000009.r1.ckpt"
    p.write_bytes(p.read_bytes()[:-2] + b"xx")
    assert [m.CheckpointStore(str(tmp_path), rank=3).load_latest().version
            for m in STORES.values()] == [7, 7]


# -------------------------------------- the reference's store cases (port)
def test_store_roundtrip_and_retention(tmp_path):
    s = CheckpointStore(str(tmp_path), rank=0, keep=3)
    for v in range(1, 6):
        s.persist(v, 4, b"G%d" % v, {0: b"L0", 3: b"L3%d" % v})
    dc = s.load_latest()
    assert (dc.version, dc.world, dc.writer) == (5, 4, 0)
    assert dc.global_blob == b"G5"
    assert dc.locals == {0: b"L0", 3: b"L35"}
    blobs = [f for f in os.listdir(tmp_path) if f.endswith(".ckpt")]
    assert sorted(blobs) == ["v00000003.r0.ckpt", "v00000004.r0.ckpt",
                             "v00000005.r0.ckpt"]
    assert unpack_blob(dc.raw).version == 5


def test_store_corrupt_and_truncated_fall_back(tmp_path):
    s = CheckpointStore(str(tmp_path), rank=0, keep=5)
    for v in (1, 2, 3):
        s.persist(v, 2, b"G%d" % v)
    p3 = tmp_path / "v00000003.r0.ckpt"
    raw = bytearray(p3.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p3.write_bytes(bytes(raw))
    assert s.load_latest().version == 2
    assert s.newest_version() == 2
    p2 = tmp_path / "v00000002.r0.ckpt"
    p2.write_bytes(p2.read_bytes()[:11])
    assert s.load_latest().version == 1
    assert {e["version"]: e["valid"] for e in s.scan()} == {
        3: False, 2: False, 1: True}


def test_store_torn_writes_are_invisible(tmp_path):
    s = CheckpointStore(str(tmp_path), rank=1, keep=3)
    s.persist(1, 2, b"G1")
    s.persist(2, 2, b"G2")
    (tmp_path / ".v00000009.r1.ckpt.tmp.1234").write_bytes(b"torn garbage")
    assert s.load_latest().version == 2
    os.remove(tmp_path / s.manifest_name)
    assert s.load_latest().version == 2
    s.persist(3, 2, b"G3")
    os.remove(tmp_path / "v00000003.r1.ckpt")
    assert s.load_latest().version == 2


def test_store_multi_writer_shared_dir(tmp_path):
    CheckpointStore(str(tmp_path), rank=0).persist(4, 4, b"w0")
    CheckpointStore(str(tmp_path), rank=2).persist(6, 4, b"w2")
    dc = CheckpointStore(str(tmp_path), rank=0).load_latest()
    assert (dc.version, dc.writer, dc.global_blob) == (6, 2, b"w2")


def test_skew_error_and_dir_expansion():
    e = CheckpointSkewError(9, 2)
    assert isinstance(e, RabitError)
    assert e.disk_version == 9 and e.agreed_version == 2
    assert str(e) == str(jckpt.CheckpointSkewError(9, 2))
    assert expand_dir("/disks/{rank}/ckpt", 3) == "/disks/3/ckpt"
    with pytest.raises(ValueError):
        unpack_blob(pack_blob(1, 2, 0, b"x")[:-1] + b"\x00")


def test_sweep_spares_this_process_and_other_ranks(tmp_path):
    """Opening a store reaps only its own rank's tmp files left by other
    processes: this process's in-flight ones and other ranks' stay."""
    pid = os.getpid()
    names = {".v00000003.r1.ckpt.tmp.1": False,
             ".manifest.r1.json.tmp.1": False,
             f".v00000003.r1.ckpt.tmp.{pid}": True,
             ".v00000003.r2.ckpt.tmp.1": True,
             ".manifest.json.tmp.1": True,
             ".manifest.r2.json.tmp.1": True}
    for n in names:
        (tmp_path / n).write_bytes(b"x")
    for name, mod in STORES.items():
        d = tmp_path / name
        shutil.copytree(tmp_path, d, ignore=lambda *_: ["torch", "jax"])
        mod.CheckpointStore(str(d), rank=1)
        assert sorted(os.listdir(d)) == sorted(n for n, kept in
                                               names.items() if kept), name


def test_torn_persist_through_the_crash_seam(tmp_path, monkeypatch):
    """``RABIT_CKPT_CRASH="0,2"``: the writer dies (exit 254) after v2's
    blob rename, before its manifest rename; v2 is an orphan blob that
    the loader still finds, every manifest parses, and a second life
    (trial 1) persists past the seam."""
    code = ("import sys; from rabit_tpu_torch.ckpt.store import "
            "CheckpointStore as S; s = S(sys.argv[1], rank=0, keep=8); "
            "[s.persist(v, 2, b'G%d' % v) for v in (1, 2, 3)]")
    env = dict(os.environ, PYTHONPATH=ROOT, RABIT_CKPT_CRASH="0,2",
               RABIT_NUM_TRIAL="0")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 254, proc.stderr
    assert "injected writer death after blob rename (rank 0, v2)" \
        in proc.stderr
    s = CheckpointStore(str(tmp_path), rank=0)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert [e["version"] for e in manifest["entries"]] == [1]
    assert s.load_latest().version == 2
    assert all(e["valid"] for e in s.scan())
    monkeypatch.setenv("RABIT_CKPT_CRASH", "0,2")
    monkeypatch.setenv("RABIT_NUM_TRIAL", "1")
    s.persist(2, 2, b"G2")
    s.persist(3, 2, b"G3")
    assert s.versions() == [3, 2, 1]
    assert all(e["valid"] for e in s.scan())


# ------------------------------------------------------- rank worlds
class _SigKilled(_Killed):
    """A rank killed from outside: relaunched with the same trial."""


def _die(eng):
    """What a SIGKILL leaves the peers: links and the listener closed
    with no goodbye; the async pump told to stop."""
    eng._close_links()
    with eng._aq_cv:
        eng._aq.append(None)
        eng._aq_cv.notify_all()
    raise _SigKilled(f"rank {eng.rank} at v{eng.version_number}")


def _stop(trk):
    """Stop a tracker at once: the reference's stop() does not wake a
    blocked accept(), so the listener is shut down first."""
    try:
        trk._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    trk.stop()


def _world(kinds, body, params=None, tracker="torch", mock=(),
           abort=False):
    """One rank thread per entry of ``kinds`` against one in-process
    tracker; each life builds a fresh engine and runs ``body(eng, kind,
    trial, rec)``.  ``params(i)`` gives rank i's extra knobs.  A rank
    that raises ends its thread; with ``abort`` the tracker stops, as
    the launcher stops it on a permanent failure, so the survivors fail
    fast.  Returns (records, lives, errors by rank)."""
    world = len(kinds)
    trk = TRACKERS[tracker](world, "127.0.0.1", 0)
    trk.start()
    recs = [{} for _ in range(world)]
    lives = [0] * world
    errs = {}
    mock = ";".join(",".join(map(str, p)) for p in mock)

    def run(i):
        trial = 0
        while True:
            eng = ENGINES[kinds[i]]()
            lives[i] += 1
            p = {"rabit_tracker_uri": "127.0.0.1",
                 "rabit_tracker_port": trk.port, "rabit_task_id": str(i),
                 "rabit_world_size": world, "rabit_timeout_sec": 20,
                 "rabit_obs": 0, "rabit_num_trial": trial,
                 "rabit_mock": mock, **(params(i) if params else {})}
            try:
                eng.init(p)
                body(eng, kinds[i], trial, recs[i])
                eng.shutdown()
                return
            except _SigKilled:
                pass
            except _Killed:
                trial += 1
            except Exception as e:  # noqa: BLE001 — returned
                errs[i] = e
                eng._close_links()
                if abort:
                    _stop(trk)
                return
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(world)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_SEC
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    alive = [t for t in threads if t.is_alive()]
    _stop(trk)
    assert not alive, f"{len(alive)} rank thread(s) still running"
    return recs, lives, errs


def _clean(errs):
    assert not errs, errs


def cold_restart(eng, kind, trial, rec, barrier=None, kill_at=0, ndata=400,
                 niter=4, expect=None):
    """``tests/workers/cold_restart.py`` on the engine: model state
    (``acc``) that depends on every iteration, a checkpoint each, and
    with ``kill_at`` every rank killed right after committing that
    version (once: ``barrier`` holds the deaths until every rank has
    committed, so no replica survives).  Each life records the version
    it resumed at; ``expect`` pins the version a first life loads."""
    op = OPCODES[kind]
    rank, world = eng.rank, eng.world_size
    version, g, _ = eng.load_checkpoint()
    if expect is not None and "killed" not in rec:
        assert version == expect, (version, expect)
    if g is not None:
        (start,) = struct.unpack_from("<I", g)
        acc = np.frombuffer(g, np.float64, offset=8).copy()
    else:
        start, acc = 0, np.zeros(ndata, np.float64)
    assert version == start, (version, start)
    rec.setdefault("starts", []).append(start)
    rec.setdefault("relaunched", []).append(eng.was_relaunched)
    for it in range(start, niter):
        a = np.arange(ndata, dtype=np.float32) + rank + it
        eng.allreduce(a, op.MAX)
        root = it % world
        obj = eng.broadcast(_blob({"iter": it, "root": root})
                            if rank == root else None, root)
        assert json.loads(obj) == {"iter": it, "root": root}
        b = np.ones(ndata, dtype=np.float64) * (rank + 1)
        eng.allreduce(b, op.SUM)
        acc = acc * 1.000001 + a.astype(np.float64) + b + it
        eng.checkpoint(struct.pack("<II", it + 1, 0) + acc.tobytes())
        assert eng.version_number == it + 1
        if kill_at and it + 1 == kill_at and "killed" not in rec:
            rec["killed"] = True
            barrier.wait(JOIN_SEC)
            _die(eng)
    _put(rec, "final", acc.tobytes())


def _cold_body(world, **kw):
    barrier = threading.Barrier(world)

    def body(eng, kind, trial, rec):
        cold_restart(eng, kind, trial, rec, barrier=barrier, **kw)
    return body


def _fault_free(world=3, **kw):
    recs, lives, errs = _world(("torch",) * world, _cold_body(world, **kw))
    _clean(errs)
    assert lives == [1] * world
    return [r["final"] for r in recs]


def _store_at(root):
    return lambda i: {"rabit_ckpt_dir": str(root)}


@pytest.mark.parametrize("tracker", ["torch", "jax"])
@pytest.mark.parametrize("kinds", list(KINDS))
def test_kill_all_resumes_from_disk(tmp_path, kinds, tracker):
    """Every rank dies right after committing version 2: the relaunched
    world registers (as a relaunch, like the reference's), loads version
    2 from disk — never 0 — and ends bit for bit with the fault-free
    run, in port, reference and mixed worlds under both trackers."""
    want = _fault_free()
    recs, lives, errs = _world(KINDS[kinds], _cold_body(3, kill_at=2),
                               _store_at(tmp_path / "ckpt"), tracker)
    _clean(errs)
    assert lives == [2, 2, 2]
    assert [r["starts"] for r in recs] == [[0, 2]] * 3
    assert [r["relaunched"] for r in recs] == [[False, True]] * 3
    assert [r["final"] for r in recs] == want
    # every rank is a writer at world 3 (1 + rabit_local_replica)
    s = CheckpointStore(str(tmp_path / "ckpt"), rank=0)
    assert sorted({e["writer"] for e in s.scan()}) == [0, 1, 2]
    assert all(e["valid"] for e in s.scan())
    assert s.versions() == [4, 3, 2]


def test_without_a_store_a_kill_all_restarts_at_zero():
    """The same kill-all with no store: nothing survives, the world
    starts again at version 0 (and ends with the same bits, since the
    body is deterministic)."""
    recs, lives, errs = _world(("torch",) * 3, _cold_body(3, kill_at=2))
    _clean(errs)
    assert [r["starts"] for r in recs] == [[0, 0]] * 3


def test_fallback_past_corrupt_newest_blobs(tmp_path):
    """``tests/test_ckpt.py``'s corrupt-newest case: v3 CRC-corrupt on
    writer 0 and truncated on the others; a fresh cold start resumes at
    v2 and ends bit for bit with the fault-free run, in a port world and
    in a mixed one, each on a copy of the corrupted directory."""
    d = tmp_path / "ckpt"
    params = lambda i: {"rabit_ckpt_dir": str(d), "rabit_ckpt_keep": 4}
    _, _, errs = _world(("torch",) * 3, _cold_body(3, niter=3), params)
    _clean(errs)
    v3 = sorted(d.glob("v00000003.*.ckpt"))
    assert len(v3) == 3
    raw = bytearray(v3[0].read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    v3[0].write_bytes(bytes(raw))
    for p in v3[1:]:
        p.write_bytes(p.read_bytes()[:9])
    want = _fault_free(niter=3)
    for kinds in ("port", "mixed"):
        run_dir = tmp_path / kinds
        shutil.copytree(d, run_dir)
        recs, _, errs = _world(
            KINDS[kinds], _cold_body(3, niter=3, expect=2),
            lambda i: {"rabit_ckpt_dir": str(run_dir), "rabit_ckpt_keep": 4})
        _clean(errs)
        assert [r["starts"] for r in recs] == [[2]] * 3
        assert [r["final"] for r in recs] == want


@pytest.mark.parametrize("kinds", ["port", "mixed", "mixed-rev"])
def test_writer_only_disks(tmp_path, kinds):
    """``rabit_ckpt_writers=1`` with a ``{rank}`` directory: only rank
    0's disk holds versions; rank 2 has no store at all.  The kill-all
    world still runs both agreement rounds on every rank and resumes at
    version 2 served by rank 0."""
    root = tmp_path / "{rank}"

    def params(i):
        return ({} if i == 2 else
                {"rabit_ckpt_dir": str(root), "rabit_ckpt_writers": 1})
    recs, lives, errs = _world(KINDS[kinds], _cold_body(3, kill_at=2),
                               params)
    _clean(errs)
    assert [r["starts"] for r in recs] == [[0, 2]] * 3
    assert [r["final"] for r in recs] == _fault_free()
    assert CheckpointStore(str(tmp_path / "0")).versions() == [4, 3, 2]
    assert os.listdir(tmp_path / "1") == []
    assert not (tmp_path / "2").exists()


def _skew_body(eng, kind, trial, rec):
    """``tests/workers/ckpt_skew.py``: in iteration 1 rank 1 plants a
    valid version 9 in its own store, then dies at its kill-point."""
    if eng.rank == 1 and trial == 0:
        real = eng.broadcast

        def broadcast(data, root):
            if eng.version_number == 1:
                STORES[kind].CheckpointStore(
                    eng._ckpt_store.root, rank=1).persist(
                        9, eng.world_size, b"stale-future")
            return real(data, root)
        eng.broadcast = broadcast
    cold_restart(eng, kind, trial, rec, niter=3)


@pytest.mark.parametrize("kinds", ["port", "mixed", "mixed-rev"])
def test_skew_guard_raises_with_both_versions(tmp_path, kinds):
    """A relaunched rank whose own store holds a valid version newer
    than the one the world agreed (1) raises ``CheckpointSkewError``
    with both versions, whichever package serves it."""
    params = lambda i: {"rabit_ckpt_dir": str(tmp_path),
                        "rabit_recover_attempts": 1,
                        "rabit_connect_retries": 0}
    recs, lives, errs = _world(KINDS[kinds], _skew_body, params,
                               mock=[(1, 1, 1, 0)], abort=True)
    err = errs[1]
    kind = KINDS[kinds][1]
    assert type(err) is STORES[kind].CheckpointSkewError, repr(err)
    assert (err.disk_version, err.agreed_version) == (9, 1)
    assert lives[1] == 2 and recs[1]["starts"] == [0]


@pytest.mark.parametrize("kinds", ["port", "ref"])
def test_persist_failure_is_logged_and_the_job_runs(tmp_path, kinds, capfd):
    """Each rank's store directory turns into a file once the rank is
    up: every persist fails with an OSError, which is logged; the job
    finishes with the fault-free bits."""
    root = tmp_path / "{rank}"
    barrier = threading.Barrier(3)

    def body(eng, kind, trial, rec):
        d = eng._ckpt_store.root
        barrier.wait(JOIN_SEC)
        shutil.rmtree(d)
        open(d, "w").close()
        cold_restart(eng, kind, trial, rec)
    recs, lives, errs = _world(KINDS[kinds], body,
                               _store_at(root))
    _clean(errs)
    assert [r["final"] for r in recs] == _fault_free()
    assert capfd.readouterr().err.count(
        "durable checkpoint persist failed") == 12


@pytest.mark.parametrize("case", ["two-deaths", "death-at-checkpoint",
                                  "local-adjacent"])
def test_deaths_with_a_durable_store(tmp_path, case):
    """``test_torch_robust.py``'s death cases with a store on every
    rank: the same lives, starts and bits, the skew guard silent (a
    writer that persisted and died at the barrier is caught up by the
    commit-first rule), and every writer's store valid."""
    body, mock, want = {
        "two-deaths": ("model", [(0, 0, 1, 0), (1, 1, 1, 0)],
                       ([2, 2, 1, 1], [[0, 0], [0, 1], [0], [0]])),
        "death-at-checkpoint": ("model", [(2, 1, SEQ_CHECKPOINT, 0)],
                                ([1, 1, 2, 1], [[0], [0], [0, 2], [0]])),
        "local-adjacent": ("local", [(1, 1, 0, 0), (2, 1, 0, 0)],
                           ([1, 2, 2, 1], [[0], [0, 1], [0, 1], [0]]))}[case]
    assert _scenario(body, 4, mock, ckpt_root=str(tmp_path)) == want
    for world in os.listdir(tmp_path):
        s = CheckpointStore(str(tmp_path / world), rank=0)
        assert s.versions() == [3, 2, 1], world
        assert all(e["valid"] for e in s.scan())
        if body == "local":
            assert set(s.load_latest().locals) <= {0, 1, 2, 3}


# ------------------------------------------------------------- the apps
def _kill_all_at(run, version, world=3):
    """``run`` with every rank killed once all have committed
    ``version``; each life's broadcasts are counted apart."""
    barrier = threading.Barrier(world)
    bcasts = [[] for _ in range(world)]

    def body(eng, kind, trial, rec):
        real_ckpt, real_bcast = eng.checkpoint, eng.broadcast
        life = bcasts[int(eng._task_id)]
        life.append(0)

        def checkpoint(*a, **k):
            real_ckpt(*a, **k)
            if eng.version_number == version and len(life) == 1:
                barrier.wait(JOIN_SEC)
                _die(eng)

        def broadcast(data, root):
            life[-1] += 1
            return real_bcast(data, root)
        eng.checkpoint, eng.broadcast = checkpoint, broadcast
        run(eng, kind, trial, rec)
    return body, bcasts


@pytest.mark.parametrize("kinds", ["port", "mixed"])
def test_kill_all_restores_local_models(tmp_path, kinds):
    """``local_recover``'s (global, local) checkpoints, every rank killed
    after version 2: each relaunched rank gets its own local model back
    from the disk blob (which carries every origin's at world 3) and the
    world ends bit for bit as without the deaths."""
    def run(eng, kind, trial, rec):
        BODIES["local"](eng, kind, trial, rec)
    clean, _, errs = _world(KINDS[kinds], run)
    _clean(errs)
    body, _ = _kill_all_at(run, 2)
    recs, lives, errs = _world(KINDS[kinds], body, _store_at(tmp_path))
    _clean(errs)
    assert lives == [2, 2, 2]
    assert [r.pop("starts") for r in recs] == [[0, 2]] * 3
    assert [r.pop("starts") for r in clean] == [[0]] * 3
    assert recs == clean
    dc = CheckpointStore(str(tmp_path), rank=0).load_version(2)
    assert sorted(dc.locals) == [0, 1, 2]


def _killed_after_first_commit(run, kinds, d):
    body, bcasts = _kill_all_at(run, 1)
    recs, lives, errs = _world(kinds, body, _store_at(d))
    _clean(errs)
    assert lives == [2, 2, 2]
    return recs, bcasts


@pytest.mark.parametrize("which", ["kmeans", "gbdt"])
def test_apps_resume_from_disk_after_a_kill_all(per_thread, tmp_path,
                                                which):
    """``kmeans.run`` (dense tier) and ``boosting.train`` at world 3,
    every rank killed after the first commit: the relaunched lives load
    version 1 from disk (GBDT with its cuts in the model: no broadcast)
    and every result they see, and the model, are bit for bit the port's
    uninterrupted run's; the reference world killed the same way has the
    same lives, counts and splits exact and sums within the JAX tests'
    bar."""
    run = _app(per_thread, which)
    clean, _, errs = _world(("torch",) * 3, run)
    _clean(errs)
    got, bcasts = _killed_after_first_commit(run, KINDS["port"],
                                             tmp_path / "port")
    want, _ = _killed_after_first_commit(run, KINDS["ref"],
                                         tmp_path / "ref")
    for r in range(3):
        assert got[r].get(("relaunched", 0)) is True
        assert _results(got[r]) == _results(clean[r]), r
        assert set(_results(got[r])) == set(_results(want[r])), r
        # k-means seeds its k centroids by broadcast at version 0 only
        assert bcasts[r] == ([KM_K, 0] if which == "kmeans" else [1, 0])
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
    for name in ("port", "ref"):
        s = CheckpointStore(str(tmp_path / name), rank=0)
        assert s.versions() == [3, 2, 1] and all(e["valid"]
                                                 for e in s.scan())


# ---------------------------------------------------- the launcher's CLI
NITER, KILL_AT, NDATA = 4, 2, 100


def _worker(out_dir: str) -> int:
    """A launched rank: ``cold_restart``'s iteration through the port's
    api; every rank's first life SIGKILLs itself once all three have
    committed version ``KILL_AT`` (marker files in ``out_dir``)."""
    import rabit_tpu_torch as rt

    rt.init()
    rank, world = rt.get_rank(), rt.get_world_size()
    version, model = rt.load_checkpoint()
    start, acc = ((model["iter"], model["acc"]) if model is not None
                  else (0, np.zeros(NDATA, np.float64)))
    assert version == start, (version, start)
    relaunch = os.environ["RABIT_RELAUNCH"]
    for it in range(start, NITER):
        a = np.arange(NDATA, dtype=np.float32) + rank + it
        rt.allreduce(a, rt.MAX)
        b = np.ones(NDATA, dtype=np.float64) * (rank + 1)
        rt.allreduce(b, rt.SUM)
        acc = acc * 1.000001 + a.astype(np.float64) + b + it
        rt.checkpoint({"iter": it + 1, "acc": acc})
        if it + 1 == KILL_AT and relaunch == "0":
            open(os.path.join(out_dir, f"killed.{rank}"), "w").close()
            deadline = time.monotonic() + 60
            while (len([n for n in os.listdir(out_dir)
                        if n.startswith("killed.")]) < world
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            os.kill(os.getpid(), signal.SIGKILL)
    with open(os.path.join(out_dir, f"final.{rank}.{relaunch}"), "wb") as f:
        pickle.dump({"start": start, "acc": acc.tobytes(),
                     "relaunched": rt.engine.get_engine().was_relaunched},
                    f)
    rt.finalize()
    return 0


def test_cli_kill_all_resumes_from_the_ckpt_dir(tmp_path):
    """``launch_local --ckpt-dir D --max-restarts 3``: every rank kills
    itself once after committing version 2; the relaunched lives resume
    at version 2 from D and the job ends with rc 0 and the bits of the
    iteration done without a death."""
    out, d = tmp_path / "out", tmp_path / "ckpt"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launch_local",
         "-n", "3", "--ckpt-dir", str(d), "--max-restarts", "3", "--",
         sys.executable, os.path.abspath(__file__), "worker", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("supervisor: worker") == 3
    assert proc.stderr.count("cold-restart: resumed version 2") == 3
    acc = np.zeros(NDATA, np.float64)
    for it in range(NITER):
        acc = (acc * 1.000001 + (np.arange(NDATA, dtype=np.float32)
                                 + 2 + it).astype(np.float64) + 6.0 + it)
    for rank in range(3):
        assert (out / f"killed.{rank}").exists()
        with open(out / f"final.{rank}.1", "rb") as f:
            rec = pickle.load(f)
        assert (rec["start"], rec["relaunched"]) == (KILL_AT, True)
        assert rec["acc"] == acc.tobytes()
    assert sorted(n for n in os.listdir(out) if n.startswith("final")) == [
        "final.0.1", "final.1.1", "final.2.1"]
    s = CheckpointStore(str(d), rank=0)
    assert s.versions() == [4, 3, 2] and all(e["valid"] for e in s.scan())


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        sys.exit(_worker(sys.argv[2]))
