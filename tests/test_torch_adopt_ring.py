"""``rabit_device_impl=pallas_ring`` over an adopted group (adopt and
mixed modes) on the CPU, ranks on threads of this process.

``torch.distributed``'s default group is one a process, so each rank
thread stands in for a process: ``dist.is_initialized``,
``dist.get_rank`` and ``dist.get_world_size`` answer for the calling
thread, and the engine's default group (``_default_group``) is the
thread's own gloo group on one in-process ``HashStore``.  The engine
decides whether the plane holds the ring exactly as on the card, from
the cards the ranks report (``xla.device_identity`` and
``xla.reachable_cards``, set per thread); where it holds, the table is
built on ``_local_card()``, which is the CPU here, so that the table is
``PeerRing``'s CPU mode (shared-memory inboxes, the fold
``ring_fold_one``), as ``tests/test_torch_xla.py::_inject_ring`` builds
it on the engine's group.

Inputs are made from a seed with numpy.  Bars: the ring's results have
the bits of ``ring_fold_one`` on every (op, dtype) the kernel takes, and
of the JAX package's ``ring_allreduce_pallas`` in interpret mode (on the
8-device CPU mesh of ``tests/conftest.py``) on one op of each dtype; a
peer's death raises ``RuntimeError`` within ``RAISE_SEC``; no file is
left behind.  Mixed mode runs on ``tests/test_torch_xla.py``'s harness
(an in-process port tracker and ``pyrobust``).
"""
import datetime
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rabit_tpu_torch.engine import xla
from rabit_tpu_torch.engine.xla import XLAEngine
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.ops import ring_allreduce as rg
from rabit_tpu_torch.parallel import peer_ring
from test_torch_peer_ring import _pallas, _same_bits
from test_torch_xla import ThreadXLA, run_world

WORLD = 3
JOIN_SEC = 30.0
GROUP_SEC = 5                  # the threads' gloo groups' timeout
RAISE_SEC = 20.0               # a peer's death -> RuntimeError bar
GATE = 4096                    # rabit_pallas_min_bytes in these tests
RING = {"rabit_device_impl": "pallas_ring", "rabit_pallas_min_bytes": GATE}
CARD = "cuda:GPU-0"            # the one card every rank reports
OPS = ("SUM", "MAX", "MIN", "PROD")
DTYPES = ("float32", "bfloat16", "int32")
SIZE = 3 * 1024 + 5            # over the gate in every dtype


class Killed(Exception):
    """A rank thread's death."""


_TL = threading.local()


class AdoptXLA(XLAEngine):
    """The engine, whose default group is its thread's gloo group and
    whose card is the CPU."""

    def _default_group(self):
        return _TL.group, "gloo"

    @staticmethod
    def _local_card():
        return torch.device("cpu")


class MixedXLA(ThreadXLA):
    """The tracker harness's engine in mixed mode: the thread's rank is
    its task id, its default group a gloo group made at first use."""

    groups: dict = {}

    def init(self, params):
        _TL.rank = int(params["rabit_task_id"])
        _TL.card, _TL.reach = CARD, [CARD]
        super().init(params)

    def _default_group(self):
        group = xla.new_group(
            dist.PrefixStore("mixed/", self.groups["store"]), _TL.rank,
            WORLD, "gloo", datetime.timedelta(seconds=GROUP_SEC),
            "127.0.0.1")
        self.groups[_TL.rank] = group
        return group, "gloo"

    @staticmethod
    def _local_card():
        return torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads_as_processes(monkeypatch):
    for var in ("RABIT_TRACKER_URI", "RABIT_TRACKER_PORT", "RABIT_TASK_ID",
                "RABIT_DEVICE_IMPL", "RABIT_PALLAS_MIN_BYTES",
                "RABIT_NUM_TRIAL", "RABIT_RELAUNCH", "RABIT_TIMEOUT_SEC",
                "RABIT_MOCK", "RABIT_HEARTBEAT_SEC", "RABIT_CKPT_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: _TL.rank)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: WORLD)
    monkeypatch.setattr(xla, "device_identity", lambda: _TL.card)
    monkeypatch.setattr(xla, "reachable_cards", lambda: list(_TL.reach))


def _close_group(group):
    for name in ("abort", "shutdown"):
        fn = getattr(group, name, None)
        if fn is not None:
            try:
                fn()
                return
            except RuntimeError:
                pass


def adopt_world(body, cards=None, reach=None, params=RING, engine=None):
    """One thread a rank, each with its gloo group as its default group,
    reporting ``cards[r]`` and reaching ``reach[r]`` (default: one card
    that all share).  ``body(adopt, rank, rec)`` runs with ``adopt()``,
    which starts an adopt-mode ``engine`` (:class:`AdoptXLA` by default)
    on the thread's group; the harness
    shuts down every engine it started unless the body raised
    :class:`Killed`.  Returns the records by rank."""
    cards = cards or [CARD] * WORLD
    reach = reach or [[CARD]] * WORLD
    store = dist.HashStore()
    recs, errs = [{} for _ in range(WORLD)], []

    def run(rank):
        _TL.rank, _TL.card, _TL.reach = rank, cards[rank], reach[rank]
        _TL.group = xla.new_group(
            dist.PrefixStore("adopt/", store), rank, WORLD, "gloo",
            datetime.timedelta(seconds=GROUP_SEC), "127.0.0.1")
        engines = []

        def adopt():
            eng = (engine or AdoptXLA)()
            eng.init(dict(params))
            engines.append(eng)
            return eng
        try:
            body(adopt, rank, recs[rank])
            for eng in engines:
                eng.shutdown()
        except Killed:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append((rank, e))
        finally:
            _close_group(_TL.group)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(WORLD)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_SEC
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    assert not any(t.is_alive() for t in threads), "a rank thread hangs"
    if errs:
        raise errs[0][1]
    return recs


def _leftovers():
    """This process's ring files (every table here is tagged with the
    default job)."""
    prefix = "rabit_ring."
    mine = f".{os.getpid()}."
    return [n for n in os.listdir(peer_ring.shm_dir())
            if n.startswith(prefix) and mine in n]


def _inputs(op, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, (WORLD, SIZE)).astype(np.int32)
        return [torch.from_numpy(r.copy()) for r in x]
    x = rng.standard_normal((WORLD, SIZE)).astype(np.float32)
    t = torch.from_numpy(x)
    if op == "PROD":
        t = 1.0 + 0.1 * t
    return [r.to(getattr(torch, dtype)) for r in t]


# --------------------------------------------------- the holding decision
@pytest.mark.parametrize("cards,reach,holds", [
    ([CARD] * 3, [[CARD]] * 3, True),
    ([CARD, "cpu", CARD], [[CARD], [], [CARD]], False),
    (["cuda:a", "cuda:b", "cuda:a"], [["cuda:a", "cuda:b"]] * 3, True),
    (["cuda:a", "cuda:b", "cuda:a"],
     [["cuda:a", "cuda:b"], ["cuda:b"], ["cuda:a", "cuda:b"]], False),
    (["cuda:a", "cuda:b"], [["cuda:a"], ["cuda:b"]], False),
    (["cpu", "cpu"], [[], []], False)])
def test_ring_holds(cards, reach, holds):
    """Every card on CUDA and reached by every rank, else no ring; the
    records are one length whatever they hold."""
    records = [xla.reach_record(c, r) for c, r in zip(cards, reach)]
    assert {len(r) for r in records} == {xla.REACH_BYTES}
    assert xla.ring_holds(records) is holds


def test_ring_holds_refuses_more_ranks_than_the_kernel_takes():
    n = peer_ring.MAX_PEERS + 1
    assert not xla.ring_holds([xla.reach_record(CARD, [CARD])] * n)
    assert xla.ring_holds([xla.reach_record(CARD, [CARD])] * (n - 1))


@pytest.mark.parametrize("case", ["one card", "a rank on the cpu",
                                  "a card one rank cannot reach"])
def test_holding_decision_is_the_same_on_every_rank(case):
    """The decision over ``_exchange_bytes`` (one allgather on the
    adopted group): every rank builds a table, or none does, and a rank
    on the CPU or an unreachable card keeps every rank on the group."""
    cards, reach = {
        "one card": ([CARD] * 3, [[CARD]] * 3),
        "a rank on the cpu": ([CARD, CARD, "cpu"], [[CARD], [CARD], []]),
        "a card one rank cannot reach": (
            ["cuda:a", "cuda:a", "cuda:b"],
            [["cuda:a", "cuda:b"], ["cuda:a"], ["cuda:a", "cuda:b"]]),
    }[case]

    def body(adopt, rank, rec):
        eng = adopt()
        rec["table"] = eng._ring is not None
        out = eng.allreduce(torch.full((2048,), rank + 1.0), ReduceOp.SUM)
        rec["sum"] = float(out[0])
        rec["seq"] = eng._ring.seq if eng._ring is not None else 0

    recs = adopt_world(body, cards, reach)
    want = case == "one card"
    for rec in recs:
        assert rec["table"] is want and rec["sum"] == 6.0
        assert rec["seq"] == int(want)
    assert _leftovers() == []


class GroupXLA(XLAEngine):
    """The engine whose default group is its thread's gloo group, and
    whose card is the real ``_local_card``."""

    def _default_group(self):
        return _TL.group, "gloo"


def test_a_rank_without_cuda_keeps_every_rank_on_the_group(monkeypatch):
    """Ranks 0 and 1 report a card; rank 2 is a process without CUDA
    (``torch.cuda.is_available()`` False, ``current_device`` raising),
    its identity from the real ``device_identity``.  No rank asks for
    its card before the holding rule: every rank's ``init`` returns, none
    builds a table, and every allreduce stays on the group."""
    real_identity = xla.device_identity
    probed = []

    def current_device():
        if _TL.card is None:
            raise AssertionError("Torch not compiled with CUDA enabled")
        raise AssertionError("the card was asked for: the ring cannot hold")
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: _TL.card is not None)
    monkeypatch.setattr(torch.cuda, "current_device", current_device)
    monkeypatch.setattr(xla, "device_identity", lambda: (
        _TL.card if _TL.card is not None else real_identity()))
    monkeypatch.setattr(peer_ring, "probe", lambda: probed.append(_TL.rank))

    def body(adopt, rank, rec):
        eng = adopt()
        rec["table"] = eng._ring is not None
        rec["sum"] = float(eng.allreduce(torch.full((2048,), rank + 1.0),
                                         ReduceOp.SUM)[0])
        rec["stats"] = dict(eng.path_stats)

    recs = adopt_world(body, [CARD, CARD, None], [[CARD], [CARD], []],
                       engine=GroupXLA)
    assert sorted(probed) == [0, 1]
    for rec in recs:
        assert not rec["table"] and rec["sum"] == 6.0
        assert rec["stats"] == {"device_ops": 1, "host_ops": 0,
                                "backend": "gloo"}
    assert _leftovers() == []


# ----------------------------------------------------- the ring's bits
@pytest.fixture(scope="module")
def ring_results():
    """One adopt-mode world that runs every (op, dtype) the kernel takes
    over the gate, in turn on one table; each rank's results, inputs and
    the path counters."""
    xs = {(op, dt): _inputs(op, dt, seed=31 * OPS.index(op) + len(dt))
          for op in OPS for dt in DTYPES}
    mp = pytest.MonkeyPatch()
    try:
        for var in ("RABIT_DEVICE_IMPL", "RABIT_PALLAS_MIN_BYTES"):
            mp.delenv(var, raising=False)
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_rank", lambda *a, **k: _TL.rank)
        mp.setattr(dist, "get_world_size", lambda *a, **k: WORLD)
        mp.setattr(xla, "device_identity", lambda: _TL.card)
        mp.setattr(xla, "reachable_cards", lambda: list(_TL.reach))

        def body(adopt, rank, rec):
            eng = adopt()
            for key, inputs in xs.items():
                before = inputs[rank].clone()
                rec[key] = eng.allreduce(inputs[rank], ReduceOp[key[0]])
                assert torch.equal(inputs[rank].view(torch.uint8),
                                   before.view(torch.uint8))
            rec["seq"] = eng._ring.seq
            rec["stats"] = dict(eng.path_stats)
        recs = adopt_world(body)
    finally:
        mp.undo()
    return xs, recs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_large_ops_have_the_ring_fold_bits(ring_results, op, dtype):
    """Every rank's result of an allreduce over the gate is
    ``ring_fold_one``'s over the three inputs, bit for bit, and every
    such op rode the ring (one table op each)."""
    xs, recs = ring_results
    want = rg.ring_fold_one(xs[(op, dtype)], ReduceOp[op])
    _same_bits([rec[(op, dtype)] for rec in recs], [want] * WORLD)
    for rec in recs:
        assert rec["seq"] == len(OPS) * len(DTYPES)
        assert rec["stats"] == {"device_ops": len(OPS) * len(DTYPES),
                                "host_ops": 0, "backend": "gloo"}


@pytest.mark.parametrize("op,dtype", [("SUM", "float32"),
                                      ("MAX", "bfloat16"),
                                      ("PROD", "int32")])
def test_large_ops_have_the_pallas_bits(ring_results, op, dtype):
    """... and the JAX package's ``ring_allreduce_pallas`` in interpret
    mode on the same inputs."""
    xs, recs = ring_results
    _same_bits([rec[(op, dtype)] for rec in recs], _pallas(xs[(op, dtype)],
                                                           op))


def test_small_ops_allgather_and_float64_stay_on_the_group():
    """Under the gate, an allgather, float64, a bitwise op and an int64
    payload ride the group, not the table."""
    def body(adopt, rank, rec):
        eng = adopt()
        out = [eng.allreduce(torch.full((16,), rank + 1.0), ReduceOp.SUM),
               eng.allreduce(torch.full((2048,), rank + 1.0,
                                        dtype=torch.float64), ReduceOp.SUM),
               eng.allreduce(torch.full((2048,), rank + 1,
                                        dtype=torch.int32), ReduceOp.BITOR),
               eng.allreduce(torch.full((2048,), rank + 1,
                                        dtype=torch.int64), ReduceOp.MAX),
               eng.allgather(torch.full((2048,), float(rank)))]
        rec["vals"] = [t.flatten()[[0, -1]].tolist() for t in out]
        rec["seq"], rec["stats"] = eng._ring.seq, dict(eng.path_stats)

    for rec in adopt_world(body):
        assert rec["vals"] == [[6.0, 6.0], [6.0, 6.0], [3, 3], [3, 3],
                               [0.0, 2.0]]
        assert rec["seq"] == 0
        assert rec["stats"] == {"device_ops": 5, "host_ops": 0,
                                "backend": "gloo"}


@pytest.mark.parametrize("dtype,on_ring", [(np.float32, True),
                                           (np.int32, True),
                                           (np.float64, False)])
def test_numpy_payload_over_the_gate(dtype, on_ring):
    """Adopt mode's numpy allreduce: a payload of a ring dtype over the
    gate goes through the table and comes back in place, with the ring's
    bits; float64 (the linear learner's gradient) stays on the group."""
    xs = [np.random.default_rng([7, r]).integers(-50, 50, 4096).astype(dtype)
          for r in range(WORLD)]

    def body(adopt, rank, rec):
        eng = adopt()
        buf = xs[rank].copy()
        out = eng.allreduce(buf, ReduceOp.SUM)
        rec["same"] = out is buf
        rec["buf"], rec["seq"] = buf, eng._ring.seq

    recs = adopt_world(body)
    want = rg.ring_fold_one([torch.from_numpy(x) for x in xs],
                            ReduceOp.SUM).numpy()
    for rec in recs:
        assert rec["same"] and rec["seq"] == int(on_ring)
        np.testing.assert_array_equal(rec["buf"], want)


# ----------------------------------------------------------- faults
def test_adopt_mode_death_raises_runtime_error():
    """Rank 1 dies entering a ring op (it leaves the table and its group
    closes): both survivors' op raises the documented RuntimeError
    within RAISE_SEC, never a hang or a degrade, and shutdown still
    leaves no file."""
    def body(adopt, rank, rec):
        eng = adopt()
        eng.allreduce(torch.ones(2048), ReduceOp.SUM)
        if rank == 1:
            eng._ring.close()
            _close_group(_TL.group)
            raise Killed()
        t = time.monotonic()
        with pytest.raises(RuntimeError, match="no host transport") as e:
            eng.allreduce(torch.full((2048,), 2.0), ReduceOp.SUM)
        rec["raise_s"] = time.monotonic() - t
        rec["cause"] = type(e.value.__cause__).__name__
        rec["degraded"] = eng._degraded

    recs = adopt_world(body)
    for r in (0, 2):
        assert recs[r]["raise_s"] < RAISE_SEC
        assert recs[r]["cause"] == "PeerError" and not recs[r]["degraded"]
    assert _leftovers() == []


def test_failed_table_degrades_mixed_mode_for_the_job():
    """Mixed mode: rank 2 comes to a ring op after the others' deadline,
    every rank degrades to the host engine, and the table is never
    rebuilt: after a checkpoint a large op still rides the host."""
    MixedXLA.groups = {"store": dist.HashStore()}

    def body(eng, trial, rec):
        assert eng._adopted and eng._ring is not None
        eng._ring.timeout = 1.0
        assert eng.allreduce(torch.ones(2048), ReduceOp.SUM)[0] == 3.0
        if eng.rank == 2:
            time.sleep(1.5)
        out = eng.allreduce(torch.full((2048,), eng.rank + 1.0),
                            ReduceOp.SUM)
        eng.checkpoint({"v": 1})
        again = eng.allreduce(torch.full((2048,), 1.0), ReduceOp.SUM)
        rec.update(out=float(out[0]), again=float(again[0]),
                   ring=eng._ring, degraded=eng._degraded,
                   stats=dict(eng.path_stats), epoch=eng.device_epoch)

    try:
        recs, lives = run_world(WORLD, body, params=RING, engine=MixedXLA)
    finally:
        for key, group in MixedXLA.groups.items():
            if key != "store":
                _close_group(group)
    assert lives == [1] * WORLD
    for rec in recs:
        assert (rec["out"], rec["again"]) == (6.0, 3.0)
        assert rec["ring"] is None and rec["degraded"] and rec["epoch"] == 0
        assert rec["stats"] == {"device_ops": 1, "host_ops": 2,
                                "backend": "gloo"}
    assert _leftovers() == []


def test_mixed_mode_holds_the_ring_and_shuts_down_clean():
    """Mixed mode at start: the table is built over the external group
    once the consensus found the ranks aligned; large tensors ride it,
    numpy payloads the host engine; shutdown frees everything."""
    MixedXLA.groups = {"store": dist.HashStore()}
    xs = _inputs("SUM", "float32", seed=5)

    def body(eng, trial, rec):
        rec["table"] = eng._ring is not None and not eng._degraded
        rec["out"] = eng.allreduce(xs[eng.rank], ReduceOp.SUM)
        a = np.full(4096, eng.rank + 1.0, np.float32)
        eng.allreduce(a, ReduceOp.SUM)
        rec["np"], rec["seq"] = float(a[0]), eng._ring.seq
        rec["ring"] = eng._ring

    try:
        recs, _ = run_world(WORLD, body, params=RING, engine=MixedXLA)
    finally:
        for key, group in MixedXLA.groups.items():
            if key != "store":
                _close_group(group)
    want = rg.ring_fold_one(xs, ReduceOp.SUM)
    for rec in recs:
        assert rec["table"] and rec["seq"] == 1 and rec["np"] == 6.0
        _same_bits([rec["out"]], [want])
        assert rec["ring"].files() == [] and rec["ring"].open_handles() == 0
    assert _leftovers() == []


# --------------------------------------------------------- teardown
def test_shutdown_and_a_second_adopt_leave_nothing(monkeypatch):
    """An engine adopted, used and shut down, then adopted again on the
    same group (as after ``finalize``): each shutdown closes the peers'
    handles, passes the group's barrier and frees every inbox, and no
    file or handle is left."""
    freed = []
    real = peer_ring.free_inboxes

    def free_inboxes(orphans):
        freed.append(len(orphans))
        real(orphans)
    monkeypatch.setattr(peer_ring, "free_inboxes", free_inboxes)

    def body(adopt, rank, rec):
        tables = []
        for life in range(2):
            eng = adopt()
            tables.append(eng._ring)
            eng.allreduce(torch.full((2048,), life + 1.0), ReduceOp.SUM)
            eng.shutdown()
            rec[life] = (eng._ring, eng.group, list(eng._ring_orphans))
        rec["tables"] = [(t.files(), t.open_handles()) for t in tables]
        rec["pages"] = {t._barrier is None for t in tables}

    recs = adopt_world(body)
    for rec in recs:
        assert rec[0] == rec[1] == (None, None, [])
        assert rec["tables"] == [([], 0), ([], 0)] and rec["pages"] == {True}
    assert freed and _leftovers() == []


def test_two_adopt_jobs_never_share_a_page():
    """Two tables of one tag (two adopt-mode jobs on one host, both
    device epoch 0) name their files after their own pid and a random
    token, so no page is shared."""
    def one():
        return peer_ring.PeerRing(0, 2, lambda rec: [rec, rec], "cpu", 1.0,
                                  tag="default.e0")
    a, b = one(), one()
    try:
        assert a._prefix != b._prefix
        assert a._barrier.path != b._barrier.path
        assert str(os.getpid()) in a._prefix
    finally:
        a.close()
        b.close()


def test_a_failing_probe_raises_from_init(monkeypatch):
    """On a rank with a card, a ring library that does not load (or IPC
    the host refuses) raises from adopt mode's ``init`` before any group
    op, never a degraded start."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def probe():
        raise OSError("libring_allreduce.so: cannot open shared object")
    monkeypatch.setattr(peer_ring, "probe", probe)
    _TL.rank = 0

    class NoGroup(AdoptXLA):
        def _default_group(self):
            raise AssertionError("the probe came after a group op")
    with pytest.raises(OSError, match="cannot open"):
        NoGroup().init(dict(RING))
    # psum never probes
    with pytest.raises(AssertionError, match="after a group op"):
        NoGroup().init({})
