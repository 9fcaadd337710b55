"""Elastic membership and the tracker's journal, the port against rabit_tpu.

The reference's own contract (``tests/test_elastic.py``,
``tests/workers/elastic_worker.py``) held on the port, in one process:
``splitrows`` bit for bit; the tracker's elastic rounds (joiners,
scale-downs from a heartbeat EOF, a lost registrant or the launcher's
``note_dead``, the ``epoch`` poll, ``rescale`` rounds) under the port's
tracker and the reference's given the same stimulus on loopback
sockets; each tracker restoring the other's journal; the engine's
epoch poll bytes, its ``WorldChangedError`` and async drain; and
worlds of rank threads that shrink from 3 to 2 and grow back to 3 at
commit boundaries, in port, reference and mixed worlds under both
trackers, whose final bits must be those the world history dictates.
k-means and GBDT run through a scale-down within the JAX tests' bar of
a fixed-world run over the same rows.  One launched job (the file is
its own worker) drives the launcher's elastic leave.
"""
import json
import os
import random
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import rabit_tpu
from rabit_tpu.engine import pysocket as jpysocket
from rabit_tpu.engine.robust import PyRobustEngine as JRobust
from rabit_tpu.learn import boosting as jgb
from rabit_tpu.learn import kmeans as jkm
from rabit_tpu.learn import splitrows as jsplit
from rabit_tpu.learn.data import SparseMat as JSparseMat
from rabit_tpu.tracker import tracker as jtracker_mod
import rabit_tpu_torch
from rabit_tpu_torch import ckpt
from rabit_tpu_torch.engine import pysocket as tpysocket
from rabit_tpu_torch.engine.robust import K_RESCALE, PyRobustEngine
from rabit_tpu_torch.learn import boosting as gb
from rabit_tpu_torch.learn import kmeans as km
from rabit_tpu_torch.learn import splitrows
from rabit_tpu_torch.learn.data import SparseMat
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker import tracker as tracker_mod
from rabit_tpu_torch.transport import LinkError
from test_torch_liveness import _Buf
from test_torch_pysocket_learn import (GB_DEPTH, GB_NBIN, KM_K, gbdt_shard,
                                       kmeans_shard)
from test_torch_robust import (ENGINES, OPCODES, _env,  # noqa: F401
                               _Killed, _mock)
from test_torch_robust import per_thread  # noqa: F401 — fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("torch", "jax")
MODS = {"torch": tracker_mod, "jax": jtracker_mod}
SPLIT = {"torch": splitrows, "jax": jsplit}
WCE = {"torch": tpysocket.WorldChangedError,
       "jax": jpysocket.WorldChangedError}
WAIT_SEC = 10.0
JOIN_SEC = 60.0
F32_TOL = dict(rtol=1e-4, atol=1e-3)
NDATA, NITER = 400, 6


# --------------------------------------------------------------- splitrows
@pytest.mark.parametrize("n_rows", [0, 1, 7, 101, 400])
def test_splitrows_matches_reference_4_6_3(n_rows):
    """The shards of the 4 -> 6 -> 3 history, the port's against the
    reference's, and each an exact partition read back rank by rank."""
    for k in (4, 6, 3):
        shards = splitrows.shard_indices(n_rows, k)
        assert shards == jsplit.shard_indices(n_rows, k)
        assert sorted(i for s in shards for i in s) == list(range(n_rows))
        for rank in range(k):
            assert splitrows.rows_for_rank(n_rows, rank, k) == shards[rank]


@pytest.mark.parametrize("seed", [0, 10, 12345])
def test_assignment_stream_matches_reference(seed):
    """``random.Random(seed).randint`` draw for draw, for uneven worlds."""
    for k in (1, 2, 3, 5, 7):
        port = splitrows.assignment_stream(k, seed)
        ref = jsplit.assignment_stream(k, seed)
        assert [next(port) for _ in range(500)] == \
            [next(ref) for _ in range(500)]


def test_file_split_matches_reference_and_stream(tmp_path):
    """``split()`` writes the reference's shard files byte for byte, and
    they hold the rows ``shard_indices`` names."""
    rows = [f"{i} 1:{i}\n" for i in range(57)]
    fin = tmp_path / "data.libsvm"
    fin.write_text("".join(rows))
    names = splitrows.split(str(fin), str(tmp_path / "port"), 5)
    ref = jsplit.split(str(fin), str(tmp_path / "ref"), 5)
    shards = splitrows.shard_indices(57, 5)
    for k, (name, rname) in enumerate(zip(names, ref)):
        assert name.endswith(f".row{k}")
        assert open(name).read() == open(rname).read() == \
            "".join(rows[i] for i in shards[k])


def test_splitrows_cli(tmp_path):
    fin = tmp_path / "d.libsvm"
    fin.write_text("".join(f"{i} 1:1\n" for i in range(10)))
    assert splitrows.main(["x", str(fin), str(tmp_path / "o"), "3"]) == 0
    got = [open(tmp_path / f"o.row{k}").read().count("\n") for k in range(3)]
    assert got == [len(s) for s in splitrows.shard_indices(10, 3)]
    assert splitrows.main(["x"]) == 0           # usage, nothing written


# ----------------------------------------------------- WorldChangedError
def test_world_changed_error_contract():
    """The typed errors ride the top-level API as the reference's do,
    with the same coordinates and message."""
    e = rabit_tpu_torch.WorldChangedError(4, 6, 2)
    assert (e.old_world, e.new_world, e.epoch) == (4, 6, 2)
    assert str(e) == str(rabit_tpu.WorldChangedError(4, 6, 2))
    assert isinstance(e, rabit_tpu_torch.RabitError)
    assert issubclass(rabit_tpu_torch.TrackerLostError, LinkError)
    assert {"WorldChangedError", "TrackerLostError"} <= set(
        rabit_tpu_torch.__all__)
    assert K_RESCALE == 256


# ------------------------------------------------------ tracker helpers
def _start(pkg, world, **kw):
    t = MODS[pkg].Tracker(world, "127.0.0.1", 0, **kw)
    t.start()
    return t


def _stop(t):
    """The reference's stop() does not wake a blocked accept(), so the
    listener is shut down first."""
    try:
        t._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    t.stop()
    if t._thread is not None:
        t.join(5)


def _register(t, task, cmd, job=P.DEFAULT_JOB, world=0):
    """One rendezvous registration; the caller reads the reply once the
    round completes."""
    s = socket.create_connection(("127.0.0.1", t.port), timeout=30)
    P.send_hello(s, cmd, task, world, job=job)
    P.send_str(s, "127.0.0.1")
    P.send_u32(s, 12345)
    return s


def _replies(socks):
    out = {}
    for task, s in socks.items():
        out[task] = P.TopologyReply.recv(s)
        s.close()
    return out


def _round(t, cmds, job=P.DEFAULT_JOB, world=0):
    """One full round; returns once the tracker has recorded its
    members (the reference's round records them after the last reply,
    and a death reported before that is not a member's)."""
    out = _replies({task: _register(t, task, cmd, job, world)
                    for task, cmd in cmds.items()})
    assert _wait(lambda: _job(t, job)._members == set(cmds))
    return out


def _poll(t, task="poll", version=0, job=P.DEFAULT_JOB):
    s = socket.create_connection(("127.0.0.1", t.port), timeout=30)
    try:
        P.send_hello(s, P.CMD_EPOCH, task, 0, job=job)
        P.send_u32(s, version)
        return P.recv_u32(s), P.recv_u32(s), P.recv_u32(s)
    finally:
        s.close()


def _wait(pred, sec=WAIT_SEC):
    end = time.monotonic() + sec
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _job(t, job=P.DEFAULT_JOB):
    return t._default_job() if job == P.DEFAULT_JOB else t._jobs[job]


def _flushed(t, job=P.DEFAULT_JOB):
    """The newest in-memory state reached the disk (journal writes run
    on handler threads after the mutation is visible)."""
    j = _job(t, job)
    return (j._state_store.newest_version() or 0) >= j._state_seq


def _ordered(t, task):
    """Index of the task's "lost" liveness event and of the first
    pending epoch on the job's timeline."""
    evs = list(_job(t)._events)
    lost = next(i for i, e in enumerate(evs) if e.get("name") == "liveness"
                and e.get("phase") == "lost" and e.get("task") == task)
    pend = next(i for i, e in enumerate(evs) if e.get("name") == "epoch"
                and e.get("phase") == "pending")
    return lost, pend


def _pair(scenario):
    """``scenario(pkg)`` under the port's tracker and the reference's;
    both must give the same summary."""
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"], got
    return got["torch"]


# ------------------------------------------------ tracker: elastic rounds
def test_epoch_poll_and_joiner_admission():
    """The poll reports (epoch, target_epoch, target_world) and records
    the committed version; a parked joiner flips the target, and the
    rescale round admits it with the epoch bumped, the survivors'
    ranks kept and the joiner compacted onto the end."""
    def scenario(pkg):
        t = _start(pkg, 2, max_workers=4)
        joiner = None
        try:
            r1 = _round(t, {"0": P.CMD_START, "1": P.CMD_START})
            first = sorted((r.world, r.epoch) for r in r1.values())
            polled = _poll(t, version=3)
            committed = t.committed_version
            joiner = _register(t, "9", P.CMD_START)
            assert _wait(lambda: _poll(t)[1:] == (1, 3))
            socks = {tid: _register(t, tid, P.CMD_RESCALE)
                     for tid in ("0", "1")}
            socks["9"] = joiner
            r2 = _replies(socks)
            return (first, polled, committed,
                    {tid: (r.rank, r.world, r.epoch, r.relaunched)
                     for tid, r in r2.items()},
                    _poll(t), t.epoch)
        finally:
            _stop(t)
            if joiner is not None:
                joiner.close()
    assert _pair(scenario) == (
        [(2, 0), (2, 0)], (0, 0, 2), 3,
        {"0": (0, 3, 1, 0), "1": (1, 3, 1, 0), "9": (2, 3, 1, 0)},
        (1, 1, 3), 1)


@pytest.mark.parametrize("signal_", ["heartbeat", "note_dead", "registrant"])
def test_death_scales_down_liveness_first(signal_):
    """A death seen as a heartbeat EOF, the launcher's ``note_dead`` or
    a registrant lost while parked turns into a pending scale-down,
    the liveness loss on the timeline before the epoch move; the
    survivors' round lands at world 2, epoch 1, old ranks compacted."""
    def scenario(pkg):
        t = _start(pkg, 3, min_workers=2, heartbeat_miss=5.0)
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START,
                       "2": P.CMD_START})
            if signal_ == "heartbeat":
                hb = socket.create_connection(("127.0.0.1", t.port), 30)
                P.send_hello(hb, P.CMD_HEARTBEAT, "1", 0)
                P.send_u32(hb, 50)
                P.send_u32(hb, 1)
                hb.close()             # EOF without the bye == death
            elif signal_ == "note_dead":
                t.note_dead("1")
            else:
                _register(t, "1", P.CMD_RECOVER).close()
            assert _wait(lambda: _poll(t)[1:] == (1, 2))
            lost, pend = _ordered(t, "1")
            r2 = _round(t, {"0": P.CMD_RESCALE, "2": P.CMD_RESCALE})
            # the round records its members after the last reply
            assert _wait(lambda: "1" not in _job(t)._members)
            return (lost < pend,
                    {tid: (r.rank, r.world, r.epoch)
                     for tid, r in r2.items()},
                    sorted(_job(t)._members), sorted(_job(t)._dead_tasks))
        finally:
            _stop(t)
    assert _pair(scenario) == (
        True, {"0": (0, 2, 1), "2": (1, 2, 1)}, ["0", "2"], [])


def test_death_reported_while_the_round_replies(monkeypatch):
    """The port's tracker: a death reported between the round's last
    reply and the end of its bookkeeping (the launcher saw the worker
    exit as soon as it held its topology) still moves the target, so
    the survivors' rescale lands at world 2."""
    real_send = P.TopologyReply.send
    sent = []

    def send(reply, sock):
        real_send(reply, sock)
        sent.append(reply.rank)
        if len(sent) == 3:
            t.note_dead("1")
    monkeypatch.setattr(P.TopologyReply, "send", send)
    t = _start("torch", 3, min_workers=2)
    try:
        _round(t, {"0": P.CMD_START, "1": P.CMD_START, "2": P.CMD_START})
        assert _poll(t)[1:] == (1, 2)
        r2 = _round(t, {"0": P.CMD_RESCALE, "2": P.CMD_RESCALE})
        assert {tid: (r.rank, r.world, r.epoch) for tid, r in r2.items()} \
            == {"0": (0, 2, 1), "2": (1, 2, 1)}
        lost, pend = _ordered(t, "1")
        assert lost < pend
    finally:
        _stop(t)


def test_death_completes_a_parked_recover_round():
    """The survivors already wait in a recover round for a world of 3
    when the death is reported: the smaller target completes it as the
    rescale, and the liveness loss precedes the epoch on the timeline."""
    def scenario(pkg):
        t = _start(pkg, 3, min_workers=2)
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START,
                       "2": P.CMD_START})
            socks = {tid: _register(t, tid, P.CMD_RECOVER)
                     for tid in ("1", "2")}
            assert _wait(lambda: len(_job(t)._pending) == 2)
            t.note_dead("0")
            r = _replies(socks)
            return ({tid: (x.rank, x.world, x.epoch) for tid, x in r.items()},
                    _ordered(t, "0")[0] < _ordered(t, "0")[1])
        finally:
            _stop(t)
    assert _pair(scenario) == ({"1": (0, 2, 1), "2": (1, 2, 1)}, True)


@pytest.mark.parametrize("case", ["floor", "not-elastic", "unknown-job"])
def test_deaths_that_move_no_target(case):
    """Below ``min_workers``, without elastic membership, or reported
    for a job the tracker does not know, a death moves no target: the
    poll says "no change" (all zeros for the unknown job), the epoch
    stays, and only a known job records the loss."""
    def scenario(pkg):
        kw = {"floor": {"min_workers": 3}, "not-elastic": {},
              "unknown-job": {"min_workers": 2}}[case]
        t = _start(pkg, 3, **kw)
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START,
                       "2": P.CMD_START})
            t.note_dead("2", job="nope" if case == "unknown-job" else None)
            time.sleep(0.1)
            return (_poll(t), _poll(t, job="nope"), _job(t)._target_world,
                    t.epoch, sorted(_job(t)._lost_tasks))
        finally:
            _stop(t)
    lost = [] if case == "unknown-job" else ["2"]
    assert _pair(scenario) == ((0, 0, 3), (0, 0, 0), None, 0, lost)


def test_a_joiner_beyond_max_workers_stays_parked():
    """At ``max_workers`` a further joiner parks outside the target: no
    epoch is pending and the poll says "no change"."""
    def scenario(pkg):
        t = _start(pkg, 2, max_workers=3)
        late = None
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START})
            socks = {"a": _register(t, "a", P.CMD_START)}
            assert _wait(lambda: _poll(t)[1:] == (1, 3))
            socks.update({tid: _register(t, tid, P.CMD_RESCALE)
                          for tid in ("0", "1")})
            r = _replies(socks)
            late = _register(t, "b", P.CMD_START)
            assert _wait(lambda: "b" in _job(t)._joiners)
            time.sleep(0.1)
            return ({tid: (x.rank, x.world, x.epoch) for tid, x in r.items()},
                    [reg.task_id for reg in _job(t)._pending],
                    _job(t)._target_world, _poll(t))
        finally:
            _stop(t)
            if late is not None:
                late.close()
    assert _pair(scenario) == (
        {"0": (0, 3, 1), "1": (1, 3, 1), "a": (2, 3, 1)}, ["b"], None,
        (1, 1, 3))


def test_a_joiner_that_dies_while_parked_gives_up_its_slot():
    """The registrant sweep drops the dead joiner, and with it the
    pending grow."""
    def scenario(pkg):
        t = _start(pkg, 2, max_workers=3)
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START})
            s = _register(t, "j", P.CMD_START)
            assert _wait(lambda: _poll(t)[1:] == (1, 3))
            s.close()
            assert _wait(lambda: _poll(t)[1:] == (0, 2))
            return sorted(_job(t)._joiners), _job(t)._target_world
        finally:
            _stop(t)
    assert _pair(scenario) == ([], None)


def test_a_presumed_dead_member_that_registers_is_counted_back_in():
    """A relaunch that beats the scale-down: its registration clears
    the dead verdict, the target goes, and the round is a plain one at
    the old world and epoch."""
    def scenario(pkg):
        t = _start(pkg, 3, min_workers=2)
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START,
                       "2": P.CMD_START})
            t.note_dead("2")
            assert _wait(lambda: _poll(t)[1:] == (1, 2))
            r = _round(t, {"2": P.CMD_START, "0": P.CMD_RECOVER,
                           "1": P.CMD_RECOVER})
            return ({tid: (x.rank, x.world, x.epoch, x.relaunched)
                     for tid, x in r.items()},
                    sorted(_job(t)._dead_tasks), _poll(t))
        finally:
            _stop(t)
    assert _pair(scenario) == (
        {"0": (0, 3, 0, 0), "1": (1, 3, 0, 0), "2": (2, 3, 0, 1)}, [],
        (0, 0, 3))


def test_a_shrunk_job_finishes_on_its_survivors_goodbyes():
    """After the scale-down the job is done when the CURRENT members
    say goodbye; the leaver owes none."""
    def scenario(pkg):
        t = _start(pkg, 3, min_workers=2)
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START,
                       "2": P.CMD_START})
            t.note_dead("1")
            _round(t, {"0": P.CMD_RESCALE, "2": P.CMD_RESCALE})
            for tid in ("0", "2"):
                s = socket.create_connection(("127.0.0.1", t.port), 30)
                P.send_hello(s, P.CMD_SHUTDOWN, tid, 0)
                s.close()
            assert _wait(lambda: _job(t).done)
            t.join(5)
            return _job(t).job_done(), t._thread.is_alive()
        finally:
            _stop(t)
    assert _pair(scenario) == (True, False)


# -------------------------------------- tracker: the round's pure parts
def _bare_job(pkg, world, **knobs):
    cfg = types.SimpleNamespace(_elastic=bool(knobs), **knobs)
    return MODS[pkg].JobState(cfg, "j", world)


@pytest.mark.parametrize("seed", range(4))
def test_rescale_rank_assignment_matches_reference(seed):
    """Survivors keep their old-rank order, joiners follow sorted by
    task_id, the rank space is exactly [0, world) — the same map from
    both trackers over random memberships."""
    rng = random.Random(seed)
    for _ in range(40):
        olds = rng.sample([str(i) for i in range(12)], rng.randint(1, 8))
        rank_of = dict(zip(olds, rng.sample(range(len(olds)), len(olds))))
        keep = rng.sample(olds, rng.randint(1, len(olds)))
        new = [f"j{rng.randint(0, 99)}" for _ in range(rng.randint(0, 4))]
        regs = [types.SimpleNamespace(task_id=t)
                for t in rng.sample(keep + sorted(set(new)),
                                    len(keep) + len(set(new)))]
        got = {}
        for pkg in PKGS:
            job = _bare_job(pkg, 3)
            job._rank_of = dict(rank_of)
            job._assign_ranks_rescale(regs, len(regs))
            got[pkg] = job._rank_of
        assert got["torch"] == got["jax"]
        assert sorted(got["torch"].values()) == list(range(len(regs)))
        kept = sorted(keep, key=rank_of.get)
        assert [got["torch"][t] for t in kept] == list(range(len(kept)))


@pytest.mark.parametrize("seed", range(4))
def test_round_selection_matches_reference(seed):
    """With more parked than the round admits, members and ranked tasks
    go first, then joiners by task_id: the same choice and extras from
    both trackers."""
    rng = random.Random(100 + seed)
    for _ in range(40):
        members = {str(i) for i in range(rng.randint(0, 4))}
        parked = list(members) + [f"j{i}" for i in rng.sample(range(9),
                                                              rng.randint(0, 5))]
        rng.shuffle(parked)
        world = rng.randint(1, len(parked) + 1)
        got = {}
        for pkg in PKGS:
            job = _bare_job(pkg, world)
            job._members = set(members)
            job._rank_of = {t: i for i, t in enumerate(sorted(members))}
            job._pending = [types.SimpleNamespace(task_id=t) for t in parked]
            chosen, extras = job._select_round_locked(world)
            got[pkg] = ([r.task_id for r in chosen],
                        [r.task_id for r in extras])
        assert got["torch"] == got["jax"]


@pytest.mark.parametrize("seed", range(4))
def test_target_rules_match_reference(seed):
    """``_recompute_target`` over random memberships, deaths, joiners,
    floors and ceilings: the same pending target from both trackers."""
    rng = random.Random(200 + seed)
    for _ in range(60):
        n = rng.randint(1, 6)
        members = {str(i) for i in range(n)}
        dead = set(rng.sample(sorted(members), rng.randint(0, n)))
        joiners = {f"j{i}" for i in rng.sample(range(5), rng.randint(0, 3))}
        knobs = {"_min_workers": rng.choice([None, 1, 2, 3]),
                 "_max_workers": rng.choice([None, 2, 4, 8])}
        got = {}
        for pkg in PKGS:
            job = _bare_job(pkg, n, **knobs)
            job._members, job._dead_tasks = set(members), set(dead)
            job._joiners = set(joiners)
            job._recompute_target()
            got[pkg] = (job._target_world,
                        [e["to_world"] for e in job._events])
        assert got["torch"] == got["jax"], (knobs, members, dead, joiners)


# -------------------------------------------------------------- journal
def _journal_state(t, job=P.DEFAULT_JOB):
    dc = _job(t, job)._state_store.load_latest()
    return json.loads(dc.global_blob.decode())


def _comparable(state):
    """A journal less its timestamps."""
    out = dict(state)
    out["events"] = [{k: v for k, v in e.items() if k != "ts"}
                     for e in state["events"]]
    return out


def test_journal_matches_the_reference_layout(tmp_path):
    """The same stimulus — a round, a committed version, a death, the
    scale-down round, a parked joiner — leaves the same journal from
    both trackers, key for key, the formation barrier (aborted by the
    scale-down round) included."""
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        t = _start(pkg, 3, min_workers=2, max_workers=3, state_dir=str(d))
        joiner = None
        try:
            _round(t, {"0": P.CMD_START, "1": P.CMD_START, "2": P.CMD_START})
            _poll(t, task="0", version=4)
            t.note_dead("2")
            _round(t, {"0": P.CMD_RESCALE, "1": P.CMD_RESCALE})
            joiner = _register(t, "7", P.CMD_START)
            assert _wait(lambda: _job(t)._target_world == 3
                         and _flushed(t))
            got[pkg] = _journal_state(t)
        finally:
            _stop(t)
            if joiner is not None:
                joiner.close()
    assert set(got["jax"]) == set(got["torch"])
    assert _comparable(got["torch"]) == _comparable(got["jax"])
    assert (got["torch"]["formbar_state"],
            got["torch"]["formbar_posted"]) == ("aborted", [])
    assert (got["torch"]["epoch"], got["torch"]["world"],
            got["torch"]["target_world"], got["torch"]["members"],
            got["torch"]["committed_version"]) == (1, 2, 3, ["0", "1"], 4)


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch"),
                                           ("jax", "jax")])
def test_tracker_restart_mid_epoch(tmp_path, writer, reader):
    """A tracker dies with a grow pending; one restarted on the same
    state_dir — of either package — replays membership and target, and
    the re-registrations complete the grow with the epoch bumped."""
    t1 = _start(writer, 2, max_workers=4, state_dir=str(tmp_path))
    r1 = _round(t1, {"a": P.CMD_START, "b": P.CMD_START})
    joiner = _register(t1, "c", P.CMD_START)
    assert _wait(lambda: _poll(t1)[1:] == (1, 3) and _flushed(t1))
    _stop(t1)
    joiner.close()
    t2 = MODS[reader].Tracker(2, "127.0.0.1", 0, max_workers=4,
                              state_dir=str(tmp_path))
    try:
        j = _job(t2)
        assert (j._members, j._target_world, t2.epoch) == ({"a", "b"}, 3, 0)
        t2.start()
        r2 = _round(t2, {"a": P.CMD_RESCALE, "b": P.CMD_RESCALE,
                         "c": P.CMD_START})
        assert {r.world for r in r2.values()} == {3}
        assert {r.epoch for r in r2.values()} == {1}
        assert {tid: r2[tid].rank for tid in "ab"} == \
            {tid: r1[tid].rank for tid in "ab"}
        assert r2["c"].rank == 2
    finally:
        _stop(t2)


def _formbar_post(t, task):
    s = socket.create_connection(("127.0.0.1", t.port), timeout=30)
    P.send_hello(s, P.CMD_FORMBAR, task, 0)
    return s


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch"),
                                           ("jax", "jax")])
def test_tracker_restart_mid_formation_barrier(tmp_path, writer, reader):
    """A tracker dies with the formation barrier half posted; one
    restarted on the same state_dir — of either package — replays who
    posted, and the parked worker's re-post with the last worker's post
    completes the barrier: both get u32 1."""
    t1 = _start(writer, 2, state_dir=str(tmp_path))
    _round(t1, {"a": P.CMD_START, "b": P.CMD_START})
    parked = _formbar_post(t1, "a")
    assert _wait(lambda: _job(t1)._formbar_posted == {"a"}
                 and _flushed(t1))
    _stop(t1)
    parked.close()
    t2 = MODS[reader].Tracker(2, "127.0.0.1", 0, state_dir=str(tmp_path))
    try:
        j = _job(t2)
        assert (j._formbar_state, j._formbar_posted) == ("open", {"a"})
        t2.start()
        posts = [_formbar_post(t2, task) for task in ("a", "b")]
        assert [P.recv_u32(s) for s in posts] == [1, 1]
        for s in posts:
            s.close()
        assert _job(t2)._formbar_state == "done"
    finally:
        _stop(t2)


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch"),
                                           ("jax", "jax")])
def test_tracker_restart_preserves_dead_verdicts(tmp_path, writer, reader):
    """The dead never come back to re-earn their verdict: a restart
    that forgot it would wait for the corpse.  Restored, the
    survivors' rescale round completes at world 2, and the committed
    version comes back too."""
    t1 = _start(writer, 3, min_workers=2, state_dir=str(tmp_path))
    r1 = _round(t1, {"x": P.CMD_START, "y": P.CMD_START, "z": P.CMD_START})
    _poll(t1, task="x", version=5)
    t1.note_dead("z")
    assert _wait(lambda: _poll(t1)[1:] == (1, 2) and _flushed(t1))
    _stop(t1)
    t2 = MODS[reader].Tracker(3, "127.0.0.1", 0, min_workers=2,
                              state_dir=str(tmp_path))
    try:
        j = _job(t2)
        assert (j._dead_tasks, j._target_world, t2.committed_version) == (
            {"z"}, 2, 5)
        t2.start()
        r2 = _round(t2, {"x": P.CMD_RESCALE, "y": P.CMD_RESCALE})
        assert {(r.world, r.epoch) for r in r2.values()} == {(2, 1)}
        old = sorted("xy", key=lambda tid: r1[tid].rank)
        assert [r2[tid].rank for tid in old] == [0, 1]
    finally:
        _stop(t2)


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_named_jobs_are_restored_and_finished_ones_are_not(tmp_path, writer,
                                                           reader):
    """Named jobs journal under ``state_dir/<job>/``; a restart replays
    the live one (its world from the journal) and leaves a finished one
    on disk only."""
    t1 = _start(writer, 3, state_dir=str(tmp_path))
    try:
        _round(t1, {"0": P.CMD_START, "1": P.CMD_START}, job="live", world=2)
        _round(t1, {"0": P.CMD_START}, job="gone", world=1)
        s = socket.create_connection(("127.0.0.1", t1.port), 30)
        P.send_hello(s, P.CMD_SHUTDOWN, "0", 1, job="gone")
        s.close()
        assert _wait(lambda: _job(t1, "gone").done
                     and _flushed(t1, "gone") and _flushed(t1, "live"))
    finally:
        _stop(t1)
    assert sorted(os.listdir(tmp_path)) == ["gone", "live"]
    t2 = MODS[reader].Tracker(3, "127.0.0.1", 0, state_dir=str(tmp_path))
    try:
        assert "gone" not in t2._jobs
        live = _job(t2, "live")
        assert (live.n_workers, sorted(live._members), live.done) == (
            2, ["0", "1"], False)
    finally:
        _stop(t2)


# ------------------------------------------------------ engine: the poll
class _PollStub:
    """A one-shot tracker that records one connection's bytes and
    answers the epoch poll with ``reply``."""

    def __init__(self, reply):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.raw = b""
        self._reply = reply
        self._t = threading.Thread(target=self._serve, daemon=True)
        self._t.start()

    def _serve(self):
        c, _ = self.sock.accept()
        c.settimeout(5)
        want = None
        while want is None or len(self.raw) < want:
            chunk = c.recv(4096)
            if not chunk:
                break
            self.raw += chunk
            want = self._expected_len()
        c.sendall(struct.pack("<3I", *self._reply))
        c.close()

    def _expected_len(self):
        """hello (MAGIC or MAGIC_JOB + job) + cmd + task + world + u32."""
        pos = 4
        try:
            (magic,) = struct.unpack_from("<I", self.raw)
            strs = 2 if magic == P.MAGIC else 3
            for _ in range(strs):
                (n,) = struct.unpack_from("<I", self.raw, pos)
                pos += 4 + n
            return pos + 8
        except struct.error:
            return None

    def close(self):
        self._t.join(5)
        self.sock.close()


def _polling_engine(kind, port, job, version, epoch=0):
    eng = (PyRobustEngine if kind == "torch" else JRobust)()
    eng._tracker_addr = ("127.0.0.1", port)
    eng._task_id, eng._world_hint, eng._job_id = "3", 4, job
    eng._version, eng._epoch, eng._world = version, epoch, 4
    return eng


@pytest.mark.parametrize("job,version", [(P.DEFAULT_JOB, 0),
                                         (P.DEFAULT_JOB, 7),
                                         ("tenant-a", 12),
                                         ("tenant-a", 0xFFFFFFFF)])
def test_epoch_poll_bytes_match_reference(job, version):
    """The engine's ``cmd=epoch`` poll: the same bytes on the wire from
    both engines, and the tracker's three u32s come back as a tuple."""
    got = {}
    for kind in PKGS:
        stub = _PollStub((2, 3, 5))
        try:
            eng = _polling_engine(kind, stub.port, job, version)
            got[kind] = (eng._tracker_epoch_poll(), None)
        finally:
            stub.close()
        got[kind] = (got[kind][0], stub.raw)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (2, 3, 5)
    buf = _Buf(got["torch"][1])
    assert P.recv_hello(buf) == (job, P.CMD_EPOCH, "3", 4)
    assert P.recv_u32(buf) == version and not buf.data


def test_epoch_poll_of_an_unreachable_tracker_is_no_change():
    """A closed port answers None at once, not after the dial's retry
    schedule: a restarting tracker costs a commit nothing."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    eng = _polling_engine("torch", port, P.DEFAULT_JOB, 1)
    t0 = time.monotonic()
    assert eng._tracker_epoch_poll() is None
    assert not eng._poll_rescale_pending()
    assert time.monotonic() - t0 < eng.EPOCH_POLL_TIMEOUT_SEC
    assert tpysocket.PySocketEngine.EPOCH_POLL_TIMEOUT_SEC == \
        jpysocket.PySocketEngine.EPOCH_POLL_TIMEOUT_SEC


@pytest.mark.parametrize("reply,epoch,want", [((0, 0, 3), 0, False),
                                              ((0, 1, 2), 0, True),
                                              ((1, 1, 2), 1, False),
                                              ((1, 2, 4), 1, True)])
def test_rescale_pending_is_a_newer_target_epoch(reply, epoch, want):
    stub = _PollStub(reply)
    try:
        eng = _polling_engine("torch", stub.port, P.DEFAULT_JOB, 2, epoch)
        assert eng._poll_rescale_pending() is want
    finally:
        stub.close()


# ------------------------------------------- engine: the async drain
@pytest.mark.parametrize("kind", PKGS)
def test_world_changed_drains_the_async_queue_and_keeps_the_pump(kind):
    """A rescale surfacing in the progress thread fails every queued op
    with the same error, realigns the wait cursor, and the pump serves
    the next op (a pump death would poison it)."""
    eng = (tpysocket.PySocketEngine if kind == "torch"
           else jpysocket.PySocketEngine)()
    err = WCE[kind](3, 2, 1)
    gate = threading.Event()
    hs = [eng._new_handle() for _ in range(4)]

    def rescaled():
        raise err
    eng._submit(gate.wait, (hs[0],))
    eng._submit(rescaled, (hs[1],))
    eng._submit(lambda: hs[2]._resolve("never"), (hs[2],))
    eng._submit(lambda: hs[3]._resolve("never"), (hs[3],))
    hs[0]._resolve(None)
    gate.set()
    assert hs[0].wait(timeout=30) is None
    for h in hs[1:]:
        with pytest.raises(WCE[kind]) as got:
            h.wait(timeout=30)
        assert got.value is err
    assert eng._wait_idx == eng._issue_idx == 4
    fresh = eng._new_handle()
    eng._submit(lambda: fresh._resolve(5), (fresh,))
    assert fresh.wait(timeout=30) == 5
    assert eng._pump_error is None
    eng._stop_pump()


# ------------------------------------------- engine: _world_changed
@pytest.mark.parametrize("kind", PKGS)
def test_world_changed_keeps_the_commit_and_voids_the_rest(kind, tmp_path):
    """The committed version and global model stay; the replay cache,
    seqno, local replicas and the pending checkpoint go; the durable
    store is rebuilt on the NEW rank's ``{rank}`` directory."""
    eng = ENGINES[kind]()
    eng._ckpt_dir_raw = str(tmp_path / "d{rank}")
    eng._ckpt_keep = 4
    eng._ckpt_store = ckpt.CheckpointStore(str(tmp_path / "d2"), rank=2)
    eng._version, eng._global, eng._has_checkpoint = 5, b"G5", True
    eng._cache, eng._seq = {0: b"x", 1: b"y"}, 2
    eng._local_store, eng._local = {2: (5, b"L"), 1: (5, b"M")}, b"L"
    eng._pending_global, eng._has_pending_local = b"P", True
    eng._rank, eng._world, eng._epoch = 0, 2, 1
    with pytest.raises(WCE[kind]) as got:
        eng._world_changed(3, 0)
    assert (got.value.old_world, got.value.new_world, got.value.epoch) == (
        3, 2, 1)
    assert (eng._version, eng._global, eng._has_checkpoint) == (5, b"G5",
                                                                True)
    assert (eng._cache, eng._seq, eng._local_store, eng._local) == (
        {}, 0, {}, None)
    assert (eng._pending_global, eng._has_pending_local) == (b"", False)
    store = eng._ckpt_store
    assert (store.root, store.rank, store.keep) == (str(tmp_path / "d0"),
                                                    0, 4)


# -------------------------------------------------- engine: thread worlds
def _expected_acc(worlds, ndata=NDATA):
    """``elastic_worker.py``'s recurrence, computed directly from the
    world each iteration ran at."""
    total = ndata * (ndata - 1) // 2
    acc = np.zeros(ndata, np.float64)
    for it, world in enumerate(worlds):
        a = (np.arange(ndata, dtype=np.float32) + world - 1 + it)
        acc = acc * 1.000001 + a.astype(np.float64) \
            + float(total + ndata * it) + it
    return acc.tobytes()


def _loop(hold=None, ndata=NDATA, niter=NITER):
    """``tests/workers/elastic_worker.py``'s loop on an engine: every
    iteration re-proves the exact partition at the current world and
    folds the world into ``acc``; a rescale is caught, the commit
    reloaded and the rows re-sharded."""
    def app(eng, kind, rec):
        ops = OPCODES[kind]
        total = ndata * (ndata - 1) // 2
        while True:
            try:
                version, blob, _ = eng.load_checkpoint()
                rank, world = eng.rank, eng.world_size
                if blob is None:
                    assert version == 0, version
                    acc = np.zeros(ndata, np.float64)
                else:
                    (it0,) = struct.unpack_from("<I", blob)
                    assert it0 == version, (it0, version)
                    acc = np.frombuffer(blob[4:], np.float64).copy()
                rec.setdefault("resumes", []).append(
                    (eng.epoch, world, rank, version))
                rows = np.asarray(SPLIT[kind].rows_for_rank(ndata, rank,
                                                            world), np.int64)
                for it in range(version, niter):
                    if hold is not None:
                        hold(it)
                    s = np.array([float((rows + it).sum())], np.float64)
                    eng.allreduce(s, ops.SUM)
                    assert s[0] == total + ndata * it, (s[0], world, it)
                    a = np.arange(ndata, dtype=np.float32) + rank + it
                    eng.allreduce(a, ops.MAX)
                    np.testing.assert_array_equal(
                        a, np.arange(ndata, dtype=np.float32) + world - 1
                        + it)
                    acc = acc * 1.000001 + a.astype(np.float64) + s[0] + it
                    eng.checkpoint(struct.pack("<I", it + 1)
                                   + acc.tobytes())
                break
            except WCE[kind] as e:
                rec.setdefault("rescales", []).append(
                    (e.old_world, e.new_world, e.epoch, eng.version_number))
        rec["final"] = acc.tobytes()
        rec["version"] = eng.version_number
    return app


class _Gate:
    """The app's hold: every rank reaching iteration ``at`` waits there
    until the gate opens, which pins the commit boundary a grow lands
    on."""

    def __init__(self, at):
        self.at, self.arrived = at, 0
        self.lock, self.open = threading.Lock(), threading.Event()

    def __call__(self, it):
        if it == self.at:
            with self.lock:
                self.arrived += 1
            assert self.open.wait(JOIN_SEC)


def _elastic_world(kinds, app, tracker="torch", die=None, joiner=None,
                   gate=None, params=None, trk_kw=None):
    """Rank threads of ``kinds`` (task ids "0".."n-1", ranks pinned) and
    an elastic tracker.  ``die`` = (task, version, seqno): that task
    dies at its kill-point and leaves — the harness reports it with
    ``note_dead``, as the launcher does for a worker whose restart
    budget is spent.  ``joiner`` = (task, kind): started once the
    shrink landed (epoch 1) and both survivors wait at ``gate``, which
    opens once the joiner is parked at the tracker.  Returns the
    records by task."""
    trk = MODS[tracker].Tracker(len(kinds), "127.0.0.1", 0,
                                **(trk_kw or {"min_workers": 2,
                                              "max_workers": len(kinds)}))
    trk.start()
    recs, errs, threads = {}, [], []

    def run(task, kind):
        rec = recs.setdefault(task, {})
        p = {"rabit_tracker_uri": "127.0.0.1", "rabit_tracker_port": trk.port,
             "rabit_task_id": task, "rabit_world_size": len(kinds),
             "rabit_timeout_sec": 20, "rabit_obs": 0, "rabit_elastic": 1,
             **(params or {})}
        if die is not None and task == die[0]:
            p["rabit_mock"] = _mock([(int(task), die[1], die[2], 0)])
        eng = ENGINES[kind]()
        try:
            eng.init(p)
            app(eng, kind, rec)
            eng.shutdown()
        except _Killed:
            rec["died"] = True
            trk.note_dead(task)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append((task, e))

    def spawn(task, kind):
        th = threading.Thread(target=run, args=(task, kind), daemon=True)
        th.start()
        threads.append(th)

    for i, kind in enumerate(kinds):
        spawn(str(i), kind)
    try:
        if joiner is not None:
            assert _wait(lambda: (trk.epoch >= 1 and gate.arrived == 2)
                         or errs, JOIN_SEC), errs
            spawn(*joiner)
            assert _wait(lambda: joiner[0] in _job(trk)._joiners or errs,
                         JOIN_SEC), errs
            gate.open.set()
        deadline = time.monotonic() + JOIN_SEC
        for th in list(threads):
            th.join(max(deadline - time.monotonic(), 0.0))
        alive = [th for th in threads if th.is_alive()]
    finally:
        if gate is not None:
            gate.open.set()
        _stop(trk)
    assert not alive, f"{len(alive)} rank thread(s) still running"
    assert not errs, errs
    return recs


@pytest.mark.parametrize("kinds,joiner,tracker", [
    (("torch",) * 3, "torch", "torch"),
    (("jax",) * 3, "jax", "jax"),
    (("torch",) * 3, "torch", "jax"),
    (("jax",) * 3, "jax", "torch"),
    (("torch", "jax", "torch"), "jax", "torch"),
    (("jax", "torch", "jax"), "torch", "jax")],
    ids=["port", "ref", "port-reftracker", "ref-porttracker",
         "mixed", "mixed-reftracker"])
def test_shrink_to_2_and_grow_back_to_3(kinds, joiner, tracker):
    """``elastic_worker.py`` at 3 -> 2 -> 3: rank 2 dies after version
    2's commit and leaves; the survivors catch WorldChangedError in
    iteration 2, reload v2 and re-shard in halves; once a joiner parks,
    iteration 4 commits v5, the ack round carries K_RESCALE and all
    three resume at v5 (the joiner served the survivors' version).
    Every rank's final bits are the recurrence of worlds 3,3,2,2,2,3 —
    in port, reference and mixed worlds, under both trackers."""
    gate = _Gate(4)
    recs = _elastic_world(kinds, _loop(hold=gate), tracker, die=("2", 2, 0),
                          joiner=("3", joiner), gate=gate)
    want = _expected_acc([3, 3, 2, 2, 2, 3])
    assert recs["2"] == {"died": True,
                         "resumes": [(0, 3, 2, 0)]}
    for task in ("0", "1"):
        assert recs[task]["final"] == want, task
        assert recs[task]["version"] == NITER
        assert recs[task]["rescales"] == [(3, 2, 1, 2), (2, 3, 2, 5)]
        r = int(task)
        assert recs[task]["resumes"] == [(0, 3, r, 0), (1, 2, r, 2),
                                         (2, 3, r, 5)]
    assert recs["3"]["final"] == want
    assert recs["3"]["resumes"] == [(2, 3, 2, 5)]
    assert "rescales" not in recs["3"]


@pytest.mark.parametrize("kinds", [("torch",) * 3, ("jax",) * 3,
                                   ("jax", "torch", "torch")],
                         ids=["port", "ref", "mixed"])
def test_writers_are_re_elected_after_a_rescale(kinds, tmp_path):
    """Rank 0 dies after version 2's commit with one durable writer:
    task 1 becomes rank 0 and takes over ``d0`` (the ``{rank}``
    expansion follows the new rank); nobody ever writes ``d1`` or
    ``d2``, and ``d0`` ends at the last version."""
    recs = _elastic_world(
        kinds, _loop(niter=5), die=("0", 2, 0),
        params={"rabit_ckpt_dir": str(tmp_path / "d{rank}"),
                "rabit_ckpt_writers": 1, "rabit_ckpt_keep": 8})
    assert recs["1"]["final"] == recs["2"]["final"] == \
        _expected_acc([3, 3, 2, 2, 2])
    d0 = ckpt.CheckpointStore(str(tmp_path / "d0"), rank=0)
    assert d0.versions() == [5, 4, 3, 2, 1]
    assert d0.load_latest().world == 2
    for d in ("d1", "d2"):
        path = tmp_path / d
        assert not path.exists() or ckpt.CheckpointStore(
            str(path), rank=int(d[1])).versions() == []


@pytest.mark.parametrize("kind", PKGS)
def test_a_lone_rank_grows_at_its_commit(kind):
    """World 1 polls at its commit too: a parked joiner makes the next
    commit a rescale boundary, the lone rank catches WorldChangedError
    and both resume at world 2 from its version."""
    trk = MODS["torch"].Tracker(1, "127.0.0.1", 0, max_workers=2)
    trk.start()
    recs, errs = {}, []
    gate = _Gate(2)

    def rank(task, hold):
        rec = recs.setdefault(task, {})
        try:
            eng = ENGINES[kind]()
            eng.init({"rabit_tracker_uri": "127.0.0.1",
                      "rabit_tracker_port": trk.port, "rabit_task_id": task,
                      "rabit_world_size": 1, "rabit_timeout_sec": 20,
                      "rabit_obs": 0, "rabit_elastic": 1})
            _loop(hold=hold, niter=4)(eng, kind, rec)
            eng.shutdown()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    first = threading.Thread(target=rank, args=("0", gate), daemon=True)
    first.start()
    try:
        assert _wait(lambda: gate.arrived == 1 or errs, JOIN_SEC), errs
        second = threading.Thread(target=rank, args=("1", None), daemon=True)
        second.start()
        assert _wait(lambda: "1" in _job(trk)._joiners, JOIN_SEC)
        gate.open.set()
        first.join(JOIN_SEC)
        second.join(JOIN_SEC)
    finally:
        gate.open.set()
        _stop(trk)
    assert not errs, errs
    want = _expected_acc([1, 1, 1, 2])
    assert recs["0"]["final"] == recs["1"]["final"] == want
    assert recs["0"]["rescales"] == [(1, 2, 1, 3)]
    assert recs["1"]["resumes"] == [(1, 2, 1, 3)]


# ------------------------------------------ k-means and GBDT, shrinking
N_KM = 3 * 1024
_FIXED = {}     # the fixed-world port runs, by app


def _all_rows(which):
    """The three thirds of ``test_torch_pysocket_learn``'s data as one
    dataset, which ``rows_for_rank`` deals out."""
    if which == "kmeans":
        parts = [kmeans_shard(r) for r in range(3)]
        nnz = len(parts[0]["findex"]) // (len(parts[0]["indptr"]) - 1)
        idx = np.concatenate([p["findex"] for p in parts]).reshape(-1, nnz)
        val = np.concatenate([p["fvalue"] for p in parts]).reshape(-1, nnz)
        return idx, val, parts[0]["feat_dim"]
    parts = [gbdt_shard(r) for r in range(3)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def _learn_app(proxies, which):
    data = _all_rows(which)

    def app(eng, kind, rec):
        proxies[kind].set(eng)
        while True:
            try:
                rows = np.asarray(SPLIT[kind].rows_for_rank(
                    len(data[0]), eng.rank, eng.world_size), np.int64)
                if which == "kmeans":
                    idx, val, d = data
                    nnz = idx.shape[1]
                    shard = dict(indptr=np.arange(len(rows) + 1,
                                                  dtype=np.int64) * nnz,
                                 findex=idx[rows].reshape(-1),
                                 fvalue=val[rows].reshape(-1),
                                 labels=np.zeros(len(rows), np.float32),
                                 feat_dim=d)
                    if kind == "torch":
                        model = km.run(SparseMat(**shard), KM_K, 4,
                                       device="cpu")
                    else:
                        model = jkm.run(JSparseMat(**shard), KM_K, 4)
                    rec["model"] = np.asarray(model.centroids)
                else:
                    x, y = data[0][rows], data[1][rows]
                    kw = ({"device": "cpu"} if kind == "torch"
                          else {"use_pallas": False})
                    model = (gb if kind == "torch" else jgb).train(
                        x, y, num_round=3, max_depth=GB_DEPTH, nbin=GB_NBIN,
                        **kw)
                    rec["model"] = [[(n.feature, n.bin_threshold, n.left,
                                      n.right, bool(n.default_left),
                                      float(n.value)) for n in t]
                                    for t in model.trees]
                break
            except WCE[kind] as e:
                rec.setdefault("rescales", []).append(
                    (e.old_world, e.new_world, eng.version_number))
        rec["version"] = eng.version_number
    return app


def _assert_models_close(which, got, want):
    if which == "kmeans":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert [[n[:5] for n in t] for t in got] == \
            [[n[:5] for n in t] for t in want]
        np.testing.assert_allclose([n[5] for t in got for n in t],
                                   [n[5] for t in want for n in t],
                                   **F32_TOL)


@pytest.mark.parametrize("which", ["kmeans", "gbdt"])
@pytest.mark.parametrize("kinds", [("torch",) * 3, ("jax",) * 3,
                                   ("torch", "jax", "torch")],
                         ids=["port", "ref", "mixed"])
def test_apps_through_a_scale_down(per_thread, which, kinds):
    """``kmeans.run`` and ``boosting.train`` (plain histograms): rank 2
    dies right after version 1's commit and leaves; the survivors catch
    WorldChangedError, re-shard with ``rows_for_rank`` and resume from
    v1 at world 2.  Their models agree with each other and lie within
    the JAX tests' bar of a fixed world-3 port run over the same rows
    (GBDT: the same splits)."""
    app = _learn_app(per_thread, which)
    if which not in _FIXED:
        fixed = _elastic_world(("torch",) * 3, app,
                               trk_kw={"min_workers": 2})
        _FIXED[which] = fixed["0"]["model"]
    recs = _elastic_world(kinds, app, die=("2", 1, 0))
    assert recs["2"] == {"died": True}
    for task in ("0", "1"):
        assert recs[task]["rescales"] == [(3, 2, 1)]
        _assert_models_close(which, recs[task]["model"], _FIXED[which])
    _assert_models_close(which, recs["0"]["model"], recs["1"]["model"])


# ------------------------------------------------ the launcher, launched
def _worker(out_dir):
    """One rank process of the launched job: the elastic loop through
    the API; task 2 SIGKILLs itself right after committing version 1."""
    rabit_tpu_torch.init()
    task = os.environ["RABIT_TASK_ID"]
    total = NDATA * (NDATA - 1) // 2
    while True:
        try:
            version, model = rabit_tpu_torch.load_checkpoint()
            rank = rabit_tpu_torch.get_rank()
            world = rabit_tpu_torch.get_world_size()
            acc = (np.zeros(NDATA, np.float64) if model is None
                   else model["acc"])
            rows = np.asarray(splitrows.rows_for_rank(NDATA, rank, world))
            for it in range(version, NITER):
                s = np.array([float((rows + it).sum())], np.float64)
                rabit_tpu_torch.allreduce(s, rabit_tpu_torch.SUM)
                assert s[0] == total + NDATA * it
                a = np.arange(NDATA, dtype=np.float32) + rank + it
                rabit_tpu_torch.allreduce(a, rabit_tpu_torch.MAX)
                acc = acc * 1.000001 + a.astype(np.float64) + s[0] + it
                rabit_tpu_torch.checkpoint({"acc": acc})
                if task == "2" and it == 0:
                    os.kill(os.getpid(), signal.SIGKILL)
            break
        except rabit_tpu_torch.WorldChangedError:
            continue
    with open(os.path.join(out_dir, f"final.{task}"), "wb") as f:
        f.write(acc.tobytes())
    rabit_tpu_torch.finalize()
    return 0


def test_cli_elastic_leave_shrinks_the_world(tmp_path):
    """``launch_local --min-workers 2 --state-dir D``: worker 2 is
    SIGKILLed after version 1 with no restart budget; the launcher
    reports it to the tracker instead of failing the job, the world
    shrinks to 2 at the survivors' next op, both finish with the bits
    of worlds 3,2,2,2,2,2, rc 0, and the journal in D ends at epoch 1,
    world 2, done."""
    out, state = tmp_path / "out", tmp_path / "state"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launch_local",
         "-n", "3", "--min-workers", "2", "--state-dir", str(state), "--",
         sys.executable, os.path.abspath(__file__), "worker", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "elastic: worker 2 left the job" in proc.stderr
    assert sorted(os.listdir(out)) == ["final.0", "final.1"]
    want = _expected_acc([3, 2, 2, 2, 2, 2])
    for task in ("0", "1"):
        assert (out / f"final.{task}").read_bytes() == want
    state_now = json.loads(ckpt.CheckpointStore(
        str(state), rank=0).load_latest().global_blob.decode())
    assert (state_now["epoch"], state_now["world"], state_now["members"],
            state_now["done"]) == (1, 2, ["0", "1"], True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        sys.exit(_worker(sys.argv[2]))
