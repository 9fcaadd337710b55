"""The port's rendezvous tracker against rabit_tpu's: the topology handout
(tree, ring and every schedule's extra links), rank assignment, and
whole registration rounds on threads in one process, where the port's
``Tracker`` must give the reference ``Tracker``'s replies field for
field."""
import dataclasses
import random
import socket
import threading
import time
from types import SimpleNamespace

import pytest

from rabit_tpu.sched import topo as jtopo
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker import tracker as jtracker
from rabit_tpu_torch.sched import topo as ttopo
from rabit_tpu_torch.sched import tuner as ttuner
from rabit_tpu_torch.tracker import protocol as TP
from rabit_tpu_torch.tracker import tracker as ttracker

TRACKERS = {"jax": jtracker, "torch": ttracker}
PROTOCOLS = {"jax": JP, "torch": TP}
TIMEOUT = 20.0


@pytest.fixture(autouse=True)
def _tracker_env(monkeypatch):
    for var in ("RABIT_TRACKER_SHUFFLE", "RABIT_TRACKER_PIN_RANKS",
                "RABIT_TRACKER_GROUPS", "RABIT_TIMEOUT_SEC"):
        monkeypatch.delenv(var, raising=False)


# ------------------------------------------------------- topology handout
def _groupings(world):
    return [None, [0] * world, [r // 2 for r in range(world)],
            [r % 3 for r in range(world)]]


@pytest.mark.parametrize("world", list(range(1, 17)) + [33])
def test_topology_handout_matches(world):
    for rank in range(world):
        assert (ttracker.tree_neighbors(rank, world)
                == jtracker.tree_neighbors(rank, world))
        assert (ttracker.ring_neighbors(rank, world)
                == jtracker.ring_neighbors(rank, world))
        for groups in _groupings(world):
            for demoted in ((), (0,), (1, world - 1)):
                assert (ttopo.extra_link_peers(rank, world, groups, demoted)
                        == jtopo.extra_link_peers(rank, world, groups,
                                                  demoted))
            if groups:
                assert (ttopo.group_leaders(groups, (0,))
                        == jtopo.group_leaders(groups, (0,)))


def test_directive_encoding_matches():
    from rabit_tpu.sched import tuner as jtuner

    table = {1 << 20: "ring", 4096: "tree", 65536: "halving/int8"}
    raw = ttuner.encode_directive(table)
    assert raw == jtuner.encode_directive(table)
    assert ttuner.encode_directive({}) == jtuner.encode_directive({}) == ""
    for s in (raw, "", "bad,0:x,-3:y,12:,7:swing", None):
        assert ttuner.decode_directive(s) == jtuner.decode_directive(s)


# -------------------------------------------------------- rank assignment
def _assign(mod, world, task_ids, seed, rank_of=None):
    job = mod.JobState(None, "default", world)
    job._rank_of = dict(rank_of or {})
    random.seed(seed)
    job._assign_ranks([SimpleNamespace(task_id=t) for t in task_ids])
    return job._rank_of


@pytest.mark.parametrize("mode", ["pin", "no_shuffle", "seeded_shuffle"])
def test_assign_ranks_matches(mode, monkeypatch):
    if mode == "pin":
        monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
        tasks = ["5", "x", "0", "12", "3", "y", "007", "6"]
    elif mode == "no_shuffle":
        monkeypatch.setenv("RABIT_TRACKER_SHUFFLE", "0")
        tasks = [f"t{i}" for i in (4, 1, 7, 0, 3, 2, 6, 5)]
    else:
        tasks = [f"t{i}" for i in range(8)]
    for seed in (0, 1, 7):
        got = {name: _assign(mod, 8, tasks, seed)
               for name, mod in TRACKERS.items()}
        assert got["jax"] == got["torch"]
        assert sorted(got["torch"].values()) == list(range(8))
        # a restarted task keeps its rank; only new ones draw
        again = {name: _assign(mod, 8, tasks[:3] + ["new"], seed + 1,
                               {t: r for t, r in got[name].items()
                                if t not in (tasks[1], tasks[-1])})
                 for name, mod in TRACKERS.items()}
        assert again["jax"] == again["torch"]
    if mode == "pin":
        assert got["torch"]["5"] == 5 and got["torch"]["0"] == 0
        assert got["torch"]["3"] == 3 and got["torch"]["6"] == 6
    if mode == "no_shuffle":
        assert got["torch"] == {t: i for i, t in enumerate(tasks)}


@pytest.mark.parametrize("override", ["", "0,0,1,1", "5;5;0;9", "1,2",
                                      "a,b,c,d", "0,0,0,4294967296"])
def test_topo_groups_match(override, monkeypatch):
    monkeypatch.setenv("RABIT_TRACKER_GROUPS", override)
    by_rank = {r: SimpleNamespace(host=h) for r, h in
               enumerate(["hb", "ha", "hb", "hc"])}
    got = {name: mod.JobState(None, "default", 4)._topo_groups(by_rank, 4)
           for name, mod in TRACKERS.items()}
    assert got["jax"] == got["torch"]


# ----------------------------------------------------- registration rounds
@dataclasses.dataclass
class Client:
    task_id: str
    proto: str = "torch"          # which package's protocol it speaks
    cmd: str = "start"
    host: str = "127.0.0.1"
    port: int = 9000
    job: str = "default"
    world: int = 0


def _register(tracker_port, c: Client):
    P = PROTOCOLS[c.proto]
    sock = socket.create_connection(("127.0.0.1", tracker_port),
                                    timeout=TIMEOUT)
    P.send_hello(sock, c.cmd, c.task_id, c.world, job=c.job)
    P.send_str(sock, c.host)
    P.send_u32(sock, c.port)
    return sock


def run_round(tracker_port, clients):
    """One registration round on threads, one per client.  Client i
    connects only after client i-1 sent its hello, so the tracker sees
    them in list order (its accept queue is FIFO) and ranks are
    deterministic; each thread then waits for its own reply."""
    replies, errors = {}, []
    sent = [threading.Event() for _ in clients]

    def client(i, c):
        try:
            if i and not sent[i - 1].wait(TIMEOUT):
                raise TimeoutError(f"client {i - 1} never sent its hello")
            sock = _register(tracker_port, c)
            sent[i].set()
            try:
                P = PROTOCOLS[c.proto]
                replies[c.task_id] = P.TopologyReply.recv_or_reject(sock)
            finally:
                sock.close()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            sent[i].set()

    threads = [threading.Thread(target=client, args=(i, c))
               for i, c in enumerate(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive(), "client thread did not finish"
    if errors:
        raise errors[0]
    return replies


def _command(tracker_port, cmd, task_id, job="default", proto="torch",
             payload=None):
    P = PROTOCOLS[proto]
    sock = socket.create_connection(("127.0.0.1", tracker_port),
                                    timeout=TIMEOUT)
    try:
        P.send_hello(sock, cmd, task_id, 0, job=job)
        if payload is not None:
            P.send_str(sock, payload)
        # the tracker closes one-shot commands without a reply
        assert sock.recv(1) == b""
    finally:
        sock.close()


def shutdown_all(tracker_port, task_ids, job="default"):
    for t in task_ids:
        _command(tracker_port, "shutdown", t, job=job)


def start_tracker(pkg, world):
    tr = TRACKERS[pkg].Tracker(world, host="127.0.0.1", port=0)
    tr.start()
    return tr


def finish(tr, pkg):
    """Wait for run() to return, then make sure nothing is left running.
    The reference's stop() closes its listener without waking a blocked
    accept(), so a reference tracker whose run() is still serving is
    woken by shutting its listener down first."""
    if pkg == "jax" and tr._thread.is_alive():
        try:
            tr._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    tr.stop()
    tr.join(TIMEOUT)
    assert not tr._thread.is_alive()


def _asdict(replies):
    return {t: dataclasses.asdict(r) for t, r in replies.items()}


def _clients(world):
    # two "hosts" so the group handout and the hierarchical links vary
    return [Client(task_id=f"task-{i}", host=f"10.0.0.{1 + i % 2}",
                   port=20000 + i, world=world)
            for i in (3, 0, 5, 1, 6, 2, 4) if i < world]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_round_matches_reference_tracker(world):
    """The same registrants, in the same order and under the same seed,
    get the same replies from the port's tracker as from the
    reference's; then every member's shutdown ends run()."""
    got = {}
    for pkg in ("jax", "torch"):
        tr = start_tracker(pkg, world)
        try:
            random.seed(1234 + world)
            clients = _clients(world)
            got[pkg] = _asdict(run_round(tr.port, clients))
            shutdown_all(tr.port, [c.task_id for c in clients])
            tr.join(TIMEOUT)
            assert not tr._thread.is_alive(), "run() did not return"
        finally:
            finish(tr, pkg)
    assert got["jax"] == got["torch"]
    replies = got["torch"]
    assert sorted(r["rank"] for r in replies.values()) == list(range(world))
    for r in replies.values():
        rank = r["rank"]
        parent, nb = ttracker.tree_neighbors(rank, world)
        rp, rn = ttracker.ring_neighbors(rank, world)
        assert (r["world"], r["parent"], r["neighbors"]) == (world, parent,
                                                            nb)
        assert (r["ring_prev"], r["ring_next"]) == (rp, rn)
        assert (r["epoch"], r["sched"], r["demoted"]) == (0, "", [])
        linkset = set(nb) | ttopo.extra_link_peers(rank, world, r["groups"])
        if world > 1:
            linkset |= {rp, rn}
        linkset.discard(rank)
        assert [c[0] for c in r["connect"]] == sorted(
            p for p in linkset if p < rank)
        assert r["naccept"] == sum(1 for p in linkset if p > rank)


def test_relaunch_flag_and_stable_ranks_match_reference():
    """tests/test_tracker.py's relaunch round on both trackers: only a
    start re-registration of a task that already got a reply is
    flagged, and ranks stay put across rounds."""
    got = {}
    for pkg in ("jax", "torch"):
        tr = start_tracker(pkg, 2)
        try:
            random.seed(99)
            r1 = run_round(tr.port, [Client("0"), Client("1")])
            r2 = run_round(tr.port, [Client("0", cmd="recover"),
                                     Client("1", cmd="start")])
            assert {t: r.relaunched for t, r in r1.items()} == \
                {"0": 0, "1": 0}
            assert r2["0"].relaunched == 0 and r2["1"].relaunched == 1
            assert ({t: r.rank for t, r in r1.items()}
                    == {t: r.rank for t, r in r2.items()})
            got[pkg] = (_asdict(r1), _asdict(r2))
        finally:
            finish(tr, pkg)
    assert got["jax"] == got["torch"]


def test_mixed_clients_under_one_port_tracker():
    """Reference-side and port-side clients register with one port
    tracker; every reply is what the reference tracker sends the same
    registrants."""
    got = {}
    for pkg in ("jax", "torch"):
        tr = start_tracker(pkg, 4)
        try:
            random.seed(4)
            clients = [dataclasses.replace(c, proto=p) for c, p in
                       zip(_clients(4), ("jax", "torch", "torch", "jax"))]
            got[pkg] = _asdict(run_round(tr.port, clients))
        finally:
            finish(tr, pkg)
    assert got["jax"] == got["torch"]


def test_named_job_gets_its_own_round():
    """A MAGIC_JOB registrant lands in its own job, sized by its world
    hint, while the default job's round is still open; the tracker runs
    until both jobs shut down."""
    tr = start_tracker("torch", 2)
    try:
        named = [Client(f"n{i}", job="tenant-b", world=3, port=30000 + i)
                 for i in range(3)]
        replies = run_round(tr.port, named)
        assert sorted(r.rank for r in replies.values()) == [0, 1, 2]
        assert {r.world for r in replies.values()} == {3}
        default = run_round(tr.port, [Client("d0"), Client("d1")])
        assert {r.world for r in default.values()} == {2}
        shutdown_all(tr.port, ["n0", "n1", "n2"], job="tenant-b")
        assert tr._thread.is_alive()      # the default job is still live
        shutdown_all(tr.port, ["d0", "d1"])
        tr.join(TIMEOUT)
        assert not tr._thread.is_alive()
    finally:
        finish(tr, "torch")


def test_print_relay_and_obs_summary(capsys):
    tr = start_tracker("torch", 1)
    try:
        _command(tr.port, "print", "0", payload="hello from rank 0")
        _command(tr.port, "print", "0", proto="jax", payload="two\n")
        _command(tr.port, "print", "0",
                 payload=ttracker._OBS_SUMMARY_PREFIX + '{"ops": 1}')
        run_round(tr.port, [Client("0")])      # orders the prints before
        shutdown_all(tr.port, ["0"])
        tr.join(TIMEOUT)
        assert not tr._thread.is_alive()
    finally:
        finish(tr, "torch")
    out = capsys.readouterr()
    assert out.out == "hello from rank 0\ntwo\n"
    assert "obs summary from task '0' dropped" in out.err


def test_stop_wakes_run_without_workers():
    """stop() ends run() even when no worker ever came (the port shuts
    its listener down, which wakes a blocked accept())."""
    tr = start_tracker("torch", 4)
    tr.stop()
    tr.join(TIMEOUT)
    assert not tr._thread.is_alive()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", ["bad_magic", "long_task_id", "bad_job",
                                  "long_host"])
def test_stray_client(pkg, case):
    """A client without the magic is dropped with no reply; one that
    spoke the magic and then went wrong gets REJECT_BAD_HANDSHAKE."""
    tr = start_tracker(pkg, 2)
    try:
        sock = socket.create_connection(("127.0.0.1", tr.port),
                                        timeout=TIMEOUT)
        try:
            if case == "bad_magic":
                sock.sendall(b"GET / HTTP/1.0\r\n\r\n")
            elif case == "long_task_id":
                JP.send_u32(sock, JP.MAGIC)
                JP.send_str(sock, "start")
                JP.send_u32(sock, JP.MAX_HELLO_STR + 1)
            elif case == "bad_job":
                JP.send_u32(sock, JP.MAGIC_JOB)
                JP.send_str(sock, "no/slash")
            else:
                JP.send_hello(sock, "start", "0", 2)
                JP.send_u32(sock, JP.MAX_HELLO_STR + 1)
            if case == "bad_magic":
                # dropped unread: a close with our bytes still queued
                # resets the connection instead of ending it cleanly
                try:
                    assert sock.recv(1) == b""
                except ConnectionResetError:
                    pass
            else:
                rej = JP.TopologyReply.recv_or_reject(sock)
                assert isinstance(rej, JP.RejectReply)
                assert rej.code == JP.REJECT_BAD_HANDSHAKE and rej.reason
        finally:
            sock.close()
        # the tracker still serves a real round afterwards
        replies = run_round(tr.port, [Client("0"), Client("1")])
        assert sorted(r.rank for r in replies.values()) == [0, 1]
    finally:
        finish(tr, pkg)


@pytest.mark.parametrize("cmd", ["bogus"])
def test_commands_outside_the_slice_are_refused(cmd, capsys):
    """A command the port's tracker does not serve gets the reference's
    treatment of an unknown command: logged, closed, no reply, and no
    job state moves."""
    tr = start_tracker("torch", 1)
    try:
        _command(tr.port, cmd, "0")
        replies = run_round(tr.port, [Client("0")])
        assert replies["0"].rank == 0 and replies["0"].relaunched == 0
    finally:
        finish(tr, "torch")
    assert f"unknown command {cmd!r}" in capsys.readouterr().err


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_heartbeat_command_is_served(pkg, capsys):
    """``heartbeat`` is served: the channel stays open after the hello
    and its period, the task is alive on the job's timeline, and a bye
    ends it as a clean shutdown, with no unknown-command log."""
    tr = start_tracker(pkg, 1)
    try:
        sock = socket.create_connection(("127.0.0.1", tr.port),
                                        timeout=TIMEOUT)
        PROTOCOLS[pkg].send_hello(sock, "heartbeat", "0", 1)
        PROTOCOLS[pkg].send_u32(sock, 100)
        PROTOCOLS[pkg].send_u32(sock, 1)
        sock.settimeout(0.3)
        with pytest.raises(socket.timeout):
            sock.recv(1)              # open: no reply, no close
        PROTOCOLS[pkg].send_u32(sock, PROTOCOLS[pkg].HEARTBEAT_BYE)
        events = tr._default_job()._events
        deadline = time.monotonic() + TIMEOUT
        while len(events) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [(e["phase"], e["task"]) for e in events
                if e.get("name") == "liveness"] == [("alive", "0"),
                                                    ("shutdown", "0")]
        sock.close()
        replies = run_round(tr.port, [Client("0")])
        assert replies["0"].rank == 0
    finally:
        finish(tr, pkg)
    assert "unknown command" not in capsys.readouterr().err


def test_worker_env_matches_reference():
    got = {}
    for pkg in ("jax", "torch"):
        tr = TRACKERS[pkg].Tracker(3, host="127.0.0.1", port=0)
        try:
            env = tr.worker_env("7")
            env_job = tr.worker_env("7", job="tenant-c")
            got[pkg] = (env.pop("RABIT_TRACKER_PORT") == str(tr.port),
                        env, env_job.pop("RABIT_TRACKER_PORT") == str(tr.port),
                        env_job, tr.uri)
        finally:
            tr.stop()
    assert got["jax"] == got["torch"]


# ------------------------------------------ formation barrier and stores
def _formbar(tracker_port, task_id, proto="torch", world=0, job="default"):
    """Post ``formbar``; returns a function that waits for the reply and
    gives every byte the tracker sent before it closed."""
    P = PROTOCOLS[proto]
    sock = socket.create_connection(("127.0.0.1", tracker_port),
                                    timeout=TIMEOUT)
    P.send_hello(sock, "formbar", task_id, world, job=job)

    def reply():
        try:
            data = b""
            while True:
                chunk = sock.recv(16)
                if not chunk:
                    return data
                data += chunk
        finally:
            sock.close()
    return reply


def _formbar_outcome(tracker_pkg, proto, outcome):
    """One formation-barrier story on ``tracker_pkg``'s tracker, every
    message in ``proto``'s bytes; returns each post's reply bytes and
    the job's barrier state."""
    world = 2
    kw = {"registrant_timeout_sec": 1.0} if outcome == "timed_out" else {}
    tr = TRACKERS[tracker_pkg].Tracker(world, host="127.0.0.1", port=0,
                                       **kw)
    tr.start()
    got = []
    try:
        clients = [Client(task_id=str(i), proto=proto, world=world)
                   for i in range(world)]
        run_round(tr.port, clients)
        if outcome == "all_posted":
            waits = [_formbar(tr.port, c.task_id, proto, world)
                     for c in clients]
            got = [w() for w in waits]
            got.append(_formbar(tr.port, "0", proto, world)())  # after
        elif outcome == "aborted":
            first = _formbar(tr.port, "0", proto, world)
            deadline = time.monotonic() + TIMEOUT
            while (not tr._default_job()._formbar_posted
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            # task 1 re-registers as a mid-job relaunch: a new round
            # that the other member completes with a recover
            relaunch = [Client("1", proto=proto, world=world),
                        Client("0", proto=proto, cmd="recover",
                               world=world)]
            replies = run_round(tr.port, relaunch)
            assert replies["1"].relaunched == 1
            got = [first(), _formbar(tr.port, "1", proto, world)()]
        else:
            got = [_formbar(tr.port, "0", proto, world)(),
                   _formbar(tr.port, "1", proto, world)()]
        state = tr._default_job()._formbar_state
        shutdown_all(tr.port, [c.task_id for c in clients])
    finally:
        finish(tr, tracker_pkg)
    return got, state


@pytest.mark.parametrize("proto", ["jax", "torch"])
@pytest.mark.parametrize("outcome,want", [
    ("all_posted", ([b"\x01\0\0\0"] * 3, "done")),
    ("aborted", ([b"\0\0\0\0"] * 2, "aborted")),
    ("timed_out", ([b"\0\0\0\0"] * 2, "aborted"))])
def test_formation_barrier_matches_reference(proto, outcome, want):
    """The formation barrier's stories — every worker posted (and a post
    after resolution), aborted by a relaunch's re-registration, timed
    out — give the same reply bytes and the same barrier state from
    both trackers, to clients speaking either package's bytes."""
    got = {pkg: _formbar_outcome(pkg, proto, outcome)
           for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"] == want


def _jaxsvc(tracker_port, key, proto="torch", world=2):
    P = PROTOCOLS[proto]
    sock = socket.create_connection(("127.0.0.1", tracker_port),
                                    timeout=TIMEOUT)
    try:
        P.send_hello(sock, "jaxsvc", key, world)
        port = P.recv_u32(sock)
        assert sock.recv(1) == b""
    finally:
        sock.close()
    return port


@pytest.mark.parametrize("proto", ["jax", "torch"])
def test_jaxsvc_keyed_and_fresh(proto):
    """``jaxsvc``: a key is create-or-get (the same port for every ask),
    ``""`` a fresh store each time, and the port names a live
    ``torch.distributed.TCPStore`` hosted by the tracker — where the
    reference hosts a JAX coordination service (the reply bytes are the
    same u32)."""
    import datetime

    import torch.distributed as dist

    tr = start_tracker("torch", 2)
    try:
        run_round(tr.port, [Client("0"), Client("1")])
        init = [_jaxsvc(tr.port, "init", proto) for _ in range(3)]
        fresh = [_jaxsvc(tr.port, "", proto) for _ in range(2)]
        assert init[0] and len(set(init)) == 1
        assert all(fresh) and len(set(fresh) | {init[0]}) == 3
        for port in (init[0], fresh[1]):
            a = dist.TCPStore("127.0.0.1", port, None, False,
                              datetime.timedelta(seconds=TIMEOUT),
                              wait_for_workers=False)
            b = dist.TCPStore("127.0.0.1", port, None, False,
                              datetime.timedelta(seconds=TIMEOUT),
                              wait_for_workers=False)
            a.set("k", b"v")
            assert b.get("k") == b"v"
        assert len(tr._jaxsvcs) == 3
        shutdown_all(tr.port, ["0", "1"])
    finally:
        finish(tr, "torch")
    assert tr._jaxsvcs == []


def test_jaxsvc_without_a_store_replies_zero(monkeypatch):
    """A tracker that cannot host a store replies 0, as the reference's
    does without jaxlib; an unknown job gets 0 too."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise RuntimeError("no store here")
    monkeypatch.setattr(dist, "TCPStore", refuse)
    tr = start_tracker("torch", 1)
    try:
        run_round(tr.port, [Client("0")])
        assert _jaxsvc(tr.port, "init") == 0
        assert _jaxsvc(tr.port, "") == 0
        shutdown_all(tr.port, ["0"])
    finally:
        finish(tr, "torch")
