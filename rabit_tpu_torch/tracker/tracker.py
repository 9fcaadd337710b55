"""Rendezvous tracker — the control plane's rendezvous core, liveness,
elastic membership and journal.

PyTorch-port counterpart of :mod:`rabit_tpu.tracker.tracker`, cut to the
rendezvous core, the liveness layer, elastic membership and the durable
journal: it assigns ranks (stable per task_id across restarts),
computes the tree+ring topology plus every schedule's extra links,
hands each worker its connect/accept lists, relays worker log lines,
decides which workers are alive, grows and shrinks a job's world at
its commit boundaries, journals its state so a restarted tracker
resumes, and terminates when every job it served has completed or was
collected as an orphan.  Its replies equal the reference tracker's
field for field, so port ranks and reference ranks can register with
either tracker.

As in the reference:

* Rendezvous is a **full-world barrier**: a round (start or recover)
  completes only when all ``world`` workers have registered, then
  everyone receives a complete topology in one reply.
* Tracker connections are one-shot: each command (start/recover/print/
  shutdown) is a fresh TCP connection.  The single exception is the
  heartbeat channel (``cmd=heartbeat``): one persistent connection per
  worker carrying periodic keepalives.  A worker whose beats stop for
  ``heartbeat_miss`` periods is declared dead (its parked registrant is
  evicted and ``on_dead`` tells the supervisor), a parked registrant
  whose socket closes is swept from the barrier, a round left partly
  filled for ``watchdog_sec`` calls ``on_stall``, and a job whose
  members all vanished without a goodbye is collected after
  ``job_gc_sec``.
* The ring is the plain rank cycle and the tree is the binary heap over
  ranks; :func:`rabit_tpu_torch.sched.topo.extra_link_peers` adds the
  halving/doubling, Swing and hierarchical peers to every linkset.
* Jobs are keyed by the ``job`` field of the worker hello (protocol
  ``MAGIC_JOB``; the classic hello lands in the ``default`` job), each
  with its own :class:`JobState`; every liveness verdict is scoped to
  its job.
* **Elastic membership** (``min_workers``/``max_workers``): a
  non-member ``cmd=start`` registrant is parked as a *joiner* (up to
  ``max_workers``), and a death — a heartbeat verdict, a registrant
  lost while parked, or the launcher's ``note_dead`` — becomes a
  *scale-down* (never below ``min_workers``).  Either sets a pending
  TARGET world.  Members learn of it at commit boundaries
  (``cmd=epoch`` polls) and re-register with ``cmd=rescale``; the round
  completes at the target, survivors keep their rank order, joiners
  compact onto the end (sorted by task_id), and the epoch in every
  topology reply is bumped.
* **Restartable control plane** (``state_dir``): every mutation is
  journaled through :class:`~rabit_tpu_torch.ckpt.CheckpointStore` in
  the reference's layout (a JSON object, sorted keys, CRC-stamped
  blob), so a tracker restarted on the same port — port or reference —
  replays it and the workers' retries bridge the gap.

* The **device plane's two commands** serve
  :mod:`rabit_tpu_torch.engine.xla`: ``formbar``, the formation barrier
  (u32 1 once every worker of the job posted, 0 once the barrier is
  aborted by a re-registration, the job's close or its timeout), and
  ``jaxsvc``, which hosts a ``torch.distributed.TCPStore`` for the
  job's world and replies its port (0 when none can be hosted).  The
  reply bytes are the reference's; what the port names differs on
  purpose: the reference hosts a JAX coordination service there.

Not ported yet, each with its ROADMAP item: obs telemetry (a heartbeat
channel's obs frames count as beats and their payload is dropped;
beats are never echoed), the adaptive controller, admission limits,
HTTP and the CLI (A8).  ``sched`` is "" and ``demoted`` is empty in
every reply.
"""
from __future__ import annotations

import collections
import json
import os
import selectors
import socket
import struct
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from rabit_tpu_torch import ckpt as ckpt_mod
from rabit_tpu_torch.sched import topo as sched_topo
from rabit_tpu_torch.sched import tuner as sched_tuner
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.utils.checks import log

DEFAULT_JOB = P.DEFAULT_JOB
# The reference's obs summary marker on the print channel
# (``rabit_tpu.obs.OBS_SUMMARY_PREFIX``): such a message is telemetry
# for the reference's obs report, which is not ported (ROADMAP A8).
_OBS_SUMMARY_PREFIX = "\x01rabit-obs1\x01"


def tree_neighbors(rank: int, world: int) -> tuple[int, list[int]]:
    """Binary-heap tree: returns (parent, [parent]+children neighbor list).

    Same shape as the reference's tree map (tracker/rabit_tracker.py:150-166).
    """
    parent = (rank - 1) // 2 if rank > 0 else P.NONE
    neighbors = []
    if rank > 0:
        neighbors.append(parent)
    for child in (2 * rank + 1, 2 * rank + 2):
        if child < world:
            neighbors.append(child)
    return parent, neighbors


def ring_neighbors(rank: int, world: int) -> tuple[int, int]:
    return ((rank - 1) % world, (rank + 1) % world)


@dataclass
class _Registrant:
    sock: socket.socket
    task_id: str
    host: str
    port: int
    cmd: str = P.CMD_START


@dataclass
class _HbPeer:
    """One worker's persistent heartbeat connection (CMD_HEARTBEAT)."""

    sock: socket.socket
    task_id: str
    period_s: float
    last: float                    # monotonic time of the last beat
    buf: bytearray = field(default_factory=bytearray)
    dead: bool = False             # declared dead by the deadline sweep
    bye: bool = False              # clean shutdown seen
    notified: float = 0.0          # last on_dead notification (rearm)
    obs: bool = False              # an obs frame was seen (logged once)


class JobState:
    """The control-plane state of ONE job (tenant) served by the
    tracker: rank map, membership, the rendezvous barrier, heartbeat
    peers and the liveness timeline.  Every mutation the tracker
    performs on behalf of a worker is scoped to the worker's job."""

    def __init__(self, tracker: "Tracker", name: str,
                 n_workers: int) -> None:
        self._tracker = tracker
        self.name = name
        self.n_workers = n_workers
        # Lifecycle: ``touched`` flips on the first admitted worker
        # command; ``done`` on unanimous goodbye or orphan GC — a done
        # incarnation holds nothing and a re-registration under the same
        # name is a NEW job submission.
        self.touched = False
        self.done = False
        self.last_activity = time.monotonic()
        self._rank_of: dict[str, int] = {}      # task_id -> stable rank
        # Tasks that finished (cmd=shutdown), keyed by task_id.
        self._shutdown_tasks: set[str] = set()
        # Membership (task_ids of the last completed round).  Empty
        # until the first round; from then on the job is done when every
        # member has shut down.
        self._members: set[str] = set()
        # task_ids that completed at least one rendezvous round: a fresh
        # cmd=start from one of these is a mid-job relaunch, flagged in
        # its topology reply.
        self._started_tasks: set[str] = set()
        # task_id -> monotonic time of its latest start/recover
        # registration: the launcher's evidence that a freshly started
        # life reached the rendezvous (Tracker.registered_at).
        self._registered_at: dict[str, float] = {}
        self._pending: list[_Registrant] = []
        self._round_started: float | None = None  # first registrant time
        self._pending_lock = threading.Lock()
        # Heartbeat failure detector state (protocol CMD_HEARTBEAT),
        # job-scoped: task ids are only unique within a job.
        self._hb_peers: dict[str, _HbPeer] = {}
        self._hb_seen: set[str] = set()  # tasks that ever heartbeat —
        # a SECOND channel for the same task is its relaunched life
        self._hb_lock = threading.Lock()
        # Job-scoped liveness/restart timeline.
        self._events: collections.deque = collections.deque(maxlen=2048)
        # -- elastic membership state ----------------------------------
        self._epoch = 0
        # Pending rescale: the next rendezvous round completes at this
        # world instead of n_workers (None = no rescale pending).
        self._target_world: int | None = None
        self._dead_tasks: set[str] = set()   # members seen dead, unresolved
        self._joiners: set[str] = set()      # parked non-member starts
        # Every task with an unresolved loss verdict of ANY kind
        # (heartbeat EOF or deadline, registrant sweep, supervisor
        # note_dead) — cleared by re-registration or a fresh heartbeat
        # channel.  The orphan GC's evidence that the job's members
        # vanished rather than went quiet.
        self._lost_tasks: set[str] = set()
        self._scale_lock = threading.Lock()
        # One thread runs _finish_round at a time (the accept loop on
        # round fill, the heartbeat monitor on a target change).
        self._round_lock = threading.Lock()
        self._committed_version = 0          # max version cmd=epoch reported
        # Keyed store ports (cmd=jaxsvc): every worker of THIS job asking
        # for the same key gets the same port; the stores themselves are
        # tracker-owned (kept until the tracker closes).
        self._jaxsvc_keyed: dict[str, int] = {}
        # Formation barrier (cmd=formbar), one-shot per job: "open" ->
        # "done" (everyone posted) | "aborted" (a relaunch registered, a
        # recover or rescale round started, the job closed, or the
        # barrier timed out).
        self._formbar_state = "open"
        self._formbar_socks: list[socket.socket] = []
        self._formbar_posted: set[str] = set()
        self._formbar_timer: threading.Thread | None = None
        self._formbar_lock = threading.Lock()
        # -- durable control-plane journal (state_dir) -----------------
        self._state_store: ckpt_mod.CheckpointStore | None = None
        self._state_seq = 0
        self._journal_lock = threading.Lock()

    # -- config (tracker-wide knobs, getattr-safe for bare objects) ----
    @property
    def _registrant_timeout(self) -> float:
        return getattr(self._tracker, "_registrant_timeout", 600.0)

    @property
    def _elastic(self) -> bool:
        return getattr(self._tracker, "_elastic", False)

    @property
    def _min_workers(self) -> int | None:
        return getattr(self._tracker, "_min_workers", None)

    @property
    def _max_workers(self) -> int | None:
        return getattr(self._tracker, "_max_workers", None)

    def _tag(self) -> str:
        """Log prefix: the default job keeps the pre-tenant wording."""
        return "" if self.name == DEFAULT_JOB else f" [job {self.name}]"

    # -- lifecycle -----------------------------------------------------
    def job_done(self) -> bool:
        """Job completion.  Before the first round completes the only
        coordinate is the launch count; after it, the job is done when
        every CURRENT member shut down (leavers dropped by a rescale
        owe no goodbye)."""
        if self._members:
            return self._members <= self._shutdown_tasks
        return len(self._shutdown_tasks) >= self.n_workers

    def orphaned(self, now: float) -> str | None:
        """GC predicate for a job whose last member vanished without a
        unanimous goodbye: returns the reason, or None while the job is
        (possibly) alive.  Evidence-based — a job with live heartbeat
        channels, parked registrants, or recent control-plane activity
        is never a candidate, and a job that never armed heartbeats is
        only collected once every member holds an explicit loss verdict
        (heartbeat EOF, registrant sweep, supervisor note_dead)."""
        if self.done or not self.touched:
            return None
        gc_sec = getattr(self._tracker, "_job_gc_sec", 30.0)
        if now - self.last_activity < gc_sec:
            return None
        with self._pending_lock:
            if self._pending:
                return None
        with self._hb_lock:
            if any(not p.dead for p in self._hb_peers.values()):
                return None
            hb_seen = bool(self._hb_seen)
        if not self._members:
            # Died before the first round ever completed: the only
            # evidence a worker existed at all is a loss verdict (the
            # registrant sweep reaped its parked socket) or a heartbeat
            # life that ended.  Without either, keep waiting — workers
            # may simply not have arrived yet.
            if self._lost_tasks or hb_seen:
                return ("every registrant lost before the first round "
                        "completed")
            return None
        accounted = (self._shutdown_tasks | self._lost_tasks
                     | self._dead_tasks)
        if self._members <= accounted:
            return "every member lost without a unanimous goodbye"
        if hb_seen:
            return (f"heartbeat channels gone and the job idle "
                    f"past {gc_sec:g}s")
        return None

    def close(self) -> None:
        """Drop this job's sockets (pending registrants, heartbeat
        channels) and release its formation barrier."""
        self._abort_formbar("job closing")
        with self._pending_lock:
            for reg in self._pending:
                try:
                    reg.sock.close()
                except OSError:
                    pass
            self._pending.clear()
            self._round_started = None
        with self._hb_lock:
            peers, self._hb_peers = dict(self._hb_peers), {}
        for peer in peers.values():
            try:
                peer.sock.close()
            except OSError:
                pass

    # -- elastic membership + durable journal --------------------------
    def _round_size(self) -> int:
        """How many registrants complete the current rendezvous round:
        the pending rescale target when one is set, else the world."""
        return (self._target_world if self._target_world is not None
                else self.n_workers)

    def _recompute_target(self) -> None:
        """(Re)derive the pending rescale target from membership deltas
        (joiners parked, members dead).  Scale-up needs ``max_workers``,
        scale-down needs ``min_workers`` and never undershoots it; a
        death the floor cannot absorb is left to the supervisor's
        same-rank relaunch path (target cleared).  A changed target
        re-checks round fullness — survivors may already be parked in a
        recover round that the new, smaller target completes."""
        if not self._elastic or not self._members:
            return
        with self._scale_lock:
            alive = self._members - self._dead_tasks
            target = len(alive)
            admitted = 0
            if self._max_workers is not None and self._joiners:
                admitted = min(len(self._joiners),
                               max(self._max_workers - target, 0))
                target += admitted
            if self._dead_tasks:
                if (self._min_workers is None or not alive
                        or target < self._min_workers):
                    target = None  # deaths the elastic floor can't absorb
            elif target == self.n_workers and not admitted:
                target = None  # nothing changed
            changed = target != self._target_world
            self._target_world = target
        if not changed:
            return
        if target is not None:
            log("tracker:%s rescale pending -> world %d (epoch %d -> %d; "
                "%d alive, %d dead, %d joiner(s))", self._tag(), target,
                self._epoch, self._epoch + 1, len(alive),
                len(self._dead_tasks), len(self._joiners))
            self._events.append({
                "ts": time.time(), "name": "epoch", "phase": "pending",
                "epoch": self._epoch + 1, "from_world": self.n_workers,
                "to_world": target})
        self._journal()
        self._maybe_finish_round()

    def _maybe_finish_round(self) -> None:
        """Complete the rendezvous round if the (possibly just-changed)
        target makes the parked registrants a full house."""
        with self._pending_lock:
            full = 0 < self._round_size() <= len(self._pending)
        if full:
            self._finish_round()

    def _journal(self) -> None:
        """Persist the control-plane state through the atomic ckpt-store
        machinery (tmp+fsync+rename, CRC-stamped, bounded retention) so
        a restarted tracker resumes exactly here.  The blob is the
        reference's JSON object; ``active_sched`` and ``demoted`` record
        the empty directive and demotion set every reply carries.
        Best-effort: a full disk degrades HA, it never kills the running
        job."""
        if self._state_store is None:
            return
        with self._journal_lock:
            # Snapshot with a bounded retry: the accept, heartbeat and
            # round threads mutate these containers without one global
            # state lock, and iterating a deque/set mid-mutation raises
            # RuntimeError — which must never escape into the serve
            # loop.  A lost race only skips THIS write; the mutation
            # that raced re-journals right behind it.
            for _ in range(3):
                try:
                    state = {
                        "job": self.name,
                        "done": self.done,
                        "epoch": self._epoch,
                        "world": self.n_workers,
                        "rank_of": dict(self._rank_of),
                        "started": sorted(self._started_tasks),
                        "shutdown": sorted(self._shutdown_tasks),
                        "members": sorted(self._members),
                        # Deaths already detected must survive a crash:
                        # a dead worker never reconnects to re-earn its
                        # verdict, so a restart that forgot these would
                        # recompute the target from "everyone alive"
                        # and stall the round on corpses.  _joiners are
                        # deliberately NOT journaled — a parked joiner's
                        # socket died with the old tracker and its
                        # retry re-admits it; a phantom restored joiner
                        # would hold a target slot nothing can fill.
                        "dead": sorted(self._dead_tasks),
                        "lost": sorted(self._lost_tasks),
                        "target_world": self._target_world,
                        "committed_version": self._committed_version,
                        "formbar_state": self._formbar_state,
                        "formbar_posted": sorted(self._formbar_posted),
                        "active_sched": {},
                        "demoted": [],
                        "events": list(self._events)[-512:],
                    }
                    blob = json.dumps(state, sort_keys=True).encode()
                    break
                except RuntimeError:
                    continue
            else:
                log("tracker:%s state journal snapshot kept racing "
                    "mutations; skipping this write", self._tag())
                return
            self._state_seq += 1
            seq = self._state_seq
            try:
                self._state_store.persist(seq, state["world"], blob)
            except OSError as e:
                log("tracker:%s state journal write failed (seq %d): %s",
                    self._tag(), seq, e)

    def attach_store(self, store: ckpt_mod.CheckpointStore) -> None:
        """Wire this job's journal store; the sequence continues above
        whatever a previous incarnation left on disk."""
        self._state_store = store
        self._state_seq = store.newest_version() or 0

    def restore_journal(self) -> bool:
        """Replay the newest valid journal entry (tracker restart on the
        same port), the port's or the reference's: rank map, epoch,
        membership, dead verdicts, pending target, committed version and
        the formation barrier resume where the dead incarnation left
        them; the liveness timeline survives.  A reference journal's
        adaptive directive is not replayed (ROADMAP A8).  Returns True
        when a journal was replayed."""
        dc = self._state_store.load_latest()
        if dc is None:
            return False
        try:
            state = json.loads(dc.global_blob.decode())
        except (ValueError, UnicodeDecodeError) as e:
            log("tracker:%s state journal unreadable (%s); starting "
                "fresh", self._tag(), e)
            return False
        self._state_seq = dc.version
        self.done = bool(state.get("done", False))
        self.n_workers = int(state.get("world", self.n_workers))
        self._epoch = int(state.get("epoch", 0))
        self._rank_of = {str(t): int(r)
                         for t, r in state.get("rank_of", {}).items()}
        self._started_tasks = set(state.get("started", []))
        self._shutdown_tasks = set(state.get("shutdown", []))
        self._members = set(state.get("members", []))
        self._dead_tasks = set(state.get("dead", []))
        self._lost_tasks = set(state.get("lost", []))
        tw = state.get("target_world")
        self._target_world = int(tw) if tw is not None else None
        self._committed_version = int(state.get("committed_version", 0))
        if state.get("active_sched") or state.get("demoted"):
            log("tracker:%s journal's adaptive directive %r / demoted %r "
                "not replayed (the adaptive controller is ROADMAP A8)",
                self._tag(), state.get("active_sched"),
                state.get("demoted"))
        self._formbar_state = state.get("formbar_state", "open")
        self._formbar_posted = set(state.get("formbar_posted", []))
        if (self._formbar_state == "open"
                and len(self._formbar_posted) >= self.n_workers):
            self._formbar_state = "done"  # resolved mid-crash
        for ev in state.get("events", []):
            self._events.append(ev)
        self._events.append({"ts": time.time(), "name": "tracker",
                             "phase": "restart", "epoch": self._epoch,
                             "world": self.n_workers})
        log("tracker:%s journal replayed (seq %d): world=%d epoch=%d "
            "members=%d committed_version=%d formbar=%s", self._tag(),
            dc.version, self.n_workers, self._epoch, len(self._members),
            self._committed_version, self._formbar_state)
        return True

    # -- formation barrier ---------------------------------------------
    def _formbar_post(self, sock: socket.socket, task_id: str) -> None:
        """See protocol.CMD_FORMBAR.  Parks the socket until the barrier
        resolves; posts after resolution get the resolved answer."""
        with self._formbar_lock:
            if self._formbar_state != "open":
                self._formbar_reply(sock, self._formbar_state == "done")
                return
            self._formbar_socks.append(sock)
            self._formbar_posted.add(task_id)
            if len(self._formbar_posted) >= self.n_workers:
                self._resolve_formbar_locked("done")
                self._journal()
                return
            if self._formbar_timer is None:
                self._formbar_timer = threading.Thread(
                    target=self._formbar_timeout, daemon=True)
                self._formbar_timer.start()
        # Journal each post: a tracker crash mid-barrier must not lose
        # who already arrived — the restarted tracker resumes the round
        # and the (re-)posts of the parked workers complete it.
        self._journal()

    @staticmethod
    def _formbar_reply(sock: socket.socket, proceed: bool) -> None:
        try:
            P.send_u32(sock, 1 if proceed else 0)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _resolve_formbar_locked(self, state: str) -> None:
        self._formbar_state = state
        socks, self._formbar_socks = self._formbar_socks, []
        for s in socks:
            self._formbar_reply(s, state == "done")

    def _abort_formbar(self, why: str) -> None:
        with self._formbar_lock:
            if self._formbar_state == "open" and (
                    self._formbar_socks or self._formbar_posted):
                log("tracker:%s aborting formation barrier (%s)",
                    self._tag(), why)
            if self._formbar_state == "open":
                self._resolve_formbar_locked("aborted")

    def _formbar_timeout(self) -> None:
        deadline = time.monotonic() + self._registrant_timeout
        while time.monotonic() < deadline:
            time.sleep(0.5)
            with self._formbar_lock:
                if self._formbar_state != "open":
                    return
        with self._formbar_lock:
            if self._formbar_state == "open":
                log("tracker:%s formation barrier timed out "
                    "(%d/%d posted); aborting formation", self._tag(),
                    len(self._formbar_posted), self.n_workers)
                self._resolve_formbar_locked("aborted")

    def keyed_store_service(self, key: str) -> int:
        """Device-plane store lookup for workers (cmd=jaxsvc), the
        counterpart of the reference's ``keyed_jax_service``.

        ``key == ""``: always a fresh store (each device-plane reform
        forms its group on a new one).  A non-empty key (the engine
        sends "init" at job start): create-or-get under one lock, so
        every worker of THIS job gets the SAME port and the first
        formation needs no worker-to-worker op — version span 0 holds
        only application ops, and a worker relaunched before the first
        checkpoint replays a span like the survivors'."""
        tr = self._tracker
        with tr._jaxsvc_lock:
            if key and key in self._jaxsvc_keyed:
                return self._jaxsvc_keyed[key]
            port = tr._fresh_store_locked(self.n_workers)
            if key and port:
                self._jaxsvc_keyed[key] = port
            return port

    # -- liveness / heartbeat ------------------------------------------
    def _emit_liveness(self, phase: str, task_id: str, **fields) -> None:
        """One control-plane liveness transition (alive / dead / lost /
        shutdown / relaunch) on the job's timeline."""
        ev = {"ts": time.time(), "name": "liveness", "phase": phase,
              "task": task_id}
        rank = self._rank_of.get(task_id)
        if rank is not None:
            ev["rank"] = rank
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        self._events.append(ev)

    def note_dead(self, task_id: str) -> None:
        """Supervisor-facing death notice: the launcher saw the worker
        process exit and will not relaunch it (elastic leave).
        Redundant when the heartbeat channel is armed — its EOF verdict
        fires first and ``_note_dead`` dedups — but the ONLY death
        signal the tracker gets in elastic mode without heartbeats.
        Liveness first, so the timeline orders the loss ahead of the
        scale-down it triggers.  Outside elastic mode the loss verdict
        is all it records (the orphan GC's evidence)."""
        self._lost_tasks.add(task_id)
        if not self._elastic or task_id in self._dead_tasks:
            return
        self._emit_liveness("lost", task_id, supervisor=1)
        self._evict_registrant(task_id, "supervisor reported it dead")
        self._note_dead(task_id)

    def _note_dead(self, task_id: str) -> None:
        """Elastic-mode death bookkeeping: a member seen dead is marked
        and the rescale target recomputed — scale-down instead of
        waiting for a same-rank relaunch.  Callers emit the liveness
        transition FIRST, so the timeline orders the death ahead of the
        epoch move it causes."""
        if not self._elastic or task_id not in self._members:
            return
        if task_id in self._dead_tasks:
            return
        self._dead_tasks.add(task_id)
        self._recompute_target()

    def _hb_register(self, sock: socket.socket, task_id: str,
                     period_ms: int) -> None:
        """A worker opened its persistent heartbeat channel; a fresh
        connection for a known task is its relaunched life."""
        sock.setblocking(False)
        peer = _HbPeer(sock, task_id, max(int(period_ms), 1) / 1000.0,
                       time.monotonic())
        with self._hb_lock:
            old = self._hb_peers.pop(task_id, None)
            relaunched = old is not None or task_id in self._hb_seen
            self._hb_seen.add(task_id)
            self._hb_peers[task_id] = peer
        if old is not None:
            try:
                old.sock.close()
            except OSError:
                pass
        log("tracker:%s heartbeat channel open for task %r "
            "(period %d ms%s)", self._tag(), task_id, period_ms,
            ", relaunched" if relaunched else "")
        self._emit_liveness("alive", task_id,
                            relaunched=1 if relaunched else None)
        self._lost_tasks.discard(task_id)
        if self._elastic and task_id in self._dead_tasks:
            # Back from the dead (relaunch beat the scale-down): the
            # pending target stops counting it out.
            self._dead_tasks.discard(task_id)
            self._recompute_target()

    def _hb_forget(self, peer: _HbPeer) -> None:
        with self._hb_lock:
            if self._hb_peers.get(peer.task_id) is peer:
                del self._hb_peers[peer.task_id]
        try:
            peer.sock.close()
        except OSError:
            pass

    def _hb_drain(self, peer: _HbPeer, now: float) -> None:
        """Consume whatever beats arrived on one heartbeat socket."""
        try:
            data = peer.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            # EOF/RST without the bye: the process died.  The launcher
            # watches the process directly, so no on_dead escalation —
            # but the transition belongs in the timeline.
            # No registrant eviction here: the dead process's parked
            # rendezvous socket EOFs too and the registrant sweep reaps
            # it, while a late-drained EOF must never close a freshly
            # relaunched life's registrant parked under the same task.
            self._hb_forget(peer)
            if not peer.bye and not peer.dead \
                    and not self._tracker._stopped:
                log("tracker:%s heartbeat channel for task %r lost (EOF)",
                    self._tag(), peer.task_id)
                self._emit_liveness("lost", peer.task_id)
                self._lost_tasks.add(peer.task_id)
                # Elastic mode: a SIGKILL'd/preempted worker EOFs its
                # channel instantly and never earns a deadline verdict —
                # this IS the death signal that triggers scale-down.
                self._note_dead(peer.task_id)
            return
        peer.buf += data
        while len(peer.buf) >= 4:
            (beat,) = struct.unpack_from("<I", peer.buf)
            if beat == P.HEARTBEAT_OBS:
                # Telemetry frame multiplexed onto the beat stream:
                # sentinel, u32 length, JSON payload.  Incomplete
                # frames wait in peer.buf for the next drain.
                if len(peer.buf) < 8:
                    break
                (ln,) = struct.unpack_from("<I", peer.buf, 4)
                if ln > P.MAX_PRINT_LEN:
                    log("tracker:%s oversized obs frame (%d bytes) from "
                        "task %r; dropping the heartbeat channel",
                        self._tag(), ln, peer.task_id)
                    self._hb_forget(peer)
                    return
                if len(peer.buf) < 8 + ln:
                    break
                del peer.buf[:8 + ln]
                peer.last = now   # a frame proves liveness like a beat
                self.last_activity = time.monotonic()
                if not peer.obs:
                    # Live telemetry is not ported (ROADMAP A8): the
                    # payload is dropped and beats are never echoed,
                    # which a streaming worker reads as "no rtt
                    # samples".
                    peer.obs = True
                    log("tracker:%s obs frames from task %r dropped (obs "
                        "is not ported: ROADMAP A8)", self._tag(),
                        peer.task_id)
                continue
            del peer.buf[:4]
            if beat == P.HEARTBEAT_BYE:
                peer.bye = True
                self._hb_forget(peer)
                self._emit_liveness("shutdown", peer.task_id)
                return
            peer.last = now
            if peer.dead:
                # Beats resumed after a dead verdict (a SIGCONT'd rank
                # the supervisor has not reaped yet): record the flap;
                # the supervisor's kill remains in flight.
                peer.dead = False
                log("tracker:%s task %r resumed heartbeats after a dead "
                    "verdict", self._tag(), peer.task_id)
                self._emit_liveness("alive", peer.task_id, resumed=1)
                self._lost_tasks.discard(peer.task_id)
                if self._elastic and peer.task_id in self._dead_tasks:
                    # The scale-down verdict is withdrawn: the rank is
                    # demonstrably alive on the SAME channel (no
                    # relaunch happened), so it keeps its membership.
                    self._dead_tasks.discard(peer.task_id)
                    self._recompute_target()

    def _hb_mark_dead(self, peer: _HbPeer, phase: str, why: str) -> None:
        """Deadline verdict: evict the corpse from the barrier and tell
        the supervisor.  Re-notifies every miss budget while the verdict
        stands, so a supervisor that skipped a kill (restart grace) gets
        another chance instead of the job wedging."""
        tracker = self._tracker
        renotify = max(peer.period_s * tracker._hb_miss, 0.5)
        now = time.monotonic()
        if peer.dead and now - peer.notified < renotify:
            return
        first = not peer.dead
        peer.dead = True
        peer.notified = now
        if first:
            log("tracker:%s task %r declared dead by the heartbeat sweep "
                "(%s)", self._tag(), peer.task_id, why)
            self._emit_liveness(phase, peer.task_id, why=why)
            self._lost_tasks.add(peer.task_id)
            # Evict only on the FIRST verdict: no EOF means the hung
            # process is still alive holding its sockets, so a parked
            # registrant is provably the hung life's own.  A re-notify
            # runs after the supervisor's kill — by then the task's
            # NEXT life may already be parked, and closing its socket
            # would abort the very relaunch the kill arranged.
            self._evict_registrant(peer.task_id, why)
            # Elastic mode: the liveness verdict above precedes this —
            # scale-down is its consequence on the timeline.
            self._note_dead(peer.task_id)
        if tracker._on_dead is not None:
            try:
                tracker._on_dead(peer.task_id)
            except Exception as e:  # noqa: BLE001 — detector must survive
                log("tracker:%s on_dead callback failed: %s",
                    self._tag(), e)

    def _evict_registrant(self, task_id: str, why: str) -> None:
        """Drop a dead task's PARKED rendezvous registrant so the round
        re-opens (the hung-but-connected sibling of the EOF-based
        registrant sweep: a SIGSTOP'd rank keeps its sockets open, so
        only the heartbeat verdict can evict it)."""
        with self._pending_lock:
            if len(self._pending) >= self._round_size():
                return  # full round: the reply loop owns these sockets
            lost = [r for r in self._pending if r.task_id == task_id]
            if not lost:
                return
            self._pending = [r for r in self._pending
                             if r.task_id != task_id]
            if not self._pending:
                self._round_started = None
        for reg in lost:
            log("tracker:%s evicted registrant task %r from the "
                "rendezvous barrier (%s); the round re-opens for its "
                "relaunch", self._tag(), reg.task_id, why)
            try:
                reg.sock.close()
            except OSError:
                pass

    def sweep_registrants_once(self) -> None:
        """One pass of the dead-registrant sweep: drop EOF'd parked
        registrants so a partially-filled round re-opens instead of
        wedging the survivors (see Tracker._sweep_registrants)."""
        with self._pending_lock:
            if (not self._pending
                    or len(self._pending) >= self._round_size()):
                return
            socks = [r.sock for r in self._pending]
        # selectors (epoll/poll), not select.select: fds above
        # FD_SETSIZE would make select raise on every pass and
        # silently disable the sweep for big/long-lived jobs.
        sel = selectors.DefaultSelector()
        try:
            for s in socks:
                try:
                    sel.register(s, selectors.EVENT_READ)
                except (OSError, ValueError):
                    continue  # closed under us; next sweep re-checks
            ready = [key.fileobj for key, _ in sel.select(0)]
        finally:
            sel.close()
        dead = set()
        for s in ready:
            try:
                if s.recv(1, socket.MSG_PEEK) == b"":
                    dead.add(s)
            except OSError:
                dead.add(s)
        if not dead:
            return
        with self._pending_lock:
            if len(self._pending) >= self._round_size():
                return  # round filled meanwhile: let it reply
            lost = [r for r in self._pending if r.sock in dead]
            self._pending = [r for r in self._pending
                             if r.sock not in dead]
            if not self._pending:
                self._round_started = None
        for reg in lost:
            log("tracker:%s registrant task %r (cmd=%s) lost during "
                "the rendezvous barrier; dropping it and re-opening "
                "the round (its restart will re-register)",
                self._tag(), reg.task_id, reg.cmd)
            # Liveness BEFORE any membership/topology consequence:
            # the timeline must order the loss causally ahead of the
            # rescale/round it triggers.
            self._emit_liveness("lost", reg.task_id, barrier=1)
            self._lost_tasks.add(reg.task_id)
            try:
                reg.sock.close()
            except OSError:
                pass
            if self._elastic:
                if reg.task_id in self._joiners:
                    # A joiner that died while parked stops holding
                    # a slot in the pending target.
                    self._joiners.discard(reg.task_id)
                    self._recompute_target()
                elif reg.task_id in self._members:
                    self._note_dead(reg.task_id)

    # -- rendezvous ----------------------------------------------------
    def register(self, sock: socket.socket, cmd: str, task_id: str,
                 host: str, port: int) -> None:
        """Park one start/recover/rescale registrant in this job's
        rendezvous barrier (and complete the round if it fills)."""
        self.last_activity = time.monotonic()
        self._registered_at[task_id] = self.last_activity
        self._lost_tasks.discard(task_id)
        # Any recover/rescale round, or a fresh start from a task that
        # already ran, means the membership moved: an open formation
        # barrier can never complete — release it as aborted so no
        # survivor walks into the doomed device-group formation.
        if cmd != P.CMD_START or task_id in self._started_tasks:
            self._abort_formbar("task %r re-registered (cmd=%s)"
                                % (task_id, cmd))
            if cmd == P.CMD_START:
                # A mid-job relaunch re-registering: a restart event
                # for the liveness timeline.
                self._emit_liveness("relaunch", task_id)
        # Registered: the socket now waits on the barrier, not on a
        # half-read message — lift the handshake timeout.
        sock.settimeout(self._registrant_timeout)
        # A re-registration from the same task replaces its stale entry
        # (e.g. worker crashed after registering, restarted mid-round).
        with self._pending_lock:
            stale = [r for r in self._pending if r.task_id == task_id]
            for r in stale:
                try:
                    r.sock.close()
                except OSError:
                    pass
            self._pending = [r for r in self._pending
                             if r.task_id != task_id]
            if not self._pending:
                self._round_started = time.monotonic()
            self._pending.append(
                _Registrant(sock, task_id, host, port, cmd))
        if self._elastic:
            if task_id in self._dead_tasks:
                # A presumed-dead member registered — ANY cmd proves
                # life (a supervisor relaunch's fresh start, or a live
                # member whose abandoned registration socket the sweep
                # mistook for a death retrying its recover/rescale) —
                # so it must not stay counted out of the pending target.
                self._dead_tasks.discard(task_id)
                self._recompute_target()
            elif (cmd == P.CMD_START
                    and self._members and task_id not in self._members
                    and self._max_workers is not None):
                # Late joiner: parks until a rescale round admits it.
                if task_id not in self._joiners:
                    self._joiners.add(task_id)
                    self._emit_liveness("join_request", task_id)
                    self._recompute_target()
        self._maybe_finish_round()

    def _assign_ranks(self, regs: list[_Registrant] | None = None) -> None:
        # Shuffle the free-rank pool before handing ranks to NEW task
        # ids (the reference shuffles its todo_nodes for load balance,
        # tracker/rabit_tracker.py:242): arrival order otherwise
        # correlates host startup speed with tree position.  Restarted
        # tasks keep their old rank regardless (stable-rank contract).
        # RABIT_TRACKER_SHUFFLE=0 restores plain arrival order.
        #
        # RABIT_TRACKER_PIN_RANKS=1: a task_id that is a decimal integer
        # in [0, n_workers) CLAIMS that rank (the mixed-mode alignment
        # knob, doc/scaling.md).
        import random

        if regs is None:
            regs = self._pending
        used = set(self._rank_of.values())
        if os.environ.get("RABIT_TRACKER_PIN_RANKS", "0") in (
                "1", "true", "yes"):
            for reg in regs:
                tid = reg.task_id
                if tid not in self._rank_of and tid.isdecimal():
                    r = int(tid)
                    if r < self.n_workers and r not in used:
                        self._rank_of[tid] = r
                        used.add(r)
        free = [r for r in range(self.n_workers) if r not in used]
        if os.environ.get("RABIT_TRACKER_SHUFFLE", "1") not in (
                "0", "false", "no"):
            random.shuffle(free)
        it = iter(free)
        for reg in regs:
            if reg.task_id not in self._rank_of:
                self._rank_of[reg.task_id] = next(it)

    def _assign_ranks_rescale(self, regs: list[_Registrant],
                              world: int) -> None:
        """Deterministic rank reassignment for a rescale round:
        surviving members keep their relative (old-rank) order — a pure
        scale-up moves nobody — and joiners follow, sorted by task_id,
        compacting the rank space to exactly ``[0, world)``."""
        old = sorted((r for r in regs if r.task_id in self._rank_of),
                     key=lambda r: self._rank_of[r.task_id])
        new = sorted((r for r in regs if r.task_id not in self._rank_of),
                     key=lambda r: r.task_id)
        self._rank_of = {reg.task_id: i for i, reg in enumerate(old + new)}
        assert len(self._rank_of) == world

    def _select_round_locked(self, world: int
                             ) -> tuple[list[_Registrant],
                                        list[_Registrant]]:
        """Pick which parked registrants form this round (caller holds
        ``_pending_lock``).  Normally everyone; when MORE are parked
        than the round admits (joiners beyond ``max_workers``), members
        and already-ranked tasks go first, then joiners by task_id —
        the extras stay parked for a later epoch."""
        pending = list(self._pending)
        if len(pending) <= world:
            return pending, []
        core = [r for r in pending
                if not self._members or r.task_id in self._members
                or r.task_id in self._rank_of]
        rest = sorted((r for r in pending if r not in core),
                      key=lambda r: r.task_id)
        chosen = (core + rest)[:world]
        chosen_ids = {id(r) for r in chosen}
        extras = [r for r in pending if id(r) not in chosen_ids]
        return chosen, extras

    def _topo_groups(self, by_rank: dict, world: int) -> list[int]:
        """Host-group handout for the topology-aware schedules: one
        group id per rank.  Ranks whose registrants advertised the same
        host share an id; ``RABIT_TRACKER_GROUPS`` ("0,0,1,1" by rank)
        overrides for tests and explicit pinning.  Ids are dense in
        first-seen rank order, so the handout is deterministic for a
        given rank map — a recover round reproduces it exactly."""
        raw = os.environ.get("RABIT_TRACKER_GROUPS", "").strip()
        if raw:
            try:
                ids = [int(x) for x in raw.replace(";", ",").split(",")
                       if x.strip() != ""]
            except ValueError:
                ids = []
            # Ids travel as wire u32s: range-check here so a bad
            # override is ignored with a log line instead of a
            # struct.error mid-handout.
            if len(ids) == world and all(0 <= g < (1 << 32)
                                         for g in ids):
                return ids
            log("tracker: RABIT_TRACKER_GROUPS %r invalid for world %d "
                "(need %d comma-separated u32 ids); ignoring",
                raw, world, world)
        seen: dict[str, int] = {}
        return [seen.setdefault(by_rank[rank].host, len(seen))
                for rank in range(world)]

    def _finish_round(self) -> None:
        """All workers registered: compute topology, reply to everyone.

        A worker dying between registering and its reply must not wedge
        the tracker: its send failure drops only that registrant (it
        will re-register on restart) while every other socket is still
        replied to and closed.  Survivors that already got a topology
        naming the dead worker will fail link setup and come back with
        cmd=recover.

        When a rescale target is pending the round IS the rescale: it
        completed at the target world, so membership, ranks and the
        epoch move here — liveness events for the deaths/joins that
        caused it were already emitted, so the timeline orders cause
        before effect.
        """
        with self._round_lock:
            # One consistent read of the pending target decides BOTH
            # the round size and whether this round is a rescale: a
            # concurrent _recompute_target must not make them disagree
            # and ship a topology whose world and rank space come from
            # different targets.  A target that changes after this read
            # opens the next round (_admit_parked below re-derives it).
            with self._scale_lock:
                target = self._target_world
            rescale = target is not None
            world = target if rescale else self.n_workers
            with self._pending_lock:
                if not 0 < world <= len(self._pending):
                    return  # raced: another thread already served it
                regs, extras = self._select_round_locked(world)
                self._pending = extras
                self._round_started = (time.monotonic() if extras
                                       else None)
            if rescale:
                old_world, old_epoch = self.n_workers, self._epoch
                self._assign_ranks_rescale(regs, world)
                self.n_workers = world
                self._epoch += 1
                members = {r.task_id for r in regs}
                with self._scale_lock:
                    self._target_world = None
                    self._dead_tasks &= members
                    self._lost_tasks &= members
                    self._joiners -= members
                log("tracker:%s rescale complete — world %d -> %d, epoch "
                    "%d -> %d (%d member(s))", self._tag(), old_world,
                    world, old_epoch, self._epoch, len(members))
                self._events.append({
                    "ts": time.time(), "name": "epoch", "phase": "rescale",
                    "epoch": self._epoch, "from_world": old_world,
                    "to_world": world})
            else:
                self._assign_ranks(regs)
                members = {r.task_id for r in regs}
            by_rank = {self._rank_of[r.task_id]: r for r in regs}
            addr = {rk: (reg.host, reg.port) for rk, reg in by_rank.items()}
            groups = self._topo_groups(by_rank, world)
            # No adaptive controller here: no demotions, an empty
            # directive.
            demoted: list[int] = []
            directive = sched_tuner.encode_directive({})
            for rank, reg in sorted(by_rank.items()):
                parent, neighbors = tree_neighbors(rank, world)
                rp, rn = ring_neighbors(rank, world)
                # Beyond the tree/ring links, wire every peer the
                # topology-aware schedules can ask for (halving/doubling
                # XOR partners, Swing hops, hierarchical leader links),
                # computed from the SAME functions the engine-side
                # applies() checks consult (sched/topo.py).
                extra = sched_topo.extra_link_peers(rank, world, groups,
                                                    demoted)
                linkset = sorted(set(neighbors + list(extra)
                                     + ([rp, rn] if world > 1 else [])))
                linkset = [r for r in linkset if r != rank]
                # Deterministic direction: connect to lower ranks,
                # accept higher.
                connect = [(r, addr[r][0], addr[r][1])
                           for r in linkset if r < rank]
                naccept = sum(1 for r in linkset if r > rank)
                relaunched = int(reg.cmd == P.CMD_START
                                 and reg.task_id in self._started_tasks)
                reply = P.TopologyReply(
                    rank=rank, world=world, parent=parent,
                    neighbors=neighbors, ring_prev=rp, ring_next=rn,
                    connect=connect, naccept=naccept,
                    relaunched=relaunched, epoch=self._epoch,
                    groups=groups, sched=directive, demoted=demoted)
                try:
                    reply.send(reg.sock)
                    # Mark "completed a round" only on a delivered
                    # reply: a worker that died before receiving its
                    # first topology never ran with it, so its restart
                    # is a fresh start, not a mid-job relaunch.
                    self._started_tasks.add(reg.task_id)
                except OSError as e:
                    log("tracker:%s worker rank %d died before its "
                        "reply: %s", self._tag(), rank, e)
                try:
                    reg.sock.close()
                except OSError:
                    pass
            self._members = members
            self._journal()
        # Registrants still parked after ANY completed round open the
        # next epoch's target: joiners beyond max_workers, joiners that
        # arrived before the FIRST round completed (membership was
        # empty, so the admission branch could not see them), and
        # members a concurrent target change dropped from this round.
        self._admit_parked()

    def _admit_parked(self) -> None:
        """Sweep the still-parked registrants into the joiner set and
        re-derive the pending rescale target.  Runs after every
        completed round — without it, a cmd=start that raced the round
        it missed would sit parked until its registration socket times
        out instead of being admitted at the next commit boundary."""
        if not self._elastic:
            return
        if self._max_workers is not None:
            # cmd=start: ordinary late joiners.  cmd=rescale from a
            # NON-member: a worker a concurrent target change dropped
            # from the round it re-registered for — it rejoins at the
            # next epoch rather than stalling out its parked socket.
            with self._pending_lock:
                parked = [r.task_id for r in self._pending
                          if r.cmd in (P.CMD_START, P.CMD_RESCALE)
                          and r.task_id not in self._members]
            fresh = [t for t in parked if t not in self._joiners]
            for tid in fresh:
                self._joiners.add(tid)
                self._emit_liveness("join_request", tid)
        self._recompute_target()


class Tracker:
    """Accepts worker connections and serves rendezvous rounds — for
    one job or several concurrent named jobs."""

    def __init__(self, n_workers: int, host: str = "127.0.0.1", port: int = 0,
                 watchdog_sec: float | None = None,
                 on_stall: Optional[Callable[[set, set], None]] = None,
                 registrant_timeout_sec: float | None = None,
                 heartbeat_miss: float | None = None,
                 on_dead: Optional[Callable[[str], None]] = None,
                 job_gc_sec: float | None = None,
                 min_workers: int | None = None,
                 max_workers: int | None = None,
                 state_dir: str | None = None):
        """``n_workers`` is the DEFAULT job's world size (and the world
        assumed for a named job whose first registrant sent no world
        hint).

        ``watchdog_sec``: if a rendezvous round stays *partially*
        registered this long, the tracker calls ``on_stall(present_task_
        ids, finished_task_ids)`` so the launcher can kill/restart the
        silent workers — a hung (SIGSTOP'd, wedged) rank is then
        replaced in seconds instead of holding the barrier for the full
        link timeout.

        ``registrant_timeout_sec``: socket timeout applied to
        registered rendezvous sockets; it bounds the tracker's blocking
        SENDS when a round completes, not the barrier wait itself (a
        partially-filled round is bounded by the stall watchdog).
        Defaults to ``RABIT_TIMEOUT_SEC`` (else 600 s).

        ``heartbeat_miss`` / ``on_dead``: the proactive heartbeat
        failure detector.  Workers launched with ``rabit_heartbeat_sec``
        keep one persistent CMD_HEARTBEAT connection each; a worker
        whose beats stop for ``heartbeat_miss`` periods (default 3, env
        ``RABIT_HEARTBEAT_MISS``, at least 1) is declared dead: its
        parked rendezvous registrant (if any) is evicted so the round
        re-opens, the liveness transition lands in the job's timeline,
        and ``on_dead(task_id)`` tells the supervisor to kill/relaunch
        it — all without any collective op having to touch the corpse
        first.

        ``job_gc_sec`` (env ``RABIT_JOB_GC_SEC``, default 30): how long
        a job must sit idle — no parked registrants, no live heartbeat
        channels, every member holding a loss verdict or goodbye —
        before the orphan sweep collects it.

        ``min_workers`` / ``max_workers``: enable **elastic
        membership** (per job).  With ``max_workers`` set, late
        ``cmd=start`` registrants beyond a job's current membership are
        admitted as joiners (pending rescale epoch at the next commit
        boundary); with ``min_workers`` set, a member's death
        (heartbeat verdict, lost registrant, ``note_dead``) triggers a
        scale-*down* rescale instead of waiting for a same-rank
        relaunch — never below the floor.  Leaving both ``None``
        freezes each job's world at its registration size.

        ``state_dir``: journal the control-plane state through the
        atomic :class:`~rabit_tpu_torch.ckpt.CheckpointStore` tier so a
        restarted tracker (same port) resumes every in-flight job.  The
        default job journals at the ``state_dir`` root; named jobs
        journal under ``state_dir/<job>/``, and a restart replays ALL
        of them."""
        self._default_world = n_workers
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(256)
        self.host, self.port = self._listener.getsockname()
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._watchdog_sec = watchdog_sec
        self._on_stall = on_stall
        if registrant_timeout_sec is None:
            try:
                registrant_timeout_sec = float(
                    os.environ.get("RABIT_TIMEOUT_SEC", 600))
            except ValueError:
                registrant_timeout_sec = 600.0
        self._registrant_timeout = max(float(registrant_timeout_sec), 1.0)
        if heartbeat_miss is None:
            try:
                heartbeat_miss = float(
                    os.environ.get("RABIT_HEARTBEAT_MISS", 3))
            except ValueError:
                heartbeat_miss = 3.0
        self._hb_miss = max(float(heartbeat_miss), 1.0)
        self._on_dead = on_dead
        # Tracker-hosted device-plane stores (cmd=jaxsvc).  Old epochs'
        # stores are kept until the tracker closes: a degraded member
        # may still hold a client of one.  One per re-formation,
        # bounded by the job's failure count.  The stores are
        # tracker-owned; the keyed create-or-get maps are per job.
        self._jaxsvcs: list = []
        self._jaxsvc_lock = threading.Lock()
        if job_gc_sec is None:
            try:
                job_gc_sec = float(os.environ.get("RABIT_JOB_GC_SEC", 30))
            except ValueError:
                job_gc_sec = 30.0
        self._job_gc_sec = max(float(job_gc_sec), 0.5)
        # -- elastic membership config (applies to every job) ----------
        self._min_workers = min_workers
        self._max_workers = max_workers
        self._elastic = min_workers is not None or max_workers is not None
        self._jobs_lock = threading.Lock()
        self._jobs: dict[str, JobState] = {
            DEFAULT_JOB: JobState(self, DEFAULT_JOB, n_workers)}
        self._jobs_touched = 0     # jobs that ever admitted a worker
        # -- durable control-plane journal (state_dir) -----------------
        self._state_base = str(state_dir) if state_dir else None
        if self._state_base:
            default = self._default_job()
            default.attach_store(ckpt_mod.CheckpointStore(
                self._state_base, rank=0, keep=3))
            if default.restore_journal():
                self._mark_restored(default)
            self._restore_named_jobs()
        if watchdog_sec is not None and on_stall is not None:
            threading.Thread(target=self._watchdog, daemon=True).start()
        # Registrant-loss sweep: a worker that dies while PARKED in the
        # rendezvous barrier must not keep holding a slot (see
        # JobState.sweep_registrants_once); the same cadence runs job
        # completion/orphan GC.
        threading.Thread(target=self._sweep_registrants,
                         daemon=True).start()
        threading.Thread(target=self._hb_monitor, daemon=True).start()

    # -- job registry --------------------------------------------------
    def _default_job(self) -> JobState:
        with self._jobs_lock:
            return self._jobs[DEFAULT_JOB]

    def _job_list(self) -> list[JobState]:
        with self._jobs_lock:
            return list(self._jobs.values())

    def _live_jobs(self) -> list[JobState]:
        """Jobs the background sweeps must watch: everything not done
        (a heartbeat channel can exist before the job's first
        registration is admitted)."""
        with self._jobs_lock:
            return [j for j in self._jobs.values() if not j.done]

    def _job_get(self, name: str) -> JobState | None:
        """The current live incarnation of a job, or None (unknown or
        already finished)."""
        with self._jobs_lock:
            job = self._jobs.get(name)
        return None if job is None or job.done else job

    def _mark_restored(self, job: JobState) -> None:
        """A journal replayed at startup: the job is mid-flight (it
        only has a journal because workers registered)."""
        if not job.touched:
            job.touched = True
            self._jobs_touched += 1

    def _restore_named_jobs(self) -> None:
        """Replay every named job's journal under ``state_dir/<job>/``
        (the default job's lives at the root).  Finished jobs are left
        on disk but not resurrected."""
        try:
            names = sorted(os.listdir(self._state_base))
        except OSError:
            return
        for name in names:
            sub = os.path.join(self._state_base, name)
            if (name == DEFAULT_JOB or not P.valid_job_id(name)
                    or not os.path.isdir(sub)):
                continue
            job = JobState(self, name, self._default_world)
            try:
                job.attach_store(ckpt_mod.CheckpointStore(
                    sub, rank=0, keep=3))
            except OSError as e:
                log("tracker: cannot open job %r journal under %s: %s",
                    name, sub, e)
                continue
            if job.restore_journal() and not job.done:
                with self._jobs_lock:
                    self._jobs[name] = job
                self._mark_restored(job)

    def _admit(self, name: str, world_hint: int) -> JobState:
        """Resolve a registration's job, creating a fresh incarnation
        when none is live.  A named job's world comes from its first
        registrant's hint; the default job (and hint-less registrants)
        use the tracker's configured world."""
        fresh = False
        with self._jobs_lock:
            job = self._jobs.get(name)
            if job is not None and job.done:
                job = None
            if job is None:
                world = (world_hint if world_hint > 0
                         and name != DEFAULT_JOB else self._default_world)
                job = JobState(self, name, world)
                self._jobs[name] = job
                fresh = True
            if not job.touched:
                job.touched = True
                self._jobs_touched += 1
                job._events.append({
                    "ts": time.time(), "name": "job", "phase": "created",
                    "job": job.name, "world": job.n_workers})
                log("tracker: job %r admitted (world %d)", job.name,
                    job.n_workers)
        if fresh and self._state_base:
            # Journal store creation does disk I/O (makedirs, stale-tmp
            # sweep): done OUTSIDE _jobs_lock so one tenant's slow
            # storage cannot stall every co-tenant's command dispatch.
            # Only the accept thread admits jobs, so nobody races the
            # late attach; journal writes before it simply skip.
            sub = (self._state_base if name == DEFAULT_JOB
                   else os.path.join(self._state_base, name))
            try:
                job.attach_store(ckpt_mod.CheckpointStore(
                    sub, rank=0, keep=3))
            except OSError as e:
                log("tracker: job %r journal unavailable (%s); "
                    "running without HA for it", name, e)
        return job

    def _finish_job(self, job: JobState, phase: str) -> None:
        """Complete a job's lifecycle (unanimous goodbye or orphan GC):
        drop its sockets and wake the serve loop if it was the last
        one."""
        with self._jobs_lock:
            if job.done:
                return
            job.done = True
        log("tracker:%s job %s (%d member(s), %d shutdown)",
            job._tag() or " [job default]", phase, len(job._members),
            len(job._shutdown_tasks))
        job._events.append({"ts": time.time(), "name": "job",
                            "phase": phase, "job": job.name,
                            "world": job.n_workers})
        job.close()
        job._journal()
        if self._service_done():
            self._wake_accept()

    def _service_done(self) -> bool:
        """Serve-loop exit condition: at least one job ever admitted a
        worker and every admitted job has finished.  (A tracker that
        never saw a worker keeps waiting.)"""
        with self._jobs_lock:
            if self._jobs_touched == 0:
                return False
            return all(j.done for j in self._jobs.values() if j.touched)

    def _wake_accept(self) -> None:
        """Nudge the accept loop so it re-checks the exit condition —
        job completion can happen on a sweep thread while run() is
        blocked in accept()."""
        host = self.host if self.host not in ("0.0.0.0", "::") \
            else "127.0.0.1"
        try:
            socket.create_connection((host, self.port), timeout=2).close()
        except OSError:
            pass

    # -- public --------------------------------------------------------
    @property
    def uri(self) -> str:
        return self.host

    @property
    def n_workers(self) -> int:
        """The default job's world size."""
        return self._default_job().n_workers

    def worker_env(self, task_id: str,
                   job: str | None = None) -> dict[str, str]:
        """Environment for a worker process launched under this tracker.
        ``job`` names the tenant (default: the default job)."""
        world = self.n_workers
        env = {
            "RABIT_TRACKER_URI": self.host,
            "RABIT_TRACKER_PORT": str(self.port),
            "RABIT_TASK_ID": str(task_id),
        }
        if job and job != DEFAULT_JOB:
            env["RABIT_JOB_ID"] = str(job)
            j = self._job_get(str(job))
            if j is not None:
                world = j.n_workers
        env["RABIT_WORLD_SIZE"] = str(world)
        return env

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def join(self, timeout: float | None = None) -> None:
        assert self._thread is not None
        self._thread.join(timeout)

    def run(self) -> None:
        """Serve until every admitted job has completed (or stop() is
        called)."""
        while not self._service_done() and not self._stopped:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                break
            # Bound the handshake so one silent client can't stall the
            # whole control plane; barrier waits happen after _handle.
            sock.settimeout(30)
            try:
                self._handle(sock)
            except (ConnectionError, OSError) as e:
                # A worker dying mid-handshake is survivable: drop it from
                # the pending barrier; it will re-register on restart.
                log("tracker: dropped connection during handshake: %s", e)
                for job in self._job_list():
                    with job._pending_lock:
                        job._pending = [r for r in job._pending
                                        if r.sock is not sock]
                try:
                    sock.close()
                except OSError:
                    pass
        self._close_all()

    def stop(self) -> None:
        """Abort the tracker (e.g. the launcher saw a permanent worker
        failure).  Pending workers get connection resets and fail fast
        instead of sitting in the rendezvous barrier."""
        self._stopped = True
        try:
            # Unblock accept(): on Linux, closing a listener does not
            # wake a thread blocked in accept() on it (the reference's
            # stop() leaves run() blocked); shutting it down does.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    @property
    def epoch(self) -> int:
        """Default job's membership epoch (bumped per completed rescale
        round)."""
        return self._default_job()._epoch

    @property
    def committed_version(self) -> int:
        """Max checkpoint version any default-job worker reported via
        cmd=epoch."""
        return self._default_job()._committed_version

    def registered_at(self, task_id: str,
                      job: str | None = None) -> float | None:
        """Monotonic time of a task's latest start/recover registration
        in ``job`` (None = the default job), or None if it never
        registered: how the launcher's stall killer tells a life that
        is still starting from one that registered and then hung."""
        with self._jobs_lock:
            j = self._jobs.get(job or DEFAULT_JOB)
        return None if j is None else j._registered_at.get(task_id)

    def note_dead(self, task_id: str, job: str | None = None) -> None:
        """Supervisor-facing death notice (see JobState.note_dead).
        ``job`` names the tenant (None = the default job)."""
        j = self._job_get(job or DEFAULT_JOB)
        if j is not None:
            j.note_dead(task_id)

    def _close_all(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
        with self._jaxsvc_lock:
            # a TCPStore has no close: dropping the last reference stops
            # its server
            self._jaxsvcs = []
        for job in self._job_list():
            job.close()

    def _fresh_store_locked(self, world: int) -> int:
        """Host a fresh ``torch.distributed.TCPStore`` for one job's
        world and return its port, or 0 when none can be hosted.  Caller
        holds ``_jaxsvc_lock``.  The store binds port 0 and reports the
        port it got, so there is no probe-and-bind race."""
        try:
            import datetime

            import torch.distributed as dist

            store = dist.TCPStore(self.host, 0, world, is_master=True,
                                  timeout=datetime.timedelta(
                                      seconds=self._registrant_timeout),
                                  wait_for_workers=False)
        except Exception as e:  # noqa: BLE001 — no store: reply 0
            log("tracker: cannot host a device-plane store: %s", e)
            return 0
        self._jaxsvcs.append(store)
        log("tracker: hosting device-plane store #%d on port %d",
            len(self._jaxsvcs), store.port)
        return store.port

    def _watchdog(self) -> None:
        """Fires on_stall when a rendezvous round sits partially filled
        longer than watchdog_sec.  Restarting a merely-slow worker is
        wasteful but safe (it reloads from its checkpoint), so the
        launcher may use an aggressive bound in test/dev jobs."""
        while not self._stopped:
            time.sleep(min(0.2, self._watchdog_sec / 5))
            for job in self._live_jobs():
                with job._pending_lock:
                    stalled = (
                        job._round_started is not None
                        and 0 < len(job._pending) < job._round_size()
                        and time.monotonic() - job._round_started
                        > self._watchdog_sec)
                    if not stalled:
                        continue
                    present = {r.task_id for r in job._pending}
                    finished = set(job._shutdown_tasks)
                    # rearm: fire again only after another full period
                    job._round_started = time.monotonic()
                log("tracker:%s rendezvous stalled (%d/%d registered); "
                    "notifying launcher", job._tag(), len(present),
                    job._round_size())
                try:
                    self._on_stall(present, finished)
                except Exception as e:  # noqa: BLE001 — must survive
                    log("tracker: on_stall callback failed: %s", e)

    # How often parked rendezvous sockets are polled for death (and
    # job completion / orphan GC is re-checked).
    REGISTRANT_SWEEP_SEC = 0.5

    def _sweep_registrants(self) -> None:
        """Per-job dead-registrant sweep + the job lifecycle sweep
        (completion backstop and the idle-orphan GC)."""
        while not self._stopped:
            time.sleep(self.REGISTRANT_SWEEP_SEC)
            now = time.monotonic()
            for job in self._live_jobs():
                # One tenant's corrupt state must never kill the sweep
                # for its co-tenants: failures are logged per job and
                # the pass moves on.
                try:
                    job.sweep_registrants_once()
                    if not job.touched:
                        continue  # lifecycle starts at first admission
                    if job.job_done():
                        self._finish_job(job, "finished")
                        continue
                    why = job.orphaned(now)
                    if why is not None:
                        log("tracker:%s orphan GC: %s", job._tag(), why)
                        self._finish_job(job, "orphan_gc")
                except Exception as e:  # noqa: BLE001 — sweep survives
                    log("tracker:%s registrant/lifecycle sweep failed: "
                        "%s", job._tag(), e)
            # Exit-condition backstop: job completion can happen while
            # run() is blocked in accept().
            if self._service_done():
                self._wake_accept()

    # -- heartbeat failure detector ------------------------------------
    # How often the heartbeat sweep wakes to drain beats and check
    # deadlines; detection latency adds at most one sweep period on top
    # of the miss budget.
    HB_SWEEP_SEC = 0.1

    def _hb_monitor(self) -> None:
        """Drain beats and run the deadline-based suspicion sweep,
        across every job's heartbeat channels."""
        while not self._stopped:
            pairs: list[tuple[JobState, _HbPeer]] = []
            for job in self._live_jobs():
                with job._hb_lock:
                    pairs.extend((job, p)
                                 for p in job._hb_peers.values())
            if not pairs:
                time.sleep(self.HB_SWEEP_SEC)
                continue
            sel = selectors.DefaultSelector()
            try:
                for job, p in pairs:
                    try:
                        sel.register(p.sock, selectors.EVENT_READ,
                                     (job, p))
                    except (OSError, ValueError):
                        continue  # closed under us; deadline still runs
                try:
                    ready = [key.data
                             for key, _ in sel.select(self.HB_SWEEP_SEC)]
                except OSError:
                    # a registered fd closed mid-select (tracker
                    # teardown race): the detector must outlive it
                    ready = []
            finally:
                sel.close()
            if self._stopped:
                return  # teardown: sockets are closing under us; any
                # drain from here would just log spurious EOFs
            now = time.monotonic()
            for job, p in ready:
                try:
                    job._hb_drain(p, now)
                except Exception as e:  # noqa: BLE001 — see sweep note
                    log("tracker:%s heartbeat drain failed for task %r: "
                        "%s", job._tag(), p.task_id, e)
            for job, p in pairs:
                with job._hb_lock:
                    if job._hb_peers.get(p.task_id) is not p:
                        continue  # replaced (relaunch) or forgotten
                if now - p.last > p.period_s * self._hb_miss:
                    try:
                        job._hb_mark_dead(
                            p, "dead",
                            f"no beat for {now - p.last:.2f}s (budget "
                            f"{self._hb_miss:g} x {p.period_s:g}s)")
                    except Exception as e:  # noqa: BLE001
                        log("tracker:%s heartbeat verdict failed for "
                            "task %r: %s", job._tag(), p.task_id, e)

    # -- command dispatch ----------------------------------------------
    def _handle(self, sock: socket.socket) -> None:
        try:
            job_name, cmd, task_id, world_hint = P.recv_hello(sock)
        except P.HandshakeError as e:
            # Stray client on the tracker port (port scanner, HTTP
            # probe, corrupt worker): log + drop; a client that spoke
            # the magic gets the typed reject so a confused worker
            # fails loudly instead of waiting on a closed socket.
            log("tracker: dropped stray client on the tracker port (%s)",
                e)
            if e.parsed_magic:
                try:
                    P.RejectReply(P.REJECT_BAD_HANDSHAKE, str(e)).send(sock)
                except OSError:
                    pass
            try:
                sock.close()
            except OSError:
                pass
            return
        try:
            self._dispatch(sock, job_name, cmd, task_id, world_hint)
        except P.HandshakeError as e:
            # Post-magic garbage (oversized host string, corrupt print
            # payload length): the same typed reject as a hello that
            # went wrong after the magic.
            log("tracker: dropped malformed %s from task %r (%s)",
                cmd, task_id, e)
            try:
                P.RejectReply(P.REJECT_BAD_HANDSHAKE, str(e)).send(sock)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _dispatch(self, sock: socket.socket, job_name: str, cmd: str,
                  task_id: str, world_hint: int) -> None:
        if cmd == P.CMD_PRINT:
            # Print payloads get a generous but finite cap — a stray
            # length prefix must not become an unbounded buffering recv.
            msg = P.recv_str(sock, max_len=P.MAX_PRINT_LEN)
            if msg.startswith(_OBS_SUMMARY_PREFIX):
                log("tracker: obs summary from task %r dropped (obs is "
                    "not ported: ROADMAP A8)", task_id)
            else:
                sys.stdout.write(msg if msg.endswith("\n")
                                 else msg + "\n")
                sys.stdout.flush()
            sock.close()
            return
        if cmd == P.CMD_SHUTDOWN:
            job = self._job_get(job_name)
            if job is not None:
                job.last_activity = time.monotonic()
                if task_id in job._rank_of:
                    job._shutdown_tasks.add(task_id)
                if job.job_done():
                    # _finish_job journals the terminal (done=True)
                    # state — no point fsyncing an immediately
                    # superseded snapshot first.
                    self._finish_job(job, "finished")
                elif task_id in job._rank_of:
                    job._journal()
            sock.close()
            return
        if cmd == P.CMD_EPOCH:
            # Membership poll (one-shot): record the worker's committed
            # version (journaled job progress), reply the current and
            # pending epoch so commit boundaries learn about rescales.
            version = P.recv_u32(sock)
            job = self._job_get(job_name)
            if job is None:
                try:  # unknown/finished job: "no change"
                    P.send_u32(sock, 0)
                    P.send_u32(sock, 0)
                    P.send_u32(sock, 0)
                except OSError:
                    pass
                sock.close()
                return
            job.last_activity = time.monotonic()
            bump = version > job._committed_version
            if bump:
                job._committed_version = version
            with job._scale_lock:
                pending = job._target_world is not None
                target_epoch = job._epoch + (1 if pending else 0)
                target_world = (job._target_world if pending
                                else job.n_workers)
            try:
                P.send_u32(sock, job._epoch)
                P.send_u32(sock, target_epoch)
                P.send_u32(sock, target_world)
            except OSError:
                pass  # poller gone; it treats that as "no change"
            sock.close()
            if bump:
                job._journal()
            return
        if cmd == P.CMD_JAXSVC:
            job = self._job_get(job_name)
            P.send_u32(sock, job.keyed_store_service(task_id)
                       if job is not None else 0)
            sock.close()
            return
        if cmd == P.CMD_FORMBAR:
            job = self._job_get(job_name)
            if job is None:
                JobState._formbar_reply(sock, False)
                return
            job.last_activity = time.monotonic()
            job._formbar_post(sock, task_id)
            return
        if cmd == P.CMD_HEARTBEAT:
            period_ms = P.recv_u32(sock)
            job = self._job_get(job_name)
            if job is None:
                sock.close()
                return
            job.last_activity = time.monotonic()
            job._hb_register(sock, task_id, period_ms)
            return  # the connection stays open for the beat stream
        if cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_RESCALE):
            host = P.recv_str(sock, max_len=P.MAX_HELLO_STR)
            port = P.recv_u32(sock)
            job = self._admit(job_name, world_hint)
            job.register(sock, cmd, task_id, host, port)
            return
        log("tracker: unknown command %r from task %r", cmd, task_id)
        sock.close()
