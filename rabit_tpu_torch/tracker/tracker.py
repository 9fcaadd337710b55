"""Rendezvous tracker — the control plane's rendezvous core.

PyTorch-port counterpart of :mod:`rabit_tpu.tracker.tracker`, cut to the
rendezvous core: it assigns ranks (stable per task_id across restarts),
computes the tree+ring topology plus every schedule's extra links, hands
each worker its connect/accept lists, relays worker log lines, and
terminates when every job it served has completed.  Its replies equal
the reference tracker's field for field, so port ranks and reference
ranks can register with either tracker.

As in the reference:

* Rendezvous is a **full-world barrier**: a round (start or recover)
  completes only when all ``world`` workers have registered, then
  everyone receives a complete topology in one reply.
* Tracker connections are one-shot: each command (start/recover/print/
  shutdown) is a fresh TCP connection.
* The ring is the plain rank cycle and the tree is the binary heap over
  ranks; :func:`rabit_tpu_torch.sched.topo.extra_link_peers` adds the
  halving/doubling, Swing and hierarchical peers to every linkset.
* Jobs are keyed by the ``job`` field of the worker hello (protocol
  ``MAGIC_JOB``; the classic hello lands in the ``default`` job), each
  with its own :class:`JobState`.

Not ported yet, each with its ROADMAP item: the heartbeat channel, the
registrant sweep and the stall watchdog (A3b); elastic membership
(``rescale``/``epoch``), the durable journal and the formation barrier
(A4b); the XLA coordinator service (``jaxsvc``, A5); obs telemetry, the
adaptive controller, admission limits, HTTP and the CLI (A8).  A command
of those (``rescale``, ``epoch``, ``heartbeat``, ``formbar``,
``jaxsvc``) gets the reference's treatment of an unknown command: the
tracker logs it and closes the connection.  ``epoch`` is 0 in every
reply, ``sched`` is "" and ``demoted`` is empty.
"""
from __future__ import annotations

import os
import socket
import sys
import threading
from dataclasses import dataclass

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


class JobState:
    """The rendezvous state of ONE job (tenant) served by the tracker:
    rank map, membership and the rendezvous barrier."""

    def __init__(self, tracker: "Tracker", name: str,
                 n_workers: int) -> None:
        self._tracker = tracker
        self.name = name
        self.n_workers = n_workers
        # Lifecycle: ``touched`` flips on the first admitted worker
        # command; ``done`` on unanimous goodbye — a done incarnation
        # holds nothing and a re-registration under the same name is a
        # NEW job submission.
        self.touched = False
        self.done = False
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
        self._pending: list[_Registrant] = []
        self._pending_lock = threading.Lock()
        # One thread runs _finish_round at a time.
        self._round_lock = threading.Lock()

    @property
    def _registrant_timeout(self) -> float:
        return getattr(self._tracker, "_registrant_timeout", 600.0)

    def _tag(self) -> str:
        """Log prefix: the default job keeps the pre-tenant wording."""
        return "" if self.name == DEFAULT_JOB else f" [job {self.name}]"

    # -- lifecycle -----------------------------------------------------
    def job_done(self) -> bool:
        """Job completion.  Before the first round completes the only
        coordinate is the launch count; after it, the job is done when
        every member shut down."""
        if self._members:
            return self._members <= self._shutdown_tasks
        return len(self._shutdown_tasks) >= self.n_workers

    def close(self) -> None:
        """Drop this job's parked registrants' sockets."""
        with self._pending_lock:
            for reg in self._pending:
                try:
                    reg.sock.close()
                except OSError:
                    pass
            self._pending.clear()

    # -- rendezvous ----------------------------------------------------
    def register(self, sock: socket.socket, cmd: str, task_id: str,
                 host: str, port: int) -> None:
        """Park one start/recover registrant in this job's rendezvous
        barrier (and complete the round if it fills)."""
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
            self._pending.append(
                _Registrant(sock, task_id, host, port, cmd))
            full = 0 < self.n_workers <= len(self._pending)
        if full:
            self._finish_round()

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
        """
        with self._round_lock:
            world = self.n_workers
            with self._pending_lock:
                if not 0 < world <= len(self._pending):
                    return  # raced: another thread already served it
                regs = self._pending[:world]
                self._pending = self._pending[world:]
            self._assign_ranks(regs)
            members = {r.task_id for r in regs}
            by_rank = {self._rank_of[r.task_id]: r for r in regs}
            addr = {rk: (reg.host, reg.port) for rk, reg in by_rank.items()}
            groups = self._topo_groups(by_rank, world)
            # No elastic epochs and no adaptive controller here: epoch
            # 0, no demotions, an empty directive.
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
                    relaunched=relaunched, epoch=0,
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


class Tracker:
    """Accepts worker connections and serves rendezvous rounds — for
    one job or several concurrent named jobs."""

    def __init__(self, n_workers: int, host: str = "127.0.0.1", port: int = 0,
                 registrant_timeout_sec: float | None = None):
        """``n_workers`` is the DEFAULT job's world size (and the world
        assumed for a named job whose first registrant sent no world
        hint).

        ``registrant_timeout_sec``: socket timeout applied to
        registered rendezvous sockets; it bounds the tracker's blocking
        SENDS when a round completes, not the barrier wait itself.
        Defaults to ``RABIT_TIMEOUT_SEC`` (else 600 s)."""
        self._default_world = n_workers
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(256)
        self.host, self.port = self._listener.getsockname()
        self._thread: threading.Thread | None = None
        self._stopped = False
        if registrant_timeout_sec is None:
            try:
                registrant_timeout_sec = float(
                    os.environ.get("RABIT_TIMEOUT_SEC", 600))
            except ValueError:
                registrant_timeout_sec = 600.0
        self._registrant_timeout = max(float(registrant_timeout_sec), 1.0)
        self._jobs_lock = threading.Lock()
        self._jobs: dict[str, JobState] = {
            DEFAULT_JOB: JobState(self, DEFAULT_JOB, n_workers)}
        self._jobs_touched = 0     # jobs that ever admitted a worker

    # -- job registry --------------------------------------------------
    def _default_job(self) -> JobState:
        with self._jobs_lock:
            return self._jobs[DEFAULT_JOB]

    def _job_list(self) -> list[JobState]:
        with self._jobs_lock:
            return list(self._jobs.values())

    def _job_get(self, name: str) -> JobState | None:
        """The current live incarnation of a job, or None (unknown or
        already finished)."""
        with self._jobs_lock:
            job = self._jobs.get(name)
        return None if job is None or job.done else job

    def _admit(self, name: str, world_hint: int) -> JobState:
        """Resolve a registration's job, creating a fresh incarnation
        when none is live.  A named job's world comes from its first
        registrant's hint; the default job (and hint-less registrants)
        use the tracker's configured world."""
        with self._jobs_lock:
            job = self._jobs.get(name)
            if job is not None and job.done:
                job = None
            if job is None:
                world = (world_hint if world_hint > 0
                         and name != DEFAULT_JOB else self._default_world)
                job = JobState(self, name, world)
                self._jobs[name] = job
            if not job.touched:
                job.touched = True
                self._jobs_touched += 1
                log("tracker: job %r admitted (world %d)", job.name,
                    job.n_workers)
        return job

    def _finish_job(self, job: JobState, phase: str) -> None:
        """Complete a job's lifecycle (unanimous goodbye): drop its
        sockets and wake the serve loop if it was the last one."""
        with self._jobs_lock:
            if job.done:
                return
            job.done = True
        log("tracker:%s job %s (%d member(s), %d shutdown)",
            job._tag() or " [job default]", phase, len(job._members),
            len(job._shutdown_tasks))
        job.close()
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
        """Nudge the accept loop so it re-checks the exit condition."""
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

    def _close_all(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
        for job in self._job_list():
            job.close()

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
                if task_id in job._rank_of:
                    job._shutdown_tasks.add(task_id)
                if job.job_done():
                    self._finish_job(job, "finished")
            sock.close()
            return
        if cmd in (P.CMD_START, P.CMD_RECOVER):
            host = P.recv_str(sock, max_len=P.MAX_HELLO_STR)
            port = P.recv_u32(sock)
            job = self._admit(job_name, world_hint)
            job.register(sock, cmd, task_id, host, port)
            return
        log("tracker: unknown command %r from task %r", cmd, task_id)
        sock.close()
