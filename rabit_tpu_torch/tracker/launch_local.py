"""Local multi-process launcher with keepalive restart.

PyTorch-port counterpart of :mod:`rabit_tpu.tracker.launch_local` (its
own copy: the port imports nothing of the JAX package; reference
analogue: tracker/rabit_demo.py:28-64): starts the port's tracker plus N
worker processes and — the fault-tolerance test harness — restarts any
worker that exits with the kill-point code (254), passing an
incremented ``RABIT_NUM_TRIAL`` so deterministic mock kill-points fire
once per life, relaunches a worker killed by a signal within
``max_restarts``, and kills a hung worker — one the tracker's stall
watchdog (``watchdog_sec``) or heartbeat detector (``heartbeat_sec``)
names — for a free restart with the same ``RABIT_NUM_TRIAL``.  With
``ckpt_dir`` the workers persist every committed version there, so a
job whose every rank died resumes from disk.  With ``min_workers`` /
``max_workers`` the job is elastic: a signal-killed worker whose
restart budget is spent leaves the job and the world shrinks at the
next commit boundary; ``state_dir`` journals the tracker's state.

Usage:
    python -m rabit_tpu_torch.tracker.launch_local -n 4 python worker.py

Left out until ROADMAP A8, each refused where it is asked for (an
argparse error from the CLI, :class:`NotImplementedError` from
:func:`launch`): telemetry and tracing.

Differs from the reference on purpose: the stall killer spares a life
that has not yet registered with the tracker for up to
``START_GRACE_SEC`` instead of one watchdog period (see
:func:`make_stall_killer`).
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import subprocess
import sys
import threading
import time

from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker

# Exit code meaning "killed at a mock kill-point; restart me".  The
# reference uses exit(-2) == 254 (src/allreduce_mock.h:165-171,
# tracker/rabit_demo.py:28-40); we keep the same convention.
RESTART_EXIT_CODE = 254

# How long the stall killer spares a life that has not yet registered
# with the tracker (its interpreter and imports still starting): a
# relaunch that imports torch takes seconds, more under load, and the
# watchdog rearms every period while the round waits for it.
START_GRACE_SEC = 60.0

# Where each launcher option the port refuses lands in ROADMAP.md's
# queue A: (launch() keyword, CLI flag, item).
_UNPORTED = (("obs_dir", "--obs-dir", "A8"),
             ("obs_port", "--obs-port", "A8"),
             ("trace_dir", "--trace-dir", "A8"))


def is_dead_exit(code: int) -> bool:
    """Did the worker die of a signal (crash/kill/preemption) rather
    than exiting on its own?  The supervisor's restart budget
    (``max_restarts``) covers exactly these: a SIGKILL'd/preempted rank
    is relaunched, while a deliberate non-zero exit (assertion, typed
    error) still aborts the job."""
    return code < 0


def is_watchdog_exit(code: int) -> bool:
    """True when an exit status is one the watchdog's kill can produce.

    The stall killer marks a worker as watchdog-killed *before* the kill
    lands; a worker that crashes on its own in that window must not be
    classified as watchdog-killed, or a genuinely failing worker gets
    silently restarted until the restart budget runs out.  The kill is
    always SIGKILL (``Popen.kill``)."""
    return code == -signal.SIGKILL


def restart_delay_ms(nth_restart: int, base_ms: float) -> float:
    """Supervisor relaunch pacing: capped exponential backoff (32x the
    base) with jitter."""
    return min(base_ms * (1 << (nth_restart - 1)),
               32.0 * base_ms) * random.uniform(0.5, 1.0)


def make_dead_killer(live: dict, started: dict, lock: threading.Lock,
                     watchdog_killed: set, heartbeat_sec: float | None):
    """Heartbeat-verdict policy (tracker ``on_dead``): kill the
    declared-dead worker so its keepalive restarts it, riding the
    watchdog-kill bookkeeping (a free restart — the launcher caused the
    death).

    The grace window keeps a stale verdict (the tracker re-notifies
    while a corpse's socket lingers) from killing the freshly
    relaunched life; the tracker re-notifies past it.  (The reference's
    ``label`` and ``kill_fn``, a log tag and a remote kill for its ssh
    pod launcher, wait for that launcher, ROADMAP A8.)"""
    dead_grace = max(2.0, 3.0 * float(heartbeat_sec or 0.0))

    def on_dead(task_id: str) -> None:
        try:
            wid = int(task_id)
        except (TypeError, ValueError):
            return
        with lock:
            proc = live.get(wid)
            if proc is None or proc.poll() is not None:
                return  # already dead; the keepalive is on it
            if time.monotonic() - started.get(wid, 0.0) < dead_grace:
                return  # freshly (re)started life: not the corpse
            watchdog_killed.add(wid)
        sys.stderr.write(f"[launch_local] heartbeat: worker {wid} declared "
                         "dead; killing for restart\n")
        sys.stderr.flush()
        proc.kill()

    return on_dead


def make_stall_killer(n_workers: int, live: dict, started: dict,
                      lock: threading.Lock, watchdog_killed: set,
                      watchdog_sec: float | None,
                      registered_at=None):
    """Hung-worker policy (tracker ``on_stall``).

    Kills AT MOST ONE hung worker per stall event: killing one sends
    RSTs that error its peers out into recovery with their in-memory
    checkpoint replicas intact, while killing every silent worker at
    once would destroy all replicas and silently restart the job from
    version 0; if more than one is truly wedged, the next stall event
    (one watchdog period later) takes the next one.

    A life younger than one period is spared, as in the reference.
    ``registered_at(task_id)`` (the tracker's :meth:`Tracker.registered_at`)
    also spares a life that has not registered since it started, for up
    to ``START_GRACE_SEC``: the watchdog rearms every period while the
    round waits, so the reference's one-period grace kills a relaunch
    again when its start-up outlasts about two periods.  None keeps the
    reference's policy."""

    def on_stall(present: set, finished: set) -> None:
        all_ids = {str(i) for i in range(n_workers)}
        for tid in sorted(all_ids - present - finished):
            wid = int(tid)
            with lock:
                proc = live.get(wid)
                if proc is None or proc.poll() is not None:
                    continue  # already dead; keepalive is restarting it
                born = started.get(wid, 0.0)
                age = time.monotonic() - born
                if watchdog_sec is not None and age < watchdog_sec:
                    continue  # freshly (re)started: give it a full period
                if registered_at is not None and age < START_GRACE_SEC:
                    seen = registered_at(tid)
                    if seen is None or seen < born:
                        continue  # still starting: not registered yet
                watchdog_killed.add(wid)
            sys.stderr.write(f"[launch_local] watchdog: worker {wid} is "
                             "hung; killing for restart\n")
            sys.stderr.flush()
            proc.kill()
            return

    return on_stall


def launch(n_workers: int, cmd: list[str], max_trials: int = 10,
           verbose: bool = False,
           extra_env: dict[str, str] | None = None,
           watchdog_sec: float | None = None,
           obs_dir: str | None = None,
           max_restarts: int = 0,
           ckpt_dir: str | None = None,
           heartbeat_sec: float | None = None,
           restart_backoff_ms: float = 250.0,
           min_workers: int | None = None,
           max_workers: int | None = None,
           state_dir: str | None = None,
           job: str | None = None,
           obs_port: int | None = None,
           trace_dir: str | None = None) -> int:
    """Run ``cmd`` as n worker processes under a fresh tracker.

    ``max_trials``: restarts per worker after a kill-point exit (254),
    each with ``RABIT_NUM_TRIAL`` one higher.

    ``max_restarts``: the supervisor budget — a worker that dies of a
    signal (SIGKILL, crash, preemption; NOT a deliberate non-zero exit)
    is relaunched up to this many times, paced by capped-exponential
    backoff (``restart_backoff_ms`` base, jitter).  Its checkpoint
    comes back from the live replicas.  Combined with ``ckpt_dir`` this
    is the cold-restart path: even killing EVERY rank at once resumes
    the job from the last durably committed version.

    ``ckpt_dir``: exported to workers as ``RABIT_CKPT_DIR`` (the
    durable checkpoint tier, :mod:`rabit_tpu_torch.ckpt`): writer ranks
    persist every committed version there.

    ``job``: name the tenant (``rabit_job_id`` / ``RABIT_JOB_ID``);
    workers register under this job on the tracker.

    ``min_workers`` / ``max_workers``: **elastic membership** — the
    tracker admits late ``cmd=start`` joiners up to the ceiling and
    turns deaths into a scale-*down* (never below the floor) instead
    of insisting on a same-rank relaunch; workers get
    ``RABIT_ELASTIC=1`` so the robust engine polls for rescale epochs
    at checkpoint-commit boundaries.  A signal-killed worker whose
    restart budget is spent *leaves* the job (the world shrinks)
    rather than failing it.

    ``state_dir``: journal the tracker's control-plane state through
    the atomic checkpoint-store tier, so a tracker restarted on the
    same port (or a fresh launcher pointed at the same state and ckpt
    directories) resumes the job.

    ``watchdog_sec``: kill + restart workers the tracker reports as hung
    (registered peers are waiting on the rendezvous barrier, this worker
    stayed silent that long; a life that has not registered yet gets
    up to ``START_GRACE_SEC``).  ``heartbeat_sec``: exported to workers as
    ``RABIT_HEARTBEAT_SEC``; it also arms the tracker's heartbeat
    failure detector, whose dead verdicts are handled like watchdog
    kills.  Either kill is a free restart: same ``RABIT_NUM_TRIAL``,
    ``RABIT_RELAUNCH`` one higher, within ``max_trials``.

    Workers get the tracker's ``worker_env``, ``RABIT_NUM_TRIAL`` and
    ``RABIT_RELAUNCH`` (restarts of any cause) on top of ``extra_env``.
    A permanent failure (any other non-zero exit) stops the tracker,
    terminates the other workers and is returned.  The signature is the
    reference's: its other keywords raise :class:`NotImplementedError`
    naming their ROADMAP item unless left at None.

    Returns 0 if every worker finished cleanly, else the first non-restart
    non-zero exit code.
    """
    given = dict(obs_dir=obs_dir, obs_port=obs_port, trace_dir=trace_dir)
    for key, _flag, item in _UNPORTED:
        if given[key] is not None:
            raise NotImplementedError(
                f"launch({key}={given[key]!r}) is not ported to "
                f"rabit_tpu_torch yet (ROADMAP {item})")
    if job is not None:
        P.require_valid_job_id(job)
    elastic = min_workers is not None or max_workers is not None
    extra_env = dict(extra_env or {})
    if ckpt_dir is not None:
        extra_env.setdefault("RABIT_CKPT_DIR", str(ckpt_dir))
    if heartbeat_sec:
        extra_env.setdefault("RABIT_HEARTBEAT_SEC", str(heartbeat_sec))
    if elastic:
        extra_env.setdefault("RABIT_ELASTIC", "1")
    failures: list[int] = []
    live: dict[int, subprocess.Popen] = {}
    started: dict[int, float] = {}
    lock = threading.Lock()
    aborting = threading.Event()
    watchdog_killed: set[int] = set()

    on_stall = make_stall_killer(
        n_workers, live, started, lock, watchdog_killed, watchdog_sec,
        registered_at=lambda tid: tracker.registered_at(tid, job))
    on_dead = make_dead_killer(live, started, lock, watchdog_killed,
                               heartbeat_sec)
    tracker = Tracker(n_workers, watchdog_sec=watchdog_sec,
                      on_stall=on_stall if watchdog_sec else None,
                      on_dead=on_dead if heartbeat_sec else None,
                      min_workers=min_workers, max_workers=max_workers,
                      state_dir=state_dir)
    tracker.start()

    def keepalive(worker_id: int) -> None:
        trial = 0
        wd_restarts = 0
        sup_restarts = 0
        while not aborting.is_set():
            env = dict(os.environ)
            env.update(extra_env)
            env.update(tracker.worker_env(task_id=str(worker_id), job=job))
            env["RABIT_NUM_TRIAL"] = str(trial)
            # Total restarts of any cause.  Distinct from RABIT_NUM_TRIAL,
            # which counts only kill-point deaths so deterministic mock
            # scenarios stay reproducible under watchdog and supervisor
            # restarts.
            env["RABIT_RELAUNCH"] = str(trial + wd_restarts + sup_restarts)
            with lock:
                if aborting.is_set():
                    return
                proc = subprocess.Popen(cmd, env=env)
                live[worker_id] = proc
                started[worker_id] = time.monotonic()
            code = proc.wait()
            with lock:
                live.pop(worker_id, None)
                was_watchdog = worker_id in watchdog_killed
                watchdog_killed.discard(worker_id)
            if (was_watchdog and is_watchdog_exit(code)
                    and wd_restarts < max_trials):
                # same trial number: the worker never reached its
                # kill-point, it was stopped from outside
                wd_restarts += 1
                if verbose:
                    sys.stderr.write(
                        f"[launch_local] worker {worker_id} killed as "
                        f"hung; restart #{wd_restarts}\n")
                continue
            if code == RESTART_EXIT_CODE and trial < max_trials:
                trial += 1
                if verbose:
                    sys.stderr.write(
                        f"[launch_local] worker {worker_id} hit a "
                        f"kill-point; restart #{trial}\n")
                continue
            if (is_dead_exit(code) and sup_restarts < max_restarts
                    and not aborting.is_set()):
                # Supervisor path: the worker was killed from outside
                # (preemption, crash) — relaunch it under the bounded,
                # backoff-paced restart budget.
                sup_restarts += 1
                delay_ms = restart_delay_ms(sup_restarts,
                                            restart_backoff_ms)
                sys.stderr.write(
                    f"[launch_local] supervisor: worker {worker_id} "
                    f"died (exit {code}); relaunch "
                    f"#{sup_restarts}/{max_restarts} in "
                    f"{delay_ms:.0f} ms\n")
                sys.stderr.flush()
                time.sleep(delay_ms / 1000.0)
                continue
            if elastic and is_dead_exit(code) and not aborting.is_set():
                # Elastic leave: the restart budget (if any) is spent —
                # a preempted/killed worker departs instead of failing
                # the job.  Tell the tracker directly: with heartbeats
                # armed this is redundant (the EOF verdict fired first),
                # without them it is the ONLY signal that turns the
                # death into a scale-down at the next commit boundary
                # (never below min_workers); if the floor cannot absorb
                # it, the survivors' stall watchdog / link timeouts
                # still bound the job.
                sys.stderr.write(
                    f"[launch_local] elastic: worker {worker_id} left "
                    f"the job (exit {code}); world scales down\n")
                sys.stderr.flush()
                tracker.note_dead(str(worker_id), job=job)
                return
            if code != 0 and not aborting.is_set():
                failures.append(code)
                # A permanent failure means the rendezvous barrier can
                # never complete: kill the job instead of letting peers
                # sit in their (up to 600 s) control-plane timeouts.
                aborting.set()
                tracker.stop()
                with lock:
                    for p in live.values():
                        p.terminate()
            return

    threads = [threading.Thread(target=keepalive, args=(i,))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not aborting.is_set():
        tracker.join(timeout=10)
    tracker.stop()
    return failures[0] if failures else 0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="run N rabit_tpu_torch workers locally under a tracker")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--max-trials", type=int, default=10,
                    help="max restarts per worker on kill-point exit (254)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="supervisor budget: relaunch a signal-killed "
                         "worker (crash/preemption/kill-all) up to this "
                         "many times, backoff-paced; 0 disables")
    ap.add_argument("--ckpt-dir", default=None,
                    help="durable checkpoint tier: exported to workers "
                         "as RABIT_CKPT_DIR so writer ranks persist "
                         "committed versions and a cold restart resumes "
                         "from disk")
    ap.add_argument("--job", default=None, metavar="ID",
                    help="tenant name (rabit_job_id / RABIT_JOB_ID): "
                         "workers register under this job")
    ap.add_argument("--watchdog", type=float, default=None, metavar="SEC",
                    help="kill+restart workers that stall a rendezvous "
                         "round this long (hung-worker detection)")
    ap.add_argument("--heartbeat", type=float, default=None, metavar="SEC",
                    help="worker keepalive period (RABIT_HEARTBEAT_SEC); "
                         "arms the tracker's proactive failure detector "
                         "— hung ranks are killed+relaunched without a "
                         "collective op having to touch them")
    ap.add_argument("--min-workers", type=int, default=None,
                    help="elastic floor: a worker death becomes a "
                         "scale-down (never below this) at the next "
                         "commit boundary; sets RABIT_ELASTIC=1")
    ap.add_argument("--max-workers", type=int, default=None,
                    help="elastic ceiling: late joiners are admitted "
                         "at commit boundaries up to this world size")
    ap.add_argument("--state-dir", default=None,
                    help="journal the tracker's control-plane state "
                         "here (a restarted tracker resumes the job)")
    for _key, flag, item in _UNPORTED:
        ap.add_argument(flag, default=None,
                        help=f"not ported yet (ROADMAP {item})")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command and its arguments")
    args = ap.parse_args(argv)
    for _key, flag, item in _UNPORTED:
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) is not None:
            ap.error(f"{flag} is not ported to rabit_tpu_torch yet "
                     f"(ROADMAP {item})")
    if args.cmd and args.cmd[0] == "--":  # REMAINDER keeps the separator
        args.cmd = args.cmd[1:]
    if not args.cmd:
        ap.error("missing worker command")
    sys.exit(launch(args.num_workers, args.cmd, args.max_trials,
                    args.verbose, watchdog_sec=args.watchdog,
                    max_restarts=args.max_restarts, ckpt_dir=args.ckpt_dir,
                    heartbeat_sec=args.heartbeat,
                    min_workers=args.min_workers,
                    max_workers=args.max_workers,
                    state_dir=args.state_dir, job=args.job))


if __name__ == "__main__":
    main()
