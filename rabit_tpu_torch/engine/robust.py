"""Pure-Python fault-tolerant engine: cache/replay recovery over pysocket.

PyTorch-port counterpart of :class:`rabit_tpu.engine.robust.PyRobustEngine`
(its own copy: the port imports nothing of the JAX package), with the
reference's names, structure and wire bytes, so port ranks and
reference ranks recover each other in one world.  It layers on
:class:`PySocketEngine`'s links and collectives and gives the paper's
headline feature: a crashed worker rejoins the running job and catches
up from in-memory checkpoints instead of restarting the world.

Protocol:

* Every collective first runs a tiny **consensus allreduce** over the
  tree links carrying ``(flags, seqno, version, op-fingerprint)``.
  Uniform ``(version, seqno)`` with no flags set means "everyone is
  here: execute for real"; a lagging seqno means a relaunched rank needs
  the cached result of ``min(seqno)`` **replayed** (its ``prepare_fun``
  is skipped and ``last_op_replayed`` is True); a lagging version means
  a checkpoint commit must catch up.  The fingerprint hashes the op
  type, reduce op/dtype and payload size, so ranks that disagree on the
  op at a uniform ``(version, seqno)`` fail loudly at the consensus
  round instead of corrupting payloads downstream.
* Results are cached by seqno within the current version span, with
  **striped replication** (``rabit_global_replica``) bounding memory;
  the cache is cleared at every checkpoint commit.
* ``checkpoint()`` commits the global model on every rank and
  ring-replicates each rank's **local** model to its
  ``rabit_local_replica`` ring successors; recovery floods the blobs
  backward so a dead rank's own state survives its death.
* With ``rabit_ckpt_dir`` set, elected writer ranks additionally
  persist every committed version to the **durable tier**
  (:mod:`rabit_tpu_torch.ckpt`: atomic CRC-stamped blobs + manifest),
  and the checkpoint-load path cold-resumes from the newest valid
  on-disk version when *no* live rank holds one — kill-all-ranks
  restarts resume at the last committed version instead of 0, and a
  rejoiner whose disk outran the cluster raises the typed
  :class:`~rabit_tpu_torch.ckpt.CheckpointSkewError`.
* Any :class:`LinkError` cascades every survivor into a tracker
  ``recover`` rendezvous; the relaunched rank registers with ``start``,
  loads the checkpoint from the agreed newest holder, replays cached
  results, and rejoins the op it died in mid-flight.
* With ``rabit_elastic`` set, every commit boundary polls the tracker
  (``cmd=epoch``); a pending rescale epoch rides the ack round's
  consensus word (``K_RESCALE``), the whole world re-registers with
  ``cmd=rescale``, and a world that changed size or ranks raises
  :class:`WorldChangedError` on every member — the app reloads the
  committed version and re-shards for the new ``(rank, world)``.  A
  recover round that the tracker completed as a rescale (a death the
  elastic floor absorbs) resolves the same way.
* ``RABIT_MOCK`` kill-points — ``rank,version,seqno,ndeath`` tuples,
  ``;``-separated, seqno ``1<<20`` = at checkpoint, ``(1<<20)+1`` = at
  load — drive deterministic fault injection (exit 254: the keepalive
  launcher, :mod:`rabit_tpu_torch.tracker.launch_local`, restarts the
  worker with an incremented ``RABIT_NUM_TRIAL``).

Recovery payloads ride the plain tree flood from the agreed root
(everyone receives), as the reference's do.

Left out until their ROADMAP items, each refused with
:class:`NotImplementedError` where a knob would ask for it: online
adaptation (``rabit_adapt``, whose schedule-switch epochs reach
:meth:`PyRobustEngine._sched_epoch` here only as an elastic member
swap that kept every survivor's rank) and telemetry (A8), which also
holds the reference's checkpoint counters and trace events.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Callable, Optional

import numpy as np

from rabit_tpu_torch import ckpt as ckpt_mod
from rabit_tpu_torch.engine.pysocket import (PySocketEngine,
                                             WorldChangedError)
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.transport import LinkError
from rabit_tpu_torch.utils.checks import RabitError, check, error, log


class RecoveryError(RabitError):
    """Recover rendezvous exhausted its bounded attempt budget.

    Raised when the post-failure re-rendezvous cannot be completed
    within ``rabit_recover_attempts`` tries (each already including the
    connect retry/backoff schedule) or the barrier deadline — the job's
    control plane is unreachable and a supervisor must restart the
    world.  ``history`` carries one ``(attempt, monotonic_ts, error)``
    triple per failed attempt."""

    def __init__(self, msg: str,
                 history: list[tuple[int, float, str]]) -> None:
        super().__init__(msg)
        self.history = list(history)


# Consensus flags (the native engine's values; reference analogue:
# src/allreduce_robust.h:163-235).
K_LOAD_CHECK = 1    # a (re)started rank wants the latest checkpoint
K_CHECKPOINT = 2    # at the checkpoint barrier
K_CHECK_ACK = 4     # committed, waiting for everyone to commit
K_SHUTDOWN = 8      # finished the program, serving stragglers
K_DIFF_SEQ = 16     # derived: seqnos differ -> serve min
K_DIFF_VERSION = 32  # derived: versions differ -> commit catch-up
K_LOCAL_CHK = 64    # this checkpoint carries a local model
# Op fingerprints differ at a uniform (version, seqno): the collective
# call sequences diverged.
K_DIFF_OP = 128
# Set alongside K_CHECK_ACK by an elastic rank whose commit-boundary
# tracker poll saw a pending rescale epoch.  The OR-merge makes the
# decision uniform — if ANY rank saw it, every rank's ack round agrees
# on it and the whole world enters the cmd=rescale re-rendezvous
# together, exactly at the commit boundary.
K_RESCALE = 256

# Sentinel seqnos for kill-points at non-collective calls.
SEQ_CHECKPOINT = 1 << 20
SEQ_LOAD_CHECK = SEQ_CHECKPOINT + 1

_WORD_BYTES = 16  # flags, seq, version, fingerprint — all u32

# The reference's reading of a boolean knob (rabit_elastic, rabit_adapt).
_TRUE = ("1", "true", "yes")


class PyRobustEngine(PySocketEngine):
    """Fault-tolerant engine over the pure-Python TCP transport.

    Select with ``rabit_engine=pyrobust``, or give a tracker URI and no
    engine name.  Same checkpoint/replay semantics and ``RABIT_MOCK``
    fault-injection format as the reference's.
    """

    def __init__(self) -> None:
        super().__init__()
        self._seq = 0
        self._cache: dict[int, bytes] = {}  # seqno -> result (this version)
        self._num_global_replica = 5
        self._num_local_replica = 2
        self._recover_attempts = 8  # rabit_recover_attempts
        self._last_replayed = False
        self._has_checkpoint = False
        self._lazy_global: Optional[Callable[[], bytes]] = None
        # Pending checkpoint state between barrier and commit.
        self._pending_global = b""
        self._pending_lazy: Optional[Callable[[], bytes]] = None
        self._pending_local = b""
        self._has_pending_local = False
        # origin rank -> (version, blob) for ring-replicated local models.
        self._local_store: dict[int, tuple[int, bytes]] = {}
        # Mock fault injection: {(version, seqno, ndeath)} for THIS rank.
        self._kill_points: set[tuple[int, int, int]] = set()
        self._num_trial = 0
        # Agreed flags of the most recent consensus round: how the
        # commit path learns whether any rank's poll saw K_RESCALE.
        self._last_agreed = 0
        # Durable tier (rabit_ckpt_dir): None when not configured.
        self._ckpt_store: Optional[ckpt_mod.CheckpointStore] = None
        self._ckpt_writers = 0
        self._ckpt_dir_raw = ""   # unexpanded: re-elected after rescale
        self._ckpt_keep = 3
        # Elastic membership (rabit_elastic): poll the tracker at every
        # commit boundary and re-rendezvous when an epoch is pending.
        self._elastic = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def init(self, params: dict) -> None:
        self._num_global_replica = int(
            params.get("rabit_global_replica")
            or os.environ.get("RABIT_GLOBAL_REPLICA", 5))
        self._num_local_replica = int(
            params.get("rabit_local_replica")
            or os.environ.get("RABIT_LOCAL_REPLICA", 2))
        check(self._num_global_replica > 0, "rabit_global_replica must be >= 1")
        check(self._num_local_replica > 0, "rabit_local_replica must be >= 1")
        self._recover_attempts = int(
            params.get("rabit_recover_attempts")
            or os.environ.get("RABIT_RECOVER_ATTEMPTS", 8))
        check(self._recover_attempts > 0,
              "rabit_recover_attempts must be >= 1")
        ckpt_dir = str(params.get("rabit_ckpt_dir")
                       or os.environ.get("RABIT_CKPT_DIR", "")).strip()
        # `x or env` would silently turn an explicit (invalid) 0 into
        # the default instead of failing the >= 1 check below.
        keep_raw = params.get("rabit_ckpt_keep")
        if keep_raw in (None, ""):
            keep_raw = os.environ.get("RABIT_CKPT_KEEP", 3)
        ckpt_keep = int(keep_raw)
        writers_raw = params.get("rabit_ckpt_writers")
        if writers_raw in (None, ""):
            writers_raw = os.environ.get("RABIT_CKPT_WRITERS", "")
        self._elastic = str(
            params.get("rabit_elastic")
            or os.environ.get("RABIT_ELASTIC", "0")).lower() in _TRUE
        super().init(params)  # refusals, then rendezvous: rank known
        if ckpt_dir:
            check(ckpt_keep >= 1, "rabit_ckpt_keep must be >= 1")
            self._ckpt_dir_raw = ckpt_dir
            self._ckpt_keep = ckpt_keep
            # Writer election: the first rabit_ckpt_writers ranks persist.
            # Default: rank 0 plus the ranks that ring-replicate its
            # local model — the same set whose RAM already holds the
            # hottest state, so adding disk IO there costs no extra
            # replication traffic.
            self._ckpt_writers = (int(writers_raw) if str(writers_raw)
                                  else 1 + self._num_local_replica)
            check(self._ckpt_writers >= 1,
                  "rabit_ckpt_writers must be >= 1")
            self._ckpt_store = ckpt_mod.CheckpointStore(
                ckpt_mod.expand_dir(ckpt_dir, self._rank),
                rank=self._rank, keep=ckpt_keep)
        self._num_trial = int(params.get("rabit_num_trial")
                              or os.environ.get("RABIT_NUM_TRIAL", 0))
        mock = (params.get("mock") or params.get("rabit_mock")
                or os.environ.get("RABIT_MOCK", ""))
        for spec in str(mock).split(";"):
            if not spec.strip():
                continue
            rank, version, seqno, ndeath = (int(x) for x in spec.split(","))
            if rank == self._rank:
                self._kill_points.add((version, seqno, ndeath))

    @staticmethod
    def _refuse_unported(params: dict, param_or_env) -> None:
        """The pysocket engine's refusals, plus the robust engine's own
        knobs whose machinery is not ported (each read as the reference
        reads it, so that a value the reference treats as off passes)."""
        PySocketEngine._refuse_unported(params, param_or_env)
        raw = params.get("rabit_adapt") or os.environ.get("RABIT_ADAPT", "0")
        if str(raw).lower() in _TRUE:
            raise NotImplementedError(
                f"rabit_adapt={raw!r} is not ported to rabit_tpu_torch yet "
                f"(ROADMAP A8)")

    def shutdown(self) -> None:
        self._fence()  # async stream drains before straggler serving
        if self._world > 1 and self._links:
            try:
                # Serve stragglers (replay, checkpoint loads) until the
                # whole world reaches shutdown.
                self._recover_exec(K_SHUTDOWN, want_result=False)
            except Exception as e:  # noqa: BLE001 — best effort, peers may be gone
                log("pyrobust: shutdown straggler serving abandoned: "
                    "%s: %s", type(e).__name__, e)
        super().shutdown()

    def _verify(self, seqno: int) -> None:
        """Mock kill-point: die with the restart exit code when this rank
        reaches (version, seqno) on its ndeath-th life."""
        if (self._version, seqno, self._num_trial) in self._kill_points:
            log("pyrobust: killed at kill-point v=%d seq=%d trial=%d",
                self._version, seqno, self._num_trial)
            os._exit(254)  # the keepalive launcher's restart code

    # ------------------------------------------------------------------
    # consensus machinery
    # ------------------------------------------------------------------
    @staticmethod
    def _fingerprint(*parts) -> int:
        """Deterministic cross-process op fingerprint (never 0: zero
        marks 'no op pending' — checkpoint/load/shutdown states)."""
        raw = ":".join(str(p) for p in parts).encode()
        return (zlib.crc32(raw) & 0xFFFFFFFF) or 1

    def _merge_word(self, dst: np.ndarray, src: np.ndarray) -> None:
        """Pairwise consensus merge: OR the flags, keep min seqno + max
        version, derive divergence flags, and compare fingerprints only
        at an equal (seq, version) — fingerprints of different ops are
        incomparable."""
        df, ds, dv, dp = (int(x) for x in dst)
        sf, ss, sv, sp = (int(x) for x in src)
        flags = df | sf
        if ds != ss:
            flags |= K_DIFF_SEQ
        if dv != sv:
            flags |= K_DIFF_VERSION
        if ds == ss and dv == sv:
            if dp and sp and dp != sp:
                flags |= K_DIFF_OP
            fp = dp or sp
        else:
            fp = dp if ds < ss else sp  # min-seq side's op
        dst[0] = flags
        dst[1] = min(ds, ss)
        dst[2] = max(dv, sv)
        dst[3] = fp

    def _consensus(self, my_flag: int, fp: int = 0) -> tuple[int, int, int]:
        """One consensus allreduce with failure recovery built in.
        Returns (flags, seq, version) agreed by the whole world."""
        while True:
            word = np.array([my_flag, self._seq, self._version, fp],
                            dtype=np.uint32)
            try:
                self._tree_chunked(
                    memoryview(word).cast("B"), 1, _WORD_BYTES,
                    lambda off, n, src: self._merge_word(
                        word, np.frombuffer(src, np.uint32, 4)))
                return int(word[0]), int(word[1]), int(word[2])
            except LinkError:
                self._rendezvous_recover()

    def _agree_root(self, i_have: bool, key: int) -> int:
        """Agree on a serving root: max (key, then lowest rank); -1 when
        nobody has the item."""
        word = np.zeros(1, dtype=np.uint64)
        if i_have:
            word[0] = ((key + 1) << 20) | (0xFFFFF - self._rank)
        self._tree_chunked(
            memoryview(word).cast("B"), 1, 8,
            lambda off, n, src: np.maximum(
                word, np.frombuffer(src, np.uint64, 1), out=word))
        if word[0] == 0:
            return -1
        return 0xFFFFF - (int(word[0]) & 0xFFFFF)

    def _rendezvous_recover(self) -> None:
        """Cascade into a tracker recover round; retried because link
        setup itself can fail while more peers are still dying
        (survivors holding a topology that names a dead worker fail
        wiring and come back with cmd=recover).

        Bounded on two axes: at most ``rabit_recover_attempts`` failed
        rounds (each attempt already carries the full connect
        retry/backoff schedule), within the barrier deadline.
        Exhausting either budget raises :class:`RecoveryError` with the
        per-attempt failure history."""
        deadline = time.monotonic() + (
            self.TRACKER_BARRIER_MIN_SEC if self._timeout is None
            else max(self._timeout, self.TRACKER_BARRIER_MIN_SEC))
        history: list[tuple[int, float, str]] = []
        old_world, old_epoch = self._world, self._epoch
        old_rank = self._rank
        while True:
            try:
                self._rendezvous(P.CMD_RECOVER)
                if (self._world, self._epoch) != (old_world, old_epoch):
                    if (self._world, self._rank) == (old_world, old_rank):
                        # Same world, same rank, new epoch: membership
                        # is unchanged for this rank's purposes, so the
                        # in-flight op and its caches stay valid.
                        self._sched_epoch(old_epoch)
                    else:
                        # The recover round completed as an elastic
                        # rescale (heartbeat-detected deaths shrank the
                        # target, or a pending grow resolved while we
                        # were re-registering): the in-flight op
                        # belongs to the dead world.
                        self._world_changed(old_world, old_epoch)
                return
            except OSError as e:
                attempt = len(history) + 1
                history.append((attempt, time.monotonic(),
                                f"{type(e).__name__}: {e}"))
                if (attempt >= self._recover_attempts
                        or time.monotonic() >= deadline):
                    narrative = "; ".join(
                        f"#{a} {err}" for a, _, err in history)
                    raise RecoveryError(
                        f"pyrobust: recover rendezvous failed {attempt} "
                        f"time(s) (budget {self._recover_attempts} "
                        f"attempts / barrier deadline) — tracker or "
                        f"peers unreachable: {narrative}", history)
                log("pyrobust: recover rendezvous failed (%s); attempt "
                    "%d/%d", e, attempt, self._recover_attempts)
                time.sleep(self._backoff_delay_ms(attempt) / 1000.0)

    # ------------------------------------------------------------------
    # elastic membership
    # ------------------------------------------------------------------
    def _world_changed(self, old_world: int, old_epoch: int) -> None:
        """An elastic rescale landed: reset everything the old world
        owned and surface the typed error.

        Kept: the committed version and global model (every rank
        replicates them — that is exactly what the app resumes from)
        and this rank's durable store contents.  Void: the replay cache
        and seqno stream (results were computed BY the old world),
        local-model replicas (ring positions moved; local state is
        rank-affine and must be rebuilt from the re-sharded data) and
        any un-committed pending checkpoint.  The durable-store handle
        is re-created because the writer election and the ``{rank}``
        expansion follow the new rank."""
        self._cache.clear()
        self._seq = 0
        self._local_store.clear()
        self._local = None
        self._pending_lazy = None
        self._pending_global = b""
        self._has_pending_local = False
        if self._ckpt_dir_raw:
            self._ckpt_store = ckpt_mod.CheckpointStore(
                ckpt_mod.expand_dir(self._ckpt_dir_raw, self._rank),
                rank=self._rank, keep=self._ckpt_keep)
        log("pyrobust: membership epoch %d -> %d: world %d -> %d, now "
            "rank %d; resuming from committed v%d", old_epoch, self._epoch,
            old_world, self._world, self._rank, self._version)
        raise WorldChangedError(old_world, self._world, self._epoch)

    def _sched_epoch(self, old_epoch: int) -> None:
        """A SAME-world, same-rank epoch landed: an elastic member swap
        kept every survivor's rank (the reference also lands its
        adaptive controller's schedule-switch epochs here; that
        controller is ROADMAP A8).  Nothing rank-affine moved, so —
        unlike :meth:`_world_changed` — the replay cache, seqno stream
        and local replicas stay VALID and are kept: cached results are
        value-level bytes, and a relaunched straggler mid-span still
        replays against them.  No WorldChangedError: the app never
        notices."""
        log("pyrobust: membership epoch %d -> %d (world %d and rank %d "
            "unchanged)", old_epoch, self._epoch, self._world, self._rank)

    def _poll_rescale_pending(self) -> bool:
        """Commit-boundary tracker poll: is a rescale epoch pending?
        Unreachable tracker == "no" — training never stalls on the
        poll; the consensus OR of every rank's answer (K_RESCALE)
        makes the final decision uniform even when polls race the
        tracker's admission bookkeeping."""
        polled = self._tracker_epoch_poll()
        if polled is None:
            return False
        _epoch, target_epoch, target_world = polled
        if target_epoch <= self._epoch:
            return False
        log("pyrobust: rescale pending at the tracker: epoch %d -> %d "
            "(world %d -> %d); re-rendezvousing at this commit boundary",
            self._epoch, target_epoch, self._world, target_world)
        return True

    def _cooperative_rescale(self) -> None:
        """The agreed ack round carried K_RESCALE: every member leaves
        the commit boundary together into the tracker's rescale
        rendezvous.  If the target evaporated meanwhile (a parked
        joiner died), the round completes at the unchanged world and
        epoch — links are rewired, nothing is raised, training simply
        continues."""
        old_world, old_epoch = self._world, self._epoch
        old_rank = self._rank
        self._rendezvous(P.CMD_RESCALE)
        if (self._world, self._epoch) != (old_world, old_epoch):
            if (self._world, self._rank) == (old_world, old_rank):
                self._sched_epoch(old_epoch)
            else:
                self._world_changed(old_world, old_epoch)

    # ------------------------------------------------------------------
    # the recovery state machine
    # ------------------------------------------------------------------
    def _recover_exec(self, my_flag: int, want_result: bool,
                      fp: int = 0) -> Optional[bytes]:
        """Loop consensus rounds, serving recovery data, until the whole
        world is aligned at (my_flag, seq, version) (reference analogue:
        src/allreduce_robust.cc:832-902).

        Returns the cached result bytes when the caller's own collective
        was satisfied from a peer's replay cache (the caller must NOT
        execute it, nor call ``prepare_fun``); None once aligned.
        """
        loader = bool(my_flag & K_LOAD_CHECK)
        while True:
            try:
                flags, seq, version = self._consensus(my_flag, fp)
                self._last_agreed = flags
                if flags & K_LOAD_CHECK:
                    if my_flag & K_CHECKPOINT:
                        # A relaunched peer is loading while we sit at
                        # the checkpoint barrier: commit FIRST so the
                        # loader is served the NEW version (serving the
                        # stale one would resume it into a dead
                        # iteration).  Known corner: this commit clears
                        # the replay cache, so a survivor starved of the
                        # final pre-checkpoint result by a crash that
                        # split the tree mid-broadcast fails loudly on
                        # the version check below instead of being
                        # served.
                        self._commit_checkpoint()
                        self._serve_checkpoint_load(loader)
                        return None  # barrier complete via early commit
                    served = self._serve_checkpoint_load(loader)
                    if loader and served:
                        return None
                    continue
                if flags & K_DIFF_VERSION:
                    if self._version < version:
                        if my_flag & K_CHECKPOINT:
                            # The version advanced while we were at the
                            # barrier: the commit already happened
                            # globally; commit ours now.
                            self._commit_checkpoint()
                            return None
                        error("pyrobust: version fell behind (%d < %d) "
                              "outside a checkpoint barrier — collective "
                              "call sequences diverged across ranks",
                              self._version, version)
                    continue  # someone else is catching up
                if flags & K_DIFF_SEQ:
                    got = self._serve_result(seq, want_result
                                             and my_flag == 0)
                    if got is not None:
                        return got
                    continue
                # Versions and seqnos are uniform across the world.
                agreed = flags
                if my_flag == 0:
                    check(not (agreed & K_DIFF_OP),
                          "pyrobust: ranks disagree on the op at "
                          "version=%d seq=%d (op type / reduce op / "
                          "payload size mismatch) — collective call "
                          "sequences diverged", self._version, self._seq)
                    if agreed == 0:
                        return None  # everyone ready: run the real op
                    continue  # checkpoint/shutdown stragglers draining
                if my_flag & K_CHECKPOINT:
                    if agreed == my_flag:
                        return None  # barrier complete
                    mine_wo_local = my_flag & ~K_LOCAL_CHK
                    if ((agreed & ~(K_LOCAL_CHK | K_DIFF_OP))
                            == mine_wo_local
                            and (agreed & K_LOCAL_CHK)
                            != (my_flag & K_LOCAL_CHK)):
                        error("pyrobust: local checkpoint model must be "
                              "passed on every rank or none (reference: "
                              "LocalModelCheck)")
                    continue
                if my_flag & K_CHECK_ACK:
                    # Commit phase done once nobody is still at the barrier.
                    if not (agreed & K_CHECKPOINT):
                        return None
                    continue
                if my_flag & K_SHUTDOWN:
                    if agreed == K_SHUTDOWN:
                        return None
                    continue
                continue
            except LinkError:
                self._rendezvous_recover()

    def _serve_result(self, seq: int, i_want: bool) -> Optional[bytes]:
        """One serving round for the cached result of ``seq``.  All ranks
        participate in the tree flood from the agreed holder; returns
        the bytes iff this rank is replaying exactly this seqno."""
        root = self._agree_root(seq in self._cache, 1)
        check(root >= 0,
              "pyrobust: result seq %d is cached nowhere — unrecoverable "
              "(raise rabit_global_replica)", seq)
        blob = self._cache[seq] if self._rank == root else None
        blob = self._bcast_impl(blob, root)
        if i_want and self._seq == seq:
            return blob
        return None

    def _serve_checkpoint_load(self, i_am_loader: bool) -> bool:
        """Serve the newest checkpoint to (re)started loaders, then run
        local-model ring recovery.  Returns True once a loader is
        satisfied."""
        root = self._agree_root(self._has_checkpoint, self._version)
        if root < 0:
            # No live rank holds a checkpoint: the durable-tier cold
            # path (or a genuinely fresh start at version 0).
            return self._cold_checkpoint_load(i_am_loader)
        if self._rank == root:
            self._materialize_global()
            blob = struct.pack("<I", self._version) + (self._global or b"")
        else:
            blob = None
        blob = self._bcast_impl(blob, root)
        if i_am_loader and self._rank != root:
            (bver,) = struct.unpack_from("<I", blob)
            # Version-skew guard BEFORE installing: a valid disk
            # checkpoint newer than the cluster-agreed version means
            # this rank's durable tier outran the live world (wrong
            # job, or the survivors lost committed state) — serving
            # the stale agreement would silently roll work backward.
            self._check_ckpt_skew(int(bver))
            self._version = int(bver)
            self._global = blob[4:]
            self._lazy_global = None  # received bytes supersede stale lazy
            self._has_checkpoint = True
            self._seq = 0
            self._cache.clear()
        # Local-model ring recovery: run whenever anyone anywhere holds
        # local state (all ranks must walk the ring passes together).
        if self._agree_root(bool(self._local_store), 1) >= 0:
            self._recover_local()
        return i_am_loader

    def _cold_checkpoint_load(self, i_am_loader: bool) -> bool:
        """Cold-restart path: nobody alive holds a checkpoint.

        Every rank runs the SAME agreement rounds (the store may be
        configured on only some ranks — e.g. writer-only disks — so the
        collective structure must not depend on rank-local config):

        1. unanimity check — a non-loader without a checkpoint is a
           live version-0 world mid-flight; loading an (older-job) disk
           version underneath it would fork versions, so disk is only
           consulted when EVERY rank is a loader;
        2. each rank reads its newest valid on-disk version, the world
           agrees on the max-version holder, and that rank re-serves
           the CRC-stamped blob verbatim over the tree flood.

        Falls through to the fresh version-0 start when no rank has a
        valid durable checkpoint."""
        someone_running = self._agree_root(not i_am_loader, 1) >= 0
        disk = None
        if not someone_running:
            disk = self._try_disk_read()
        droot = self._agree_root(disk is not None,
                                 disk.version if disk is not None else 0)
        if droot < 0:
            # Fresh start everywhere: loaders are satisfied with version 0.
            return True
        blob = disk.raw if self._rank == droot else None
        blob = self._bcast_impl(blob, droot)
        self._install_disk_checkpoint(bytes(blob))
        log("pyrobust: cold-restart: resumed version %d from the durable "
            "tier (served by rank %d)", self._version, droot)
        return i_am_loader

    def _try_disk_read(self) -> Optional[ckpt_mod.DiskCheckpoint]:
        if self._ckpt_store is None:
            return None
        try:
            return self._ckpt_store.load_latest()
        except OSError as e:
            log("pyrobust: durable checkpoint read failed: %s", e)
            return None

    def _install_disk_checkpoint(self, raw: bytes) -> None:
        """Adopt a durable checkpoint blob as this rank's committed
        state (the CRC is re-verified — the bytes crossed the wire)."""
        try:
            dc = ckpt_mod.unpack_blob(raw)
        except ValueError as e:
            error("pyrobust: served durable checkpoint is invalid: %s", e)
        self._version = dc.version
        self._global = dc.global_blob
        self._lazy_global = None
        self._has_checkpoint = True
        self._seq = 0
        self._cache.clear()
        if dc.world == self._world:
            for origin, blob in dc.locals.items():
                dist = (self._rank - origin) % self._world
                if origin == self._rank or dist <= self._num_local_replica:
                    self._local_store[origin] = (dc.version, blob)
            if self._rank in dc.locals:
                self._local = dc.locals[self._rank]
        elif dc.locals:
            log("pyrobust: durable checkpoint was written by a world of "
                "%d (now %d); local models discarded, global state kept",
                dc.world, self._world)

    def _check_ckpt_skew(self, agreed_version: int) -> None:
        """Note this cannot misfire on a writer that persisted and died
        mid-barrier: a loader arriving at the checkpoint barrier makes
        every survivor commit FIRST (the commit-early rule in
        _recover_exec), so the version the world serves always catches
        up to anything a writer managed to persist; genuinely newer
        disk therefore means foreign or lost state — fail loudly."""
        if self._ckpt_store is None:
            return
        newest = self._ckpt_store.newest_version(
            min_version=agreed_version)
        if newest is not None and newest > agreed_version:
            raise ckpt_mod.CheckpointSkewError(newest, agreed_version)

    # ------------------------------------------------------------------
    # collectives with replay
    # ------------------------------------------------------------------
    def _striped(self, seq: int) -> bool:
        rnd = max(self._world // self._num_global_replica, 1)
        return seq % rnd == self._rank % rnd

    def _prune_stale(self) -> None:
        """Striped replication bounds cache memory (reference:
        src/allreduce_robust.cc:86-89).  Runs after the consensus round,
        never at push time — a peer that died mid-op recovers the newest
        result from *any* completer."""
        for seq in [s for s in self._cache if not self._striped(s)]:
            del self._cache[seq]

    def _push_result(self, blob: bytes) -> None:
        self._cache[self._seq] = blob
        self._seq += 1

    def _run_collective(self, attempt: Callable[[], bytes], nbytes: int,
                        fp: int) -> bytes:
        """Run ``attempt`` (the real op on a working copy — the user
        buffer stays pristine for retries) with recovery: on LinkError,
        re-rendezvous and either replay the result a completer cached or
        retry the op once the world re-aligns."""
        while True:
            try:
                return attempt()
            except LinkError:
                self._rendezvous_recover()
                recovered = self._recover_exec(0, want_result=True, fp=fp)
                if recovered is not None:
                    check(len(recovered) == nbytes,
                          "pyrobust: recovered result size %d != expected "
                          "%d — collective call sequences diverged",
                          len(recovered), nbytes)
                    return recovered

    def _allreduce_blocking(
        self,
        buf: np.ndarray,
        op: ReduceOp,
        prepare_fun: Optional[Callable[[], None]] = None,
    ) -> np.ndarray:
        # The robust op body; the public blocking entry point (inherited
        # from PySocketEngine) fences the async stream first, and the
        # async progress thread runs this directly — either way the
        # seqno stream sees one ordered op sequence.
        self._verify(self._seq)
        self._last_replayed = False
        if self._world == 1:
            if prepare_fun is not None:
                prepare_fun()
            self._seq += 1
            return buf
        flat = buf.reshape(-1)
        nbytes = flat.nbytes
        fp = self._fingerprint("allreduce", int(op), buf.dtype.str, nbytes)
        recovered = self._recover_exec(0, want_result=True, fp=fp)
        if recovered is not None:
            self._last_replayed = True
            check(len(recovered) == nbytes,
                  "pyrobust: recovered allreduce size %d != %d",
                  len(recovered), nbytes)
            flat[:] = np.frombuffer(recovered, dtype=flat.dtype)
            self._prune_stale()
            self._push_result(recovered)
            return buf
        self._prune_stale()
        if prepare_fun is not None:
            prepare_fun()

        def attempt() -> bytes:
            work = flat.copy()
            self._allreduce_dispatch(work, op)
            return work.tobytes()

        result = self._run_collective(attempt, nbytes, fp)
        flat[:] = np.frombuffer(result, dtype=flat.dtype)
        self._push_result(result)
        return buf

    def _allreduce_custom_blocking(self, buf: np.ndarray, reducer,
                                   prepare_fun=None) -> np.ndarray:
        self._verify(self._seq)
        self._last_replayed = False
        if self._world == 1:
            if prepare_fun is not None:
                prepare_fun()
            self._seq += 1
            return buf
        nbytes = buf.nbytes
        fp = self._fingerprint("custom", buf.dtype.str, buf.shape)
        recovered = self._recover_exec(0, want_result=True, fp=fp)
        if recovered is not None:
            self._last_replayed = True
            check(len(recovered) == nbytes,
                  "pyrobust: recovered custom allreduce size %d != %d",
                  len(recovered), nbytes)
            buf.reshape(-1)[:] = np.frombuffer(recovered, dtype=buf.dtype)
            self._prune_stale()
            self._push_result(recovered)
            return buf
        self._prune_stale()
        if prepare_fun is not None:
            prepare_fun()

        def attempt() -> bytes:
            work = buf.copy()
            self._allreduce_custom_impl(work, reducer)
            return work.tobytes()

        result = self._run_collective(attempt, nbytes, fp)
        buf.reshape(-1)[:] = np.frombuffer(result, dtype=buf.dtype)
        self._push_result(result)
        return buf

    def _broadcast_blocking(self, data: Optional[bytes], root: int) -> bytes:
        self._verify(self._seq)
        self._last_replayed = False
        if self._world == 1:
            check(data is not None, "broadcast: root rank must supply data")
            self._seq += 1
            return data
        # Payload size is root-only knowledge, so the fingerprint covers
        # the op type and root; the replay path checks the size at the
        # root, which does know it.
        fp = self._fingerprint("broadcast", root)
        recovered = self._recover_exec(0, want_result=True, fp=fp)
        if recovered is not None:
            self._last_replayed = True
            # A cached result that disagrees with what this (relaunched)
            # root would have sent means the call sequences diverged.
            check(data is None or len(recovered) == len(data),
                  "pyrobust: recovered broadcast size %d != root payload "
                  "%d — collective call sequences diverged",
                  len(recovered), len(data or b""))
            self._prune_stale()
            self._push_result(recovered)
            return recovered
        self._prune_stale()
        while True:
            try:
                out = self._bcast_impl(data, root)
                break
            except LinkError:
                self._rendezvous_recover()
                recovered = self._recover_exec(0, want_result=True, fp=fp)
                if recovered is not None:
                    out = recovered
                    break
        out = bytes(out)
        self._push_result(out)
        return out

    def _allgather_blocking(self, buf: np.ndarray) -> np.ndarray:
        self._verify(self._seq)
        self._last_replayed = False
        if self._world == 1:
            self._seq += 1
            return buf[None]
        total = buf.nbytes * self._world
        shape = (self._world,) + buf.shape
        fp = self._fingerprint("allgather", buf.dtype.str, buf.nbytes)
        recovered = self._recover_exec(0, want_result=True, fp=fp)
        if recovered is not None:
            self._last_replayed = True
            check(len(recovered) == total,
                  "pyrobust: recovered allgather size %d != %d",
                  len(recovered), total)
            self._prune_stale()
            self._push_result(recovered)
            return np.frombuffer(recovered,
                                 dtype=buf.dtype).reshape(shape).copy()
        self._prune_stale()

        def attempt() -> bytes:
            return self._allgather_impl(buf).tobytes()

        result = self._run_collective(attempt, total, fp)
        self._push_result(result)
        return np.frombuffer(result, dtype=buf.dtype).reshape(shape).copy()

    def _fused_allreduce_exec(self, items: list, op: ReduceOp) -> None:
        """Bucket-fused allreduce under the robust protocol: the whole
        bucket is ONE collective — one consensus round, one seqno, one
        cached result — so replay after a failure serves the fused
        payload exactly as it serves any other op.  Bucket boundaries
        are deterministic in program order, so a relaunched rank
        re-issuing the same async stream reproduces the same seqno map
        as the survivors."""
        self._verify(self._seq)
        self._last_replayed = False
        flats = [it[0] for it in items]
        dtype = flats[0].dtype
        sizes = tuple(len(f) for f in flats)
        nbytes = int(sum(sizes)) * dtype.itemsize
        fp = self._fingerprint("fused_allreduce", int(op), dtype.str, sizes)
        recovered = self._recover_exec(0, want_result=True, fp=fp)
        if recovered is not None:
            self._last_replayed = True
            check(len(recovered) == nbytes,
                  "pyrobust: recovered fused allreduce size %d != %d",
                  len(recovered), nbytes)
            # Replay: members' prepare_funs are skipped, like any
            # cache-served collective.
            self._scatter_fused(flats, np.frombuffer(recovered, dtype=dtype))
            self._prune_stale()
            self._push_result(recovered)
            for _flat, buf, _prep, h in items:
                self._resolve_handle(h, buf)
            return
        self._prune_stale()
        for _flat, _buf, prep, _h in items:
            if prep is not None:
                prep()
        pristine = np.concatenate(flats)

        def attempt() -> bytes:
            # Member arrays must be pristine on every retry (a LinkError
            # can strike mid-reduction, leaving them partially merged).
            self._scatter_fused(flats, pristine)
            self._fused_wire(flats, op)
            return np.concatenate(flats).tobytes()

        result = self._run_collective(attempt, nbytes, fp)
        self._scatter_fused(flats, np.frombuffer(result, dtype=dtype))
        self._push_result(result)
        for _flat, buf, _prep, h in items:
            self._resolve_handle(h, buf)

    @property
    def last_op_replayed(self) -> bool:
        """True iff the LAST collective was served from the replay cache
        (the op completed before this relaunched rank joined).  Mid-op
        recovery — this rank participated, a peer died, the result was
        recovered — counts as fresh."""
        return self._last_replayed

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _materialize_global(self) -> None:
        if self._lazy_global is not None:
            self._global = self._lazy_global()
            self._lazy_global = None

    def _commit_checkpoint(self) -> None:
        if self._pending_lazy is not None:
            self._lazy_global = self._pending_lazy
            self._pending_lazy = None
            self._global = b""
        else:
            self._global = self._pending_global
            self._lazy_global = None
        self._has_checkpoint = True
        self._version += 1
        if self._has_pending_local:
            self._local_store[self._rank] = (self._version,
                                             self._pending_local)
            self._local = self._pending_local  # world-of-1 load path
        self._cache.clear()
        self._seq = 0
        if self._is_ckpt_writer():
            self._persist_checkpoint()

    def _is_ckpt_writer(self) -> bool:
        return (self._ckpt_store is not None
                and self._rank < min(self._ckpt_writers, self._world))

    def _persist_checkpoint(self) -> None:
        """Durably persist the just-committed version (writer ranks
        only).  Persistence is synchronous inside the commit, so a
        persisted version is always one the whole world agreed (at the
        checkpoint barrier) to commit; failures degrade durability
        (logged), they never kill the job — the RAM replicas still
        cover it."""
        try:
            self._materialize_global()  # lazy blobs must hit the disk too
            locals_ = {origin: blob
                       for origin, (version, blob)
                       in self._local_store.items()
                       if version == self._version}
            self._ckpt_store.persist(self._version, self._world,
                                     self._global or b"", locals_)
        except OSError as e:
            log("pyrobust: durable checkpoint persist failed (v%d): %s",
                self._version, e)

    def checkpoint(self, global_model, local_model=None,
                   lazy_global=None) -> None:
        self._fence()  # in-flight async ops belong to this version span
        self._verify(SEQ_CHECKPOINT)
        if global_model is None and lazy_global is not None:
            self._pending_global = b""
            self._pending_lazy = lazy_global
        else:
            self._pending_global = global_model or b""
            self._pending_lazy = None
        self._has_pending_local = local_model is not None
        self._pending_local = local_model or b""
        if self._world == 1:
            self._commit_checkpoint()
            if self._elastic and self._poll_rescale_pending():
                # A lone rank can still grow: joiners parked at the
                # tracker make the next commit a rescale boundary too.
                self._cooperative_rescale()
            return
        flag = K_CHECKPOINT | (K_LOCAL_CHK if self._has_pending_local else 0)
        version_before = self._version
        self._recover_exec(flag, want_result=False)
        if self._version == version_before:  # not committed via catch-up
            if self._has_pending_local:
                # Every rank exits the barrier on the same consensus
                # round, so the ring replication passes align globally.
                self._local_store[self._rank] = (self._version + 1,
                                                 self._pending_local)
                try:
                    self._replicate_local()
                except LinkError:
                    # Degraded: this checkpoint's local blobs are
                    # under-replicated until the next one; global safety
                    # is unaffected.
                    self._rendezvous_recover()
            self._commit_checkpoint()
        ack = K_CHECK_ACK
        if self._elastic and self._poll_rescale_pending():
            ack |= K_RESCALE
        self._recover_exec(ack, want_result=False)
        if self._elastic and (self._last_agreed & K_RESCALE):
            # Some rank's poll saw a pending epoch; the OR-merged ack
            # made it everyone's decision.  The commit above is already
            # durable on every survivor — this raises WorldChangedError
            # once the new topology lands.
            self._cooperative_rescale()

    def load_checkpoint(self):
        self._fence()
        self._verify(SEQ_LOAD_CHECK)
        if self._world == 1:
            if not self._has_checkpoint:
                disk = self._try_disk_read()
                if disk is None:
                    return (0, None, None)
                self._install_disk_checkpoint(disk.raw)
                log("pyrobust: cold-restart: resumed version %d from the "
                    "durable tier", self._version)
            self._materialize_global()
            return (self._version, self._global, self._local)
        self._recover_exec(K_LOAD_CHECK, want_result=False)
        if not self._has_checkpoint:
            return (0, None, None)
        self._materialize_global()
        local = None
        entry = self._local_store.get(self._rank)
        if entry is not None and entry[0] == self._version:
            local = entry[1]
        self._seq = 0
        return (self._version, self._global or None, local)

    # ------------------------------------------------------------------
    # local-model ring replication
    # ------------------------------------------------------------------
    def _ring_pass_blobs(self, backward: bool) -> None:
        """Exchange the whole local store with ring neighbours and merge
        keeping the highest version per origin.  Forward pass sends
        toward ring_next; backward toward ring_prev."""
        out = bytearray(struct.pack("<I", len(self._local_store)))
        for origin, (version, blob) in sorted(self._local_store.items()):
            out += struct.pack("<IIQ", origin, version, len(blob))
            out += blob
        send_rank = self._ring_prev if backward else self._ring_next
        recv_rank = self._ring_next if backward else self._ring_prev
        in_size = memoryview(bytearray(8))
        self._exchange(send_rank, memoryview(struct.pack("<Q", len(out))),
                       recv_rank, in_size)
        (n_in,) = struct.unpack("<Q", bytes(in_size))
        incoming = memoryview(bytearray(n_in))
        self._exchange(send_rank, memoryview(out), recv_rank, incoming)
        raw = bytes(incoming)
        (count,) = struct.unpack_from("<I", raw, 0)
        pos = 4
        for _ in range(count):
            origin, version, length = struct.unpack_from("<IIQ", raw, pos)
            pos += 16
            blob = raw[pos:pos + length]
            pos += length
            have = self._local_store.get(int(origin))
            if have is None or have[0] < int(version):
                self._local_store[int(origin)] = (int(version), blob)

    def _replicate_local(self) -> None:
        """Push blobs forward so ranks r+1..r+K hold origin r's state,
        then prune to the origins this rank is responsible for."""
        for _ in range(self._num_local_replica):
            self._ring_pass_blobs(backward=False)
        for origin in list(self._local_store):
            dist = (self._rank - origin) % self._world
            if dist > self._num_local_replica:
                del self._local_store[origin]

    def _recover_local(self) -> None:
        """Backward floods bring each origin's blob back to the origin
        (any survivor within K successors holds it), then forward floods
        restore the replication invariant."""
        for _ in range(self._num_local_replica):
            self._ring_pass_blobs(backward=True)
        self._replicate_local()
