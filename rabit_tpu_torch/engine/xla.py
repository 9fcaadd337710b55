"""The device-plane engine: tensors reduce on a ``torch.distributed``
process group while a fault-tolerant host engine keeps the control plane.

PyTorch-port counterpart of :mod:`rabit_tpu.engine.xla` (its own copy:
the port imports nothing of the JAX package), with the reference's
module name, engine name (``rabit_engine="xla"``) and structure, so
that each member has its counterpart there.  Where the reference runs
its bulk collectives as XLA programs over a process mesh, the port runs
them on a process group that the engine forms itself and holds as an
object:

* **control plane** — rank rendezvous, byte broadcast, checkpoints,
  tracker prints and fault tolerance — delegates to an inner host
  engine (``pyrobust`` by default, ``pysocket`` when named) speaking
  the tracker protocol.
* **data plane** — ``torch.Tensor`` allreduce and allgather — runs on a
  ``ProcessGroupGloo`` or ``ProcessGroupNCCL`` built on a
  ``PrefixStore`` of a tracker-hosted ``TCPStore``.  The engine never
  calls ``init_process_group``: the caller's default group, if there is
  one, is left alone, each re-formation is a new group object on a
  fresh store, and engines on threads of one process form real worlds.

numpy buffers go to the inner host engine (result caching and replay on
failure); tensors stay on their device and are reduced on the group.
The bulk path is not replayed on failure — the checkpoint/recover
contract covers it at iteration granularity.  A device collective that
fails for a runtime or peer reason degrades the engine: the group is
torn down (so peers blocked on this rank fail at once), the payload
rides the host engine and comes back as a tensor on its device, and the
next checkpoint boundary re-forms a fresh group (``device_epoch`` + 1).
A programming error — a reduction the dtype or the backend lacks, a
tensor on the wrong device — raises before any byte moves and never
degrades.

**Backend rule**, decided at formation from every rank's device as
exchanged through the store, identical on every rank and never changed
by a failure (:func:`backend_for`): a world with a rank on the CPU uses
gloo; CUDA ranks each on its own card use NCCL; CUDA ranks that share a
card use gloo, since NCCL refuses two ranks of one communicator on one
device.  Gloo reduces CUDA tensors by staging them through host memory
inside the backend.  The backend is named in ``path_stats["backend"]``
and in one stderr line.

Bootstrap: the inner engine's rendezvous assigns the rank; every rank
asks the tracker (``cmd=jaxsvc``, key ``"init"``) for the job's store,
so the first formation puts no engine op into version span 0; with a
tracker that cannot host one, rank 0 hosts it and broadcasts its
address over the host plane.  Every rank then posts the tracker's
formation barrier (``cmd=formbar``) and forms the group only when all
have posted; an aborted barrier (a rank relaunched in the window) means
a degraded start, re-formed at the first checkpoint boundary.

**Adopt mode** (no tracker, ``torch.distributed``'s default group
already initialised at world > 1, as ``torchrun`` or a caller's own
``init_process_group`` leaves it): rank and world are the group's, the
inner engine is :class:`EmptyEngine` (its in-memory checkpoints), and
there is no host transport: numpy allreduce and allgather and byte
broadcasts ride the default group too (CPU tensors on gloo, CUDA
tensors on NCCL), numpy results copied back in place.  A peer's death
raises :class:`RuntimeError` on the survivors' next collective; there
is nothing to degrade to.

**Mixed mode** (a tracker plus an externally initialised default
group): the engine registers with ``task_id = dist.get_rank()`` unless
a task id is given (with the tracker's ``RABIT_TRACKER_PIN_RANKS=1`` the
two numberings then agree); the host engine keeps the control plane,
numpy ops and the checkpoints, and tensors ride the external group.
The engine does not own the external group, so it never re-forms it,
never aborts it and skips the ordered teardown.  Whether the numberings line
up is agreed at start: a world mismatch every rank can see degrades
every rank with no collective; otherwise one flag a rank is all-gathered
over the external group, and any misaligned rank degrades every rank for
the whole job.  A relaunch comes up degraded for good and never joins
that consensus.

**pallas_ring** (``rabit_device_impl=pallas_ring``, with the size
gate ``rabit_pallas_min_bytes``, 1 MiB by default): large SUM, MAX, MIN
and PROD allreduces of float32, bfloat16 and int32 run the ring kernel
B4 across the rank processes, through the table of
:mod:`rabit_tpu_torch.parallel.peer_ring` (CUDA IPC inboxes and a start
barrier on the host), built at each formation over the group;
:meth:`XLAEngine._use_pallas_ring` is the gate, as the reference's.  The
plane holds the ring only where every rank is on CUDA (on one card, or
on cards that every rank can reach by peer access), decided once at
formation, as the reference holds it only on a TPU backend or in one
process: a CPU group stays on the group's allreduce.  A barrier given
up, or a peer's inbox that cannot be opened, degrades the op like a gloo
failure.  A ring library that does not load, or CUDA IPC that this host
refuses, is no peer's failure: ``init`` probes both on a rank with a
card and raises.

Over an adopted group (adopt and mixed modes) the ring runs as the
reference's does in every mode: the table lives on this rank's card
whatever the group's backend (``torchrun`` on one card must use gloo,
whose tensors are the CPU's), built once at start (in mixed mode only
once the start consensus found the ranks aligned) after one allgather
on the group of every rank's card and the cards it reaches
(:func:`ring_holds`).  In adopt mode a numpy payload that the gate lets
through goes to the card, through the ring, and back in place.  A
peer's death raises :class:`RuntimeError` in adopt mode and degrades
the job for good in mixed mode; the table is never rebuilt.  Shutdown
closes it in order: the peers' handles, a barrier (the group's in adopt
mode, the host plane's in mixed mode), then the inboxes.

Left out, each raising :class:`NotImplementedError` that names its
ROADMAP item: the ``native`` inner engine, the ``mpi`` CPU collectives,
telemetry and tracing, A8.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from rabit_tpu_torch.engine.interface import CollectiveHandle, Engine
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.ops.ring_allreduce import PeerError, supported_ops
from rabit_tpu_torch.parallel import peer_ring
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.utils.checks import check
from rabit_tpu_torch.utils.net import routable_ip

# Transport failures of the backends surface as bare RuntimeError
# (gloo's "Connection closed by peer", "Timed out waiting ... for recv",
# NCCL's remote and system errors) rather than a typed error —
# recognised by message, and only on RuntimeError.
_TRANSPORT_MARKERS = ("connection closed", "connection reset",
                      "connection refused", "broken pipe", "socket closed",
                      "timed out", "timeout", "ncclremoteerror",
                      "ncclsystemerror", "nccl communicator was aborted")

_DIST_OPS = {ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.BITOR: dist.ReduceOp.BOR,
             ReduceOp.BITAND: dist.ReduceOp.BAND,
             ReduceOp.BITXOR: dist.ReduceOp.BXOR}
# What a failed collective raises in adopt mode, where no host engine
# could take the payload instead.
_NO_HOST = ("xla engine: device collective failed and no host transport "
            "is available (adopt mode)")
_BITWISE = (ReduceOp.BITOR, ReduceOp.BITAND, ReduceOp.BITXOR)
# The dtypes both backends reduce.
_DEVICE_DTYPES = (torch.float16, torch.bfloat16, torch.float32,
                  torch.float64, torch.int8, torch.uint8, torch.int32,
                  torch.int64)


def _is_runtime_failure(e: BaseException) -> bool:
    """True for *runtime/peer* failures of a device collective (worth
    degrading to the host path); programming errors must propagate.
    ``torch.distributed``'s typed errors (``DistError`` and its store,
    network and backend subclasses), the ring's :class:`PeerError` and
    OSError always count; a bare RuntimeError counts only with a
    transport marker in its message."""
    if isinstance(e, (dist.DistError, PeerError, OSError)):
        return True
    if type(e) is not RuntimeError:
        return False
    msg = str(e).lower()
    return any(m in msg for m in _TRANSPORT_MARKERS)


def backend_for(devices: list[str]) -> str:
    """The backend rule over every rank's device identity (``"cpu"`` or
    ``"cuda:<uuid>"``, in rank order): gloo when any rank is on the CPU
    or two ranks share a card, NCCL when every rank has a card of its
    own."""
    if any(d == "cpu" for d in devices):
        return "gloo"
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


def check_reduction(backend: str, op: ReduceOp, dtype: torch.dtype) -> None:
    """Raise, before any byte moves, for a reduction the dtype or the
    backend does not have."""
    op = ReduceOp(op)
    if dtype not in _DEVICE_DTYPES:
        raise TypeError(f"device allreduce: unsupported dtype {dtype}")
    if op in _BITWISE and (dtype.is_floating_point or dtype.is_complex):
        raise TypeError(f"device allreduce: {op.name} needs an integer "
                        f"tensor, got {dtype}")
    if backend == "nccl" and op in _BITWISE:
        raise ValueError(f"device allreduce: the nccl backend has no "
                         f"{op.name} reduction")


def device_identity() -> str:
    """This process's device for the backend rule: ``"cpu"`` without
    CUDA, else the current card's UUID (two processes on one card give
    the same string)."""
    if not torch.cuda.is_available():
        return "cpu"
    return device_identity_of(torch.cuda.current_device())


def device_identity_of(index: int) -> str:
    return f"cuda:{torch.cuda.get_device_properties(index).uuid}"


def reachable_cards() -> list[str]:
    """The cards this rank can read, as :func:`device_identity` names
    them: its own, and each card visible here with peer access from
    it."""
    me = torch.cuda.current_device()
    return [device_identity_of(i) for i in range(torch.cuda.device_count())
            if i == me or torch.cuda.can_device_access_peer(me, i)]


#: one rank's record in the ring's holding exchange: its card and the
#: cards it reaches, as JSON, padded to one length on every rank
REACH_BYTES = peer_ring.SLOT_BYTES * (2 + peer_ring.MAX_PEERS)


def reach_record(identity: str, reach: list[str]) -> bytes:
    raw = json.dumps([identity, sorted(reach)]).encode()
    check(len(raw) <= REACH_BYTES, "pallas_ring: %d cards do not fit the "
          "holding exchange's record", len(reach))
    return raw.ljust(REACH_BYTES, b"\0")


def ring_holds(records: list) -> bool:
    """Whether the plane holds the ring, from every rank's
    :func:`reach_record` in rank order: every rank on CUDA, at most the
    kernel's ranks, and each rank reaching every rank's card.  Every
    rank decides from the same records, so every rank gets the same
    answer."""
    entries = [json.loads(bytes(r).rstrip(b"\0")) for r in records]
    devices = {card for card, _ in entries}
    if "cpu" in devices or len(entries) > peer_ring.MAX_PEERS:
        return False
    return all(devices <= set(reach) for _, reach in entries)


def new_group(store, rank: int, world: int, backend: str,
              timeout: datetime.timedelta, host: Optional[str] = None):
    """A process group object on ``store`` (never the default group):
    NCCL, or gloo on the interface ``host`` (the one that routes to the
    tracker; the default interface when None)."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, world, opts)
    check(backend == "gloo", "unknown device-plane backend %r", backend)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=host)
                     if host else
                     dist.ProcessGroupGloo.create_default_device()]
    return dist.ProcessGroupGloo(store, rank, world, opts)


class XLAEngine(Engine):
    def __init__(self) -> None:
        self._inner: Optional[Engine] = None
        self._rank = 0
        self._world = 1
        self._job_id = P.DEFAULT_JOB
        self._tracker_addr: tuple[str, int] = ("", 0)
        self._group = None                 # the device plane's group
        self._store = None                 # its store (client or master)
        self._hosted_store = None          # rank 0's own, without a tracker
        self._backend: Optional[str] = None
        self._device = torch.device("cpu")
        self._member = False               # formed the current group
        self._degraded = False
        self._reform_enabled = True
        self._device_epoch = 0
        self._init_timeout = 300.0
        self._svc_tracker_hosted = False
        # adopt/mixed: the device plane is the caller's default group
        self._adopted = False
        self._no_host_transport = False     # adopt: no host engine at all
        # pallas_ring: the gate's settings and the ring's table, built at
        # formation where the plane holds the ring
        self._device_impl = "psum"
        self._pallas_min_bytes = 1 << 20
        self._ring: Optional[peer_ring.PeerRing] = None
        # inboxes of tables closed on a failure, freed at the next
        # table's formation or ordered teardown (a late peer may still
        # fold them until then)
        self._ring_orphans: list = []
        self.ring_form_ms: Optional[float] = None   # the last table's
        # observable path counters (tests assert post-reform collectives
        # ride the device plane again, not the degraded host path)
        self.path_stats = {"device_ops": 0, "host_ops": 0, "backend": None}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def init(self, params: dict) -> None:
        self._refuse_unported(params)
        # psum is the group's allreduce; pallas_ring runs B4 across the
        # rank processes for allreduces the gate lets through
        self._device_impl = str(
            params.get("rabit_device_impl")
            or os.environ.get("RABIT_DEVICE_IMPL", "psum")).lower()
        check(self._device_impl in ("psum", "pallas_ring"),
              "rabit_device_impl must be psum|pallas_ring, got %r",
              self._device_impl)
        min_bytes = params.get("rabit_pallas_min_bytes")
        if min_bytes is None:
            min_bytes = os.environ.get("RABIT_PALLAS_MIN_BYTES", 1 << 20)
        try:
            self._pallas_min_bytes = int(min_bytes)
        except (TypeError, ValueError):
            check(False, "rabit_pallas_min_bytes must be an integer "
                  "byte count, got %r", min_bytes)
        impl = str(params.get("rabit_jax_cpu_collectives") or "gloo").lower()
        if impl == "mpi":
            raise NotImplementedError(
                "rabit_jax_cpu_collectives='mpi' is not ported to "
                "rabit_tpu_torch yet (ROADMAP A8)")
        check(impl == "gloo", "rabit_jax_cpu_collectives must be gloo, got "
              "%r", impl)
        uri = params.get("rabit_tracker_uri") or os.environ.get(
            "RABIT_TRACKER_URI")
        port = params.get("rabit_tracker_port") or os.environ.get(
            "RABIT_TRACKER_PORT", 0)
        self._tracker_addr = (str(uri), int(port))
        # Tenant identity: must match what the INNER engine registers
        # under, or the formation barrier and store lookups would land
        # in another job than the rendezvous.
        self._job_id = str(params.get("rabit_job_id")
                           or os.environ.get("RABIT_JOB_ID")
                           or P.DEFAULT_JOB)
        # Mid-job-relaunch detection: RABIT_RELAUNCH counts restarts of
        # any cause (kill-point or watchdog); rabit_num_trial alone would
        # miss watchdog restarts, which must also come up degraded.
        trial = max(int(params.get("rabit_num_trial")
                        or os.environ.get("RABIT_NUM_TRIAL", 0)),
                    int(os.environ.get("RABIT_RELAUNCH", 0)))
        external = dist.is_available() and dist.is_initialized()
        if not uri:
            # No tracker: adopt whatever world torch.distributed already
            # lives in (a single process, or torchrun's group).
            from rabit_tpu_torch.engine.empty import EmptyEngine

            self._inner = EmptyEngine()
            self._inner.init(params)
            if external and dist.get_world_size() > 1:
                self._rank = dist.get_rank()
                self._world = dist.get_world_size()
                self._adopted = self._no_host_transport = True
                self._probe_ring()
                self._adopt_default_group()
                self._adopt_ring()
            return
        if external:
            # MIXED mode: register with task_id = the group's rank, so
            # that with rank pinning the control-plane rank is the
            # group's.  A presence test, not truthiness: an explicit
            # task id of "0" must win.
            has_tid = (params.get("rabit_task_id") is not None
                       and str(params.get("rabit_task_id")) != "") or \
                os.environ.get("RABIT_TASK_ID", "") != ""
            if not has_tid:
                params = dict(params, rabit_task_id=str(dist.get_rank()))
        self._inner = self._make_inner(params)
        self._inner.init(params)
        self._rank = self._inner.rank
        self._world = self._inner.world_size
        # The tracker flags mid-job re-registrations too, so platform
        # restarts with a clean environment are still detected.
        if getattr(self._inner, "was_relaunched", False):
            trial = max(trial, 1)
        self._reform_enabled = str(
            params.get("rabit_device_reform")
            or os.environ.get("RABIT_DEVICE_REFORM", "1")) not in (
                "0", "false", "no")
        try:
            self._init_timeout = max(
                30, 2 * int(float(params.get("rabit_timeout_sec")
                                  or os.environ.get("RABIT_TIMEOUT_SEC",
                                                    150))))
        except ValueError:
            self._init_timeout = 300
        if self._world <= 1:
            return
        if external:
            # Set on EVERY life: a relaunch must skip _maybe_reform and
            # the ordered teardown as the adopted survivors do, or its
            # host-plane ops would have no partner.
            self._adopted = True
            self._log_stderr(
                "MIXED mode: the tracker keeps the control plane, tensors "
                "ride the externally initialised torch.distributed group, "
                "which this engine never re-forms after a failure")
            self._probe_ring()
            if trial > 0:
                # the survivors' group no longer holds the previous life
                self._degraded = True
            else:
                self._build_group_mixed()
                if not self._degraded:
                    self._adopt_ring()
            return
        self._probe_ring()
        if trial > 0:
            # Mid-job relaunch: the group of the first life died with
            # it and the survivors' group cannot admit a new member.
            # Come up degraded — tensor collectives ride the host
            # engine — and resume from the checkpoint; the next
            # checkpoint boundary re-forms the plane (_maybe_reform).
            self._degraded = True
            return
        try:
            self._init_distributed(params)
        except Exception as e:  # noqa: BLE001 — filtered just below
            if not _is_runtime_failure(e):
                raise
            self._log_stderr("device group formation failed "
                             f"({type(e).__name__}: {e}); starting degraded")
            self._drop_group()
            self._degraded = True

    def _probe_ring(self) -> None:
        """Under pallas_ring on a rank with a card: the ring's library
        and CUDA IPC on this card, tried before any table, outside the
        runtime-failure filter of formation: a failure is the job's
        setting, raised from ``init``, never a degraded start."""
        if self._device_impl == "pallas_ring" and torch.cuda.is_available():
            peer_ring.probe()

    @staticmethod
    def _refuse_unported(params: dict) -> None:
        """Telemetry and tracing knobs set to anything but off raise
        :class:`NotImplementedError` naming ROADMAP A8, as the other
        engines' do."""
        for key in ("rabit_obs", "rabit_obs_dir", "rabit_trace_dir",
                    "rabit_trace_sample"):
            raw = params.get(key)
            if raw is None:
                raw = os.environ.get(key.upper())
            if raw is not None and str(raw).strip().lower() not in (
                    "", "0", "0.0", "false", "no", "none", "off"):
                raise NotImplementedError(
                    f"{key}={raw!r} is not ported to rabit_tpu_torch yet "
                    f"(ROADMAP A8)")

    def _make_inner(self, params: dict) -> Engine:
        name = params.get("rabit_inner_engine") or "pyrobust"
        if name in ("native", "base", "robust", "mock"):
            raise NotImplementedError(
                f"inner engine {name!r} (the native library) is not ported "
                f"to rabit_tpu_torch yet (ROADMAP A8)")
        if name in ("xla", "mpi"):
            raise ValueError(
                f"engine {name!r} cannot back the device data plane")
        from rabit_tpu_torch.engine import _make_engine

        return _make_engine(name)

    def _init_distributed(self, params: dict) -> None:
        """First formation of the device plane."""
        # Every rank resolves the SAME tracker-hosted store by key, so
        # version span 0 holds no engine-internal collective and a
        # worker relaunched before the first checkpoint replays a span
        # aligned with the survivors'.
        coord = self._request_tracker_service("init")
        self._svc_tracker_hosted = bool(coord)
        if not coord:
            # A tracker that cannot host: rank 0 hosts, its address goes
            # over the host plane (one broadcast in span 0; rank 0's
            # death is then unrecoverable for the plane until a reform).
            coord = self._broadcast_fresh_coordinator()
        if os.environ.get("RABIT_XLA_DIE_FORMATION", "") == str(self._rank):
            # Fault-injection hook: die INSIDE the formation window —
            # tracker round and store resolution complete, formation
            # barrier not yet posted, group not formed.  The survivors
            # must learn of it on the control plane (the barrier
            # aborts), start degraded and re-form at the next
            # checkpoint boundary.  Only a first life gets here.
            self._log_stderr(f"rank {self._rank} dying in the formation "
                             "window (RABIT_XLA_DIE_FORMATION)")
            self._die_in_formation()
        if not self._formation_barrier():
            # Someone died (or the barrier timed out) before formation
            # could complete: forming now would wait out the timeout on
            # a rank that never comes — start degraded; the first
            # checkpoint re-forms the plane.
            self._log_stderr("formation barrier aborted — starting "
                             "degraded")
            self._degraded = True
            return
        # A SHORT first-formation timeout: a member that dies between
        # the barrier and the group's connect leaves the others waiting
        # on the store, and they should start degraded soon.  Raise it
        # where honest formation needs longer.
        raw = (params.get("rabit_form_timeout_sec")
               or os.environ.get("RABIT_FORM_TIMEOUT_SEC"))
        if raw is not None:
            # explicitly configured: honored as-is
            try:
                form_timeout = float(raw)
            except ValueError:
                form_timeout = 10.0
        else:
            form_timeout = min(10.0, self._init_timeout)
        self._connect_distributed(coord, form_timeout)

    @staticmethod
    def _die_in_formation() -> None:
        os._exit(254)  # the keepalive launcher's restart code

    def _formation_barrier(self) -> bool:
        """Post the tracker's formation barrier (protocol.CMD_FORMBAR),
        the LAST act before forming the group.  True = every worker is
        alive and about to form too; False = formation is doomed (a
        member died, or the barrier timed out).  Fails safe: any
        tracker-path error counts as an abort."""
        try:
            sock = socket.create_connection(
                self._tracker_addr, timeout=self._init_timeout + 60)
            try:
                sock.settimeout(self._init_timeout + 60)
                P.send_hello(
                    sock, P.CMD_FORMBAR,
                    os.environ.get("RABIT_TASK_ID", str(self._rank)),
                    self._world, job=self._job_id)
                return P.recv_u32(sock) == 1
            finally:
                sock.close()
        except Exception as e:  # noqa: BLE001 — fail safe to degraded
            self._log_stderr(
                f"formation barrier failed ({type(e).__name__}: {e})")
            return False

    def _request_tracker_service(self, key: str = "") -> str:
        """Ask the tracker for a store (cmd=jaxsvc); returns
        "host:port", or "" if it cannot host one.  ``key == ""`` makes
        a fresh store (one per reform); ``"init"`` is create-or-get on
        the tracker, so every rank resolves the same store with no
        worker-to-worker op."""
        try:
            sock = socket.create_connection(self._tracker_addr, timeout=30)
            try:
                P.send_hello(sock, P.CMD_JAXSVC, key, self._world,
                             job=self._job_id)
                port = P.recv_u32(sock)
            finally:
                sock.close()
            return f"{self._tracker_addr[0]}:{port}" if port else ""
        except Exception as e:  # noqa: BLE001
            self._log_stderr(
                f"tracker jaxsvc request failed ({type(e).__name__}: {e})")
            return ""

    def _broadcast_fresh_coordinator(self) -> str:
        """Rank 0 obtains a store — preferring a TRACKER-HOSTED one, so
        its lifetime is every worker's, rank 0 included — and everyone
        learns it over the host control plane.  The payload carries a
        T|/L| marker so all members agree on where the store lives."""
        if self._rank == 0:
            coord = self._request_tracker_service()
            if not coord:
                self._log_stderr(
                    "the tracker cannot host a store — FALLING BACK to a "
                    "rank-0-hosted one; rank-0 death will NOT leave the "
                    "plane recoverable until a tracker can host")
                self._hosted_store = dist.TCPStore(
                    "0.0.0.0", 0, self._world, is_master=True,
                    timeout=datetime.timedelta(seconds=self._init_timeout),
                    wait_for_workers=False)
            payload = (f"T|{coord}" if coord else
                       f"L|{routable_ip(self._tracker_addr)}:"
                       f"{self._hosted_store.port}").encode()
        else:
            payload = None
        marker, _, coord = self._inner.broadcast(
            payload, root=0).decode().partition("|")
        self._svc_tracker_hosted = marker == "T"
        if marker != "L" and self._hosted_store is not None:
            self._hosted_store = None       # replay of an older round
        return coord

    def _connect_distributed(self, coord: str, timeout: float,
                             epoch: Optional[int] = None) -> None:
        """Form the group on the store at ``coord``: exchange every
        rank's device through it, pick the backend, build the group
        object with ``timeout`` for its connect, then the op timeout
        (2 x rabit_timeout_sec, at least 30 s).  Under pallas_ring, also
        decide whether the plane holds the ring and, if it does, build
        the ring's table for device epoch ``epoch``."""
        host, port = coord.rsplit(":", 1)
        delta = datetime.timedelta(seconds=timeout)
        if self._hosted_store is not None:
            store = self._hosted_store
        else:
            store = dist.TCPStore(host, int(port), self._world,
                                  is_master=False, timeout=delta,
                                  wait_for_workers=False)
        # every store serves one formation (a reform takes a fresh one),
        # so the key space needs no epoch: a relaunched life counts its
        # epochs from 0 while the survivors' count runs on
        prefixed = dist.PrefixStore("rabit/", store)
        prefixed.set(f"device/{self._rank}", device_identity())
        devices = [prefixed.get(f"device/{r}").decode()
                   for r in range(self._world)]
        backend = backend_for(devices)
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if devices[self._rank] != "cpu"
                        else torch.device("cpu"))
        group = new_group(prefixed, self._rank, self._world, backend, delta,
                          routable_ip(self._tracker_addr))
        set_timeout = getattr(group, "_set_default_timeout", None)
        if set_timeout is not None:
            set_timeout(datetime.timedelta(seconds=self._init_timeout))
        self._group, self._store, self._backend = group, store, backend
        self._member = True
        self.path_stats["backend"] = backend
        shared = (devices[self._rank] != "cpu"
                  and devices.count(devices[self._rank]) > 1)
        epoch = self._device_epoch if epoch is None else epoch
        self._log_stderr(
            f"rank {self._rank} formed the device plane (epoch "
            f"{epoch}): backend {backend} on "
            f"{self._device.type} tensors"
            + (" (ranks share a card: gloo stages through host memory)"
               if shared else ""))
        if self._device_impl == "pallas_ring":
            self._hold_ring(epoch)

    def _hold_ring(self, epoch: int) -> None:
        """Whether the plane holds the ring, the same answer on every
        rank (:func:`ring_holds` over one allgather on the group of every
        rank's card and the cards it reaches), and if it does, the ring's
        table on this rank's card for device epoch ``epoch``.  The card
        is asked for only once the rule has passed, so that a rank
        without one joins the allgather and keeps every rank on the
        group."""
        me = device_identity()
        records = self._exchange_bytes(reach_record(
            me, [] if me == "cpu" else reachable_cards()))
        if ring_holds(records):
            self._form_ring(epoch, self._local_card())
        else:
            self._log_stderr(
                "pallas_ring: the plane cannot hold the ring (a rank on the "
                "CPU, or a card some rank cannot reach); allreduces stay on "
                "the group")

    def _form_ring(self, epoch: int, device: torch.device) -> None:
        """Build the ring's table over the group, on ``device``: one
        allgather of every rank's inbox handles and the barrier's page."""
        t = time.perf_counter()
        self._ring = peer_ring.PeerRing(
            self._rank, self._world, self._exchange_bytes, device,
            timeout=self._init_timeout, tag=f"{self._job_id}.e{epoch}",
            capacity=self._pallas_min_bytes)
        self.ring_form_ms = (time.perf_counter() - t) * 1e3
        # every rank of the new epoch has joined its allgather, so each
        # has dropped the tables of earlier epochs, and no peer folds
        # their inboxes any more
        peer_ring.free_inboxes(self._ring_orphans)
        self._log_stderr(
            f"pallas_ring: rank {self._rank} built the ring's table "
            f"(epoch {epoch}, {self._ring.capacity} B inboxes) in "
            f"{self.ring_form_ms:.3f} ms")

    def _exchange_bytes(self, record: bytes) -> list:
        """Every rank's ``record`` (one length on every rank), in rank
        order: one allgather over the group."""
        t = torch.frombuffer(bytearray(record), dtype=torch.uint8)
        if self._backend == "nccl":
            t = t.to(self._device)
        parts = [torch.empty_like(t) for _ in range(self._world)]
        self._group.allgather([parts], [t]).wait()
        return [p.cpu().numpy().tobytes() for p in parts]

    def _adopt_ring(self) -> None:
        """pallas_ring over the adopted group: :meth:`_hold_ring`, the
        table on this rank's card whatever the group's backend (device
        epoch 0: the group is never re-formed).  A peer's
        failure on the way raises in adopt mode and degrades the job in
        mixed mode."""
        if self._device_impl != "pallas_ring":
            return
        try:
            self._hold_ring(0)
        except Exception as e:  # noqa: BLE001 — filtered just below
            if not _is_runtime_failure(e):
                raise
            self._drop_group()
            if self._no_host_transport:
                raise RuntimeError(_NO_HOST) from e
            self._degraded = True
            self._log_stderr(f"pallas_ring: the table's formation failed "
                             f"({type(e).__name__}: {e}); running degraded "
                             "on the host transport for the whole job")

    @staticmethod
    def _local_card() -> torch.device:
        return torch.device("cuda", torch.cuda.current_device())

    def _default_group(self):
        """``torch.distributed``'s default group and its backend."""
        return dist.group.WORLD, str(dist.get_backend())

    def _adopt_default_group(self) -> None:
        """Take ``torch.distributed``'s default group as the device plane
        (adopt and mixed modes): NCCL reduces CUDA tensors on the
        current card, any other backend takes CPU tensors."""
        self._group, backend = self._default_group()
        self._backend = backend
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if backend == "nccl" else torch.device("cpu"))
        self._member = True
        self.path_stats["backend"] = backend
        self._log_stderr(f"rank {self._rank} adopted the default "
                         f"torch.distributed group: backend {backend}")

    def _build_group_mixed(self) -> None:
        """MIXED mode's start: agree, on every rank at once, whether the
        control-plane ranks and the external group's line up.

        A world mismatch every rank can see needs no agreement and must
        not enter a collective (with a larger external world the extra
        processes are still in tracker registration): every rank
        degrades.  Otherwise each rank's "misaligned" flag is
        all-gathered over the external group (rank-order independent, so
        it works misaligned), never over the host plane, whose version
        span 0 must hold no engine op; a relaunch never gets here.  Any
        flag set degrades every rank for the whole job, rather than
        leave the aligned ranks on a plane the others cannot join.  No
        timeout of its own: a rank that gave up while its flag still
        reached the others would split the world."""
        if dist.get_world_size() != self._world:
            self._degraded = True
            self._log_stderr(
                f"MIXED mode: the torch.distributed world "
                f"({dist.get_world_size()}) differs from the tracker's "
                f"({self._world}); running degraded on the host transport "
                "for the whole job")
            return
        misaligned = dist.get_rank() != self._rank
        self._adopt_default_group()
        flag = torch.tensor([int(misaligned)], dtype=torch.int32,
                            device=self._device)
        parts = [torch.empty_like(flag) for _ in range(self._world)]
        self._log_stderr("MIXED mode: entering the start consensus (an "
                         "allgather on the external group)")
        self._group.allgather([parts], [flag]).wait()
        if not int(torch.cat(parts).max()):
            return
        self._drop_group()
        self._degraded = True
        self._log_stderr(
            "MIXED mode: control-plane ranks and dist.get_rank() do not "
            "line up on every rank"
            + (f" (this rank: {self._rank} vs {dist.get_rank()})"
               if misaligned else " (a peer's are misaligned)")
            + "; running degraded on the host transport for the whole "
            "job.  Launch with RABIT_TRACKER_PIN_RANKS=1 on the tracker")

    def _drop_group(self, quiet: bool = False) -> None:
        """Tear down the current group: abort (or shut down) where the
        backend can, so peers blocked on this rank fail at once, then
        drop the object and the store client.  An adopted group is the
        caller's: it is only forgotten.  The ring's table is closed;
        ``quiet`` (an ordered teardown past its first barrier) frees its
        inboxes at once, else they wait for the next table's formation or
        ordered teardown, since a late peer may still fold them."""
        ring, self._ring = self._ring, None
        if ring is not None:
            try:
                self._ring_orphans += ring.close(quiet=quiet)
            except Exception as e:  # noqa: BLE001 — logged; the group goes
                self._log_stderr(f"closing the ring's table failed "
                                 f"({type(e).__name__}: {e})")
        group, self._group = self._group, None
        if group is not None and not self._adopted:
            for name in ("abort", "shutdown"):
                fn = getattr(group, name, None)
                if fn is None:
                    continue
                try:
                    fn()
                    break
                except RuntimeError as e:
                    self._log_stderr(f"group {name} failed ({e}); "
                                     "dropping it")
        self._store = None
        self._hosted_store = None
        self._member = False

    def _shutdown_distributed_ordered(self) -> None:
        """Tear the group down with the race closed: followers drop
        theirs while rank 0, which may host the store, is provably
        alive (host barrier between the waves).  The ring's peers'
        handles close before the first barrier, so past it every rank's
        inboxes are free to go."""
        self._release_ring(self._control_barrier)
        if self._rank != 0:
            self._drop_group(quiet=True)
        self._control_barrier()
        if self._rank == 0:
            self._drop_group(quiet=True)

    def _release_ring(self, barrier) -> bool:
        """The ring's part of an ordered teardown, on every rank (one
        without a table too, so that ``barrier`` has every rank): this
        rank's folds waited for and its peers' handles closed, then
        ``barrier()``, past which no peer folds this rank's inboxes, then
        the inboxes of earlier tables freed.  Returns whether the barrier
        passed; past a failed one the inboxes stay allocated."""
        try:
            if self._ring is not None:
                self._ring.release_peers()
        except Exception as e:  # noqa: BLE001 — the teardown goes on
            self._log_stderr(f"closing the ring's peer handles failed "
                             f"({type(e).__name__}: {e})")
        passed = barrier()
        if passed:
            try:
                peer_ring.free_inboxes(self._ring_orphans)
            except Exception as e:  # noqa: BLE001 — the teardown goes on
                self._log_stderr(f"freeing a failed table's inboxes "
                                 f"failed ({type(e).__name__}: {e})")
        return passed

    def _control_barrier(self) -> bool:
        """Barrier over the host control plane (all ranks must call).
        A failure is logged, never swallowed silently; returns whether
        it passed."""
        try:
            self._inner.allreduce(np.zeros(1, np.uint8), ReduceOp.SUM)
            return True
        except Exception as e:  # noqa: BLE001
            self._log_stderr(
                f"control barrier failed ({type(e).__name__}: {e}); "
                "teardown ordering is no longer guaranteed")
            return False

    def _group_barrier(self) -> bool:
        """Barrier over the adopted group (adopt mode's only plane): a
        one-element allreduce.  A failure is logged; returns whether it
        passed."""
        try:
            check(self._group is not None, "no group")
            self._group.allreduce(
                [torch.zeros(1, device=self._device)]).wait()
            return True
        except Exception as e:  # noqa: BLE001
            self._log_stderr(
                f"group barrier failed ({type(e).__name__}: {e}); the "
                "ring's inboxes stay allocated until the process exits")
            return False

    def _close_ring_adopted(self) -> None:
        """The ring's ordered teardown over an adopted group
        (:meth:`_release_ring` with the group's barrier in adopt mode,
        the host plane's in mixed mode), then the table closed and its
        files unlinked; its inboxes are freed at once only past a
        barrier that passed."""
        passed = self._release_ring(
            self._group_barrier if self._no_host_transport
            else self._control_barrier)
        self._drop_group(quiet=passed)

    @staticmethod
    def _log_stderr(msg: str) -> None:
        print(f"[rabit_tpu_torch] xla engine: {msg}", file=sys.stderr,
              flush=True)

    def shutdown(self) -> None:
        if self._world > 1 and self._inner is not None and not self._adopted:
            # Every rank joins both barriers — a relaunched incarnation
            # that never formed a group included — as the robust
            # engine's own shutdown consensus does; they wait for a
            # dead peer's relaunch.
            self._shutdown_distributed_ordered()
        elif (self._world > 1 and self._inner is not None
              and self._device_impl == "pallas_ring"):
            self._close_ring_adopted()
        if self._inner is not None:
            self._inner.shutdown()
        self._drop_group()

    # ------------------------------------------------------------------
    # device-plane re-formation
    # ------------------------------------------------------------------
    @property
    def device_epoch(self) -> int:
        """Bumped every time the device plane is re-formed.  A tensor
        outlives a group, so apps re-stage their shards when it moves
        for parity with the reference (where old-epoch arrays die)."""
        return self._device_epoch

    def _maybe_reform(self) -> None:
        """Re-form the device plane if any rank is degraded.

        Runs at the checkpoint boundary (every rank calls checkpoint()
        once per iteration, so this is a consensus point; a relaunched
        incarnation is always degraded, which drags every survivor
        into the reform).  All ranks symmetric:

        1. host-plane MAX-allreduce of per-rank state flags (bit0
           degraded, bit1 member of the current group, bit2 that
           member's store is tracker-hosted);
        2. nobody degraded -> done (one small host op per checkpoint);
        3. tear the old group down — ordered when its store is alive
           (tracker-hosted, or its rank-0 host survived), dropped
           otherwise;
        4. rank 0 obtains a fresh store (tracker-hosted when it can) and
           broadcasts it over the host plane; everyone forms a new
           group and bumps ``device_epoch``.

        A failed re-formation (another death mid-reform) leaves every
        reachable rank degraded; the next checkpoint retries."""
        if (self._world <= 1 or self._adopted or self._inner is None
                or not self._reform_enabled):
            return
        flags = np.zeros(self._world, np.uint8)
        flags[self._rank] = (1 if self._degraded else 0) | (
            2 if self._member else 0) | (
            4 if self._member and self._svc_tracker_hosted else 0)
        self._inner.allreduce(flags, ReduceOp.MAX)
        if not (flags & 1).any():
            return
        # every rank derives these from the SHARED flags, so the branch
        # structure (and its control-plane op sequence) is identical on
        # members and relaunched incarnations alike
        members_exist = bool((flags & 2).any())
        service_alive = bool((flags & 4).any()) or bool(flags[0] & 2)
        self._log_stderr(
            f"re-forming device plane (degraded ranks: "
            f"{[int(r) for r in np.flatnonzero(flags & 1)]}, old store "
            f"{'alive' if members_exist and service_alive else 'dead'})")
        if members_exist and service_alive:
            # ranks that were never members of the old group still join
            # both barriers: every rank's op sequence stays identical
            self._shutdown_distributed_ordered()
        else:
            self._drop_group()
        # Rank 0 must request a store even when the flags op was
        # replayed: if the old rank 0 died MID-round the survivors are
        # still pending in this broadcast and receive our payload fresh.
        coord = self._broadcast_fresh_coordinator()
        if self._inner.last_op_replayed:
            # The payload came from the REPLAY cache: this re-formation
            # completed before this incarnation joined (its group may
            # hold our previous life), so the address is stale.  Stay
            # degraded; the next checkpoint runs a fresh exchange.
            self._log_stderr(
                "re-formation round was replayed (stale group); staying "
                "degraded until the next fresh checkpoint boundary")
            self._drop_group()
            self._degraded = True
            self._device_epoch += 1
            return
        try:
            self._connect_distributed(coord, self._init_timeout,
                                      epoch=self._device_epoch + 1)
        except Exception as e:  # noqa: BLE001 — filtered just below
            if not _is_runtime_failure(e):
                raise
            self._log_stderr(
                f"device-plane re-formation failed ({type(e).__name__}: "
                f"{e}); staying degraded until the next checkpoint")
            self._drop_group()
            self._degraded = True
            self._device_epoch += 1
            return
        self._degraded = False
        self._device_epoch += 1
        self._log_stderr(
            f"device plane re-formed (epoch {self._device_epoch})")

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    @property
    def group(self):
        """The device plane's process group (None at world 1 and while
        degraded)."""
        return self._group

    @property
    def backend(self) -> Optional[str]:
        """``"gloo"`` or ``"nccl"`` once a group formed, else None."""
        return self._backend

    def tracker_print(self, msg: str) -> None:
        self._inner.tracker_print(msg)

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------
    def allreduce(self, buf, op: ReduceOp,
                  prepare_fun: Optional[Callable[[], None]] = None):
        """numpy: in place through the inner host engine (in adopt mode
        on the group, copied back).  A tensor: a NEW tensor on the input's device holding the reduction; the
        input is left as it was, so a device op that fails part way
        still has this rank's own contribution to send on the host
        plane."""
        if isinstance(buf, np.ndarray):
            if self._no_host_transport and self._world > 1:
                # adopt mode: reduce on the group (or the ring, where
                # the gate lets the payload through), copy back in place
                if prepare_fun is not None:
                    prepare_fun()
                out = self._tensor_op("allreduce", self._on_group(buf, op),
                                      op)
                buf[...] = out.cpu().numpy()
                return buf
            return self._inner.allreduce(buf, op, prepare_fun)
        check(isinstance(buf, torch.Tensor),
              "xla engine: allreduce expects a numpy array or a tensor")
        if prepare_fun is not None:
            prepare_fun()
        if self._world == 1:
            return buf
        return self._tensor_op("allreduce", buf, op)

    def allgather(self, buf):
        if isinstance(buf, np.ndarray):
            if self._no_host_transport and self._world > 1:
                return self._tensor_op("allgather", self._on_group(buf),
                                       ReduceOp.SUM).cpu().numpy()
            return self._inner.allgather(buf)
        check(isinstance(buf, torch.Tensor),
              "xla engine: allgather expects a numpy array or a tensor")
        if self._world == 1:
            return buf.unsqueeze(0).clone()
        return self._tensor_op("allgather", buf, ReduceOp.SUM)

    def _on_group(self, buf: np.ndarray,
                  op: Optional[ReduceOp] = None) -> torch.Tensor:
        """A numpy buffer as a tensor on the adopted group's device, or,
        for an allreduce (``op`` given) that the ring's gate lets
        through, on the ring's card."""
        t = torch.from_numpy(np.ascontiguousarray(buf))
        if op is not None and self._use_pallas_ring(buf.shape, t.dtype, op):
            return t.to(self._ring.device)
        return t.to(self._device)

    def _tensor_op(self, kind: str, buf: torch.Tensor,
                   op: ReduceOp) -> torch.Tensor:
        """A tensor collective at world > 1: on the device plane, or on
        the host engine once degraded or after a runtime failure."""
        check_reduction(self._backend or "gloo", op, buf.dtype)
        if self._degraded:
            return self._host_degrade(kind, buf, op)
        try:
            return self._device_collective(kind, buf, op)
        except Exception as e:  # noqa: BLE001 — filtered just below
            if not _is_runtime_failure(e):
                raise  # programming error, not a peer failure
            return self._host_degrade(kind, buf, op, cause=e)

    def allreduce_async(self, buf, op: ReduceOp,
                        prepare_fun: Optional[Callable[[], None]] = None,
                        fuse: bool = True,
                        codec: bool = True) -> CollectiveHandle:
        """Async passthrough: numpy payloads ride the inner host
        engine's progress thread (overlap and bucket fusion, with its
        replay semantics intact); tensors, and every payload in adopt
        mode, resolve synchronously on the device plane."""
        if (isinstance(buf, np.ndarray) and self._world > 1
                and not self._no_host_transport and not self._degraded):
            return self._inner.allreduce_async(buf, op, prepare_fun,
                                               fuse=fuse, codec=codec)
        return CollectiveHandle.resolved(
            self.allreduce(buf, op, prepare_fun))

    def allgather_async(self, buf) -> CollectiveHandle:
        if (isinstance(buf, np.ndarray) and self._world > 1
                and not self._no_host_transport and not self._degraded):
            return self._inner.allgather_async(buf)
        return CollectiveHandle.resolved(self.allgather(buf))

    def _host_degrade(self, kind: str, buf: torch.Tensor, op: ReduceOp,
                      cause: Exception | None = None) -> torch.Tensor:
        """Degraded mode: the device collective failed (typically a peer
        died mid-op).  Tear the group down, route the payload through
        the inner fault-tolerant host engine — its recovery protocol
        re-forms the world — and return a tensor on the input's device.
        Tensor ops ride the host until the next checkpoint boundary
        re-forms the plane (or, with rabit_device_reform=0, to the
        end).  bfloat16 rides the host wire as float32, which numpy
        has.  Adopt mode has no host engine: a failure raises
        :class:`RuntimeError`."""
        if self._no_host_transport:
            raise RuntimeError(_NO_HOST) from cause
        if not self._degraded:
            self._degraded = True
            self._log_stderr(
                f"device collective failed ({type(cause).__name__}: "
                f"{cause}); degrading to host transport")
            self._drop_group()
        wire = torch.float32 if buf.dtype == torch.bfloat16 else buf.dtype
        host = buf.detach().to("cpu", wire).contiguous().numpy().copy()
        if kind == "allreduce":
            out = self._inner.allreduce(host, op)
        else:
            out = self._inner.allgather(host)
        self.path_stats["host_ops"] += 1
        return torch.from_numpy(np.ascontiguousarray(out)).to(
            buf.device, buf.dtype)

    def _use_pallas_ring(self, shape, dtype_name, op: ReduceOp) -> bool:
        """pallas_ring serves large {SUM,MAX,MIN,PROD} allreduces of the
        kernel's dtypes (float32, bfloat16, int32); small payloads, other
        ops and other dtypes stay on the group's allreduce (psum).  As in
        the reference, the ring engages only where the plane can hold it
        (every rank on CUDA, decided at formation: the table exists), or
        at world 1.  ``dtype_name``: a dtype's name (``"float32"``) or a
        torch dtype."""
        if self._device_impl != "pallas_ring":
            return False
        if self._world > 1 and self._ring is None:
            return False
        if ReduceOp(op) not in supported_ops():
            return False
        dtype = (getattr(torch, dtype_name, None)
                 if isinstance(dtype_name, str) else dtype_name)
        if dtype not in peer_ring.RING_DTYPES:
            return False
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return nbytes >= self._pallas_min_bytes

    def _device_collective(self, kind: str, buf: torch.Tensor,
                           op: ReduceOp) -> torch.Tensor:
        if self._backend == "nccl" and buf.device != self._device:
            raise ValueError(f"device collective: the nccl plane runs on "
                             f"{self._device}, got a tensor on {buf.device}")
        if (kind == "allreduce" and self._use_pallas_ring(
                tuple(buf.shape), buf.dtype, op)
                and buf.device == self._ring.device):
            out = self._ring.allreduce(buf, op)
            self.path_stats["device_ops"] += 1
            return out
        src = buf.detach().clone(memory_format=torch.contiguous_format)
        if kind == "allreduce":
            opts = dist.AllreduceOptions()
            opts.reduceOp = _DIST_OPS[ReduceOp(op)]
            self._group.allreduce([src], opts).wait()
            out = src
        else:
            parts = [torch.empty_like(src) for _ in range(self._world)]
            self._group.allgather([parts], [src]).wait()
            out = torch.stack(parts)
        self.path_stats["device_ops"] += 1
        return out

    # ------------------------------------------------------------------
    # control plane delegation
    # ------------------------------------------------------------------
    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        if self._no_host_transport and self._world > 1:
            return self._device_byte_broadcast(data, root)
        return self._inner.broadcast(data, root)

    def _device_byte_broadcast(self, data: Optional[bytes],
                               root: int) -> bytes:
        """Adopt mode's byte broadcast on the group: the length, then
        the bytes, each one broadcast from ``root``."""
        check(0 <= root < self._world, "broadcast: invalid root %d", root)
        is_root = self._rank == root
        check(not is_root or data is not None,
              "broadcast: root rank must supply data")
        n = torch.tensor([len(data) if is_root else 0], dtype=torch.int64,
                         device=self._device)
        self._group_broadcast(n, root)
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
               if is_root and data else
               torch.zeros(int(n.item()), dtype=torch.uint8))
        buf = buf.to(self._device)
        if buf.numel():
            self._group_broadcast(buf, root)
        return buf.cpu().numpy().tobytes()

    def _group_broadcast(self, t: torch.Tensor, root: int) -> None:
        opts = dist.BroadcastOptions()
        opts.rootRank = root
        try:
            self._group.broadcast([t], opts).wait()
        except Exception as e:  # noqa: BLE001 — filtered just below
            if not _is_runtime_failure(e):
                raise
            raise RuntimeError(_NO_HOST) from e

    def load_checkpoint(self):
        out = self._inner.load_checkpoint()
        # Same consensus exchange as checkpoint(), for the same span: a
        # relaunched rank resumes at version v exactly where survivors
        # committed v, so both issue the flags op as the FIRST inner op
        # of span v and the robust replay streams stay aligned.
        self._maybe_reform()
        return out

    def checkpoint(self, global_model, local_model=None, lazy_global=None):
        self._inner.checkpoint(global_model, local_model, lazy_global)
        # The committed checkpoint is the all-ranks consensus boundary:
        # heal a degraded device plane here.  The flags exchange runs
        # AFTER the commit — the FIRST inner op of the new span —
        # because a relaunched rank re-enters through load_checkpoint at
        # exactly that boundary and issues the same op first.
        self._maybe_reform()

    @property
    def version_number(self) -> int:
        return self._inner.version_number
