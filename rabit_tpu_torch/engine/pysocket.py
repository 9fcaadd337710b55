"""Pure-Python TCP collective engine (the "base engine").

PyTorch-port counterpart of :class:`rabit_tpu.engine.pysocket.PySocketEngine`
(its own copy: the port imports nothing of the JAX package), carried as
far as its collective API: tracker rendezvous, persistent
worker-worker links, the core collectives, the async progress pump with
small-op bucket fusion, custom reductions and the hierarchical
schedule, with the reference's names and structure so that each member
has its counterpart there.  It
is byte-compatible on the wire: port ranks and reference ranks form one
world, and for the same inputs every rank gets the same bits either
engine would give.

Algorithmic departures from the original rabit (deliberate, and the
reference's own):

* Large allreduces use **ring reduce-scatter + all-gather** (bandwidth
  optimal, every link equally loaded) instead of a pipelined binary
  tree; small payloads use the tree (log2 n hops beats n hops on
  latency).  ``rabit_sched`` forces ``tree``, ``ring``, ``halving``
  (recursive halving/doubling) or ``hier`` (the two-level schedule over
  the tracker's host groups) instead.
* Any-root broadcast is a plain tree flood: the root sends on all its
  tree links, everyone else forwards from the one link toward the root
  to the rest.

Payloads are numpy arrays, as the reference engine moves numpy; a
``torch.Tensor`` raises before any byte moves (a device data plane is
ROADMAP A5).  Left out until their ROADMAP items, each refused with
:class:`NotImplementedError` where a knob would ask for it, since every
one of them decides wire behaviour that must be uniform across ranks:
heartbeats (A3b); the robust layer and elastic rescale (A4);
shared-memory links, the tuning cache and the ``auto``, ``swing`` and
``synth`` schedules, wire codecs, chaos injection, telemetry and
tracing (the reference's ``async.*`` instruments among them), the
shard directory and link pacing (A8).
"""
from __future__ import annotations

import collections
import os
import random
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from rabit_tpu_torch import sched as sched_mod
from rabit_tpu_torch import transport as tr
from rabit_tpu_torch.engine.interface import (AsyncOrderError,
                                              CollectiveHandle, Engine)
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.ops.reduce_ops import apply_op_numpy
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.transport import LinkError
from rabit_tpu_torch.utils.checks import RabitError, check, log
from rabit_tpu_torch.utils.net import routable_ip
from rabit_tpu_torch.utils.units import parse_byte_size

# Payloads at or below this ride the tree (latency-bound); above, the ring
# (bandwidth-bound).  This module global is the DEFAULT for the static
# crossover; rabit_ring_threshold_bytes overrides it per engine, and
# rabit_sched forces one schedule instead.
TREE_RING_CROSSOVER_BYTES = 64 << 10
# Chunk size for full-duplex streaming (the broadcast flood's chunks).
CHUNK_BYTES = 256 << 10
# Hop-pipeline chunk FLOOR (rabit_pipeline_chunk): a pipelined hop
# splits each reduce-buffer chunk ``depth`` ways but never below this —
# every chunk boundary is a synchronization point, so hops that cannot
# produce at least two floor-sized chunks run the serial loop instead.
PIPE_CHUNK_BYTES = 64 << 10
# Default in-flight chunk window (rabit_pipeline_depth): 2 = classic
# double buffering — chunk k+1's exchange is on the wire while chunk k
# is merged.  1 = the serial hop loop, byte- and bit-identical.
PIPE_DEPTH = 2
# Async small-op coalescing budget (rabit_bucket_bytes): same-op/same-dtype
# allreduces at or below this size fuse into one wire op.
DEFAULT_BUCKET_BYTES = 1 << 20

# Where each knob the port refuses lands in ROADMAP.md's queue A.
_SCHED_ITEMS = {"auto": "A8", "swing": "A8", "synth": "A8"}


def _off(raw) -> bool:
    """The off value of a switch-like knob: unset, empty, 0, false,
    no, none or off (the reference's reading of ``rabit_obs``)."""
    return raw is None or str(raw).strip().lower() in (
        "", "0", "false", "no", "none", "off")


class AdmissionError(LinkError):
    """The tracker refused this job's registration: a malformed
    handshake at once, or capacity rejects across the full
    ``rabit_admission_retries`` budget.  Carries the tracker's last
    ``code``/``reason``.  A LinkError like :class:`TrackerLostError`:
    overload degrades to a typed failure, never a hang."""

    def __init__(self, msg: str, code: int = 0, reason: str = "") -> None:
        super().__init__(msg)
        self.code = int(code)
        self.reason = reason


class ShardMovedError(LinkError):
    """Every tracker this job's registration reached kept redirecting
    it elsewhere (``REJECT_SHARD_MOVED``) across the full
    ``rabit_shard_retries`` budget.  A single redirect is not an error:
    the reason carries the owning shard's generation and endpoint and
    the worker re-targets.  Carries the last redirect's ``generation``,
    ``shard`` and ``endpoint``."""

    def __init__(self, msg: str, generation: int = -1,
                 shard: int = -1, endpoint: str = "") -> None:
        super().__init__(msg)
        self.generation = int(generation)
        self.shard = int(shard)
        self.endpoint = str(endpoint)


class TrackerLostError(LinkError):
    """The tracker stayed unreachable across the full registration
    retry budget — the job's coordinator is gone.  A tracker merely
    restarting on the same port reads as a stall, never an error."""


class AsyncPumpError(RuntimeError):
    """The async progress pump died; queued collectives can never run.

    Raised at ``CollectiveHandle.wait()`` for every op that was queued
    behind (or issued after) the pump's death — the stream is poisoned
    so callers fail loudly instead of hanging on handles nobody will
    ever resolve."""


class _ScratchArena:
    """Pooled reusable byte buffers for the chunked collective paths.

    The tree/ring pumps borrow per-chunk scratch from here instead of
    allocating a fresh ``bytearray`` per call.  Buffers are handed out
    as exact-size memoryviews over a possibly-larger pooled backing
    store; the pool is bounded, so worst case memory is a few
    ``rabit_reduce_buffer`` chunks.
    """

    # Only small-to-middling buffers are worth retaining: keeping
    # multi-hundred-MB tree leases alive for the engine's lifetime would
    # trade transient scratch for permanent retention.
    MAX_POOLED_BYTES = 4 << 20

    def __init__(self, max_buffers: int = 8) -> None:
        self._free: list[bytearray] = []
        self._max = max_buffers
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> memoryview:
        with self._lock:
            for i, b in enumerate(self._free):
                if len(b) >= nbytes:
                    return memoryview(self._free.pop(i))[:nbytes]
        return memoryview(bytearray(max(nbytes, 1)))[:nbytes]

    def give(self, mv: memoryview) -> None:
        backing = mv.obj
        if not isinstance(backing, bytearray):
            return
        if len(backing) > self.MAX_POOLED_BYTES:
            return  # oversized lease: let the allocator reclaim it
        with self._lock:
            if len(self._free) < self._max:
                self._free.append(backing)


class PySocketEngine(Engine):
    def __init__(self) -> None:
        self._rank = 0
        self._world = 1
        self._links: dict[int, tr.Link] = {}
        self._tree_links: list[int] = []
        self._parent = P.NONE
        self._ring_prev = P.NONE
        self._ring_next = P.NONE
        self._tracker_addr: Optional[tuple[str, int]] = None
        self._task_id = "0"
        # Multi-tenant job id (rabit_job_id / RABIT_JOB_ID): names the
        # tenant on every tracker connection.  The default job speaks
        # the classic wire byte-for-byte.
        self._job_id = P.DEFAULT_JOB
        self._world_hint = 0
        self._listener: Optional[socket.socket] = None
        self._version = 0
        self._epoch = 0    # membership epoch of the current topology
        self._global: Optional[bytes] = None
        self._local: Optional[bytes] = None
        self._timeout: Optional[float] = 600.0  # overridden in init()
        self._relaunched = False
        # Connect retry policy (rabit_connect_retries /
        # rabit_backoff_base_ms): capped exponential backoff with full
        # jitter on every dial.
        self._connect_retries = 4
        self._backoff_base_ms = 100.0
        self._admission_retries = 10
        self._shard_retries = 4
        self._reduce_buffer = 256 << 20
        self.scratch_peak_bytes = 0
        self._sock_buf = 0          # rabit_sock_buf (0 = kernel default)
        # Link construction + feature negotiation: the transport config
        # resolves in init(); the factory is built once registration
        # has returned this rank (the port's factory takes it then).
        self._tcfg = tr.TransportConfig()
        self._lf: Optional[tr.LinkFactory] = None
        self._arena = _ScratchArena()
        # Hop pipelining (rabit_pipeline_depth / rabit_pipeline_chunk):
        # the schedules' chunked exchange+merge loops keep up to
        # _pipe_depth chunk exchanges in flight so merge compute hides
        # behind wire IO.  The wire byte stream is depth-independent,
        # so mixed-depth worlds interoperate.
        self._pipe_depth = PIPE_DEPTH
        self._pipe_chunk = PIPE_CHUNK_BYTES
        # Collective schedule selection (rabit_sched): "static" keeps
        # the tree/ring crossover, a schedule name forces it wherever it
        # applies.
        self._sched_name = "static"
        self._ring_threshold: Optional[int] = None  # None -> module global
        self._op_sched: Optional[str] = None  # schedule of the last dispatch
        # The topology handout's host groups feed the hierarchical
        # schedule; the straggler-demotion set of the reference's
        # adaptive controller stays empty (ROADMAP A8).
        self._groups: list[int] = []
        self._demoted: frozenset = frozenset()
        self._bucket_bytes = DEFAULT_BUCKET_BYTES
        # Async collective stream: a single background progress thread
        # (created lazily on the first *_async call) executes queued ops
        # strictly in issue order, so the wire sees the exact op
        # sequence a blocking caller would produce.
        self._aq: collections.deque = collections.deque()
        self._aq_cv = threading.Condition()
        self._aq_thread: Optional[threading.Thread] = None
        self._aq_inflight = 0   # queued-but-unfinished op groups
        self._pump_error: Optional[Exception] = None  # pump died: poisoned
        self._issue_idx = 0     # async handles issued (user ops)
        self._wait_idx = 0      # next handle index allowed to wait()
        self._pending: Optional[dict] = None  # open coalescing bucket

    # ------------------------------------------------------------------
    # lifecycle / rendezvous
    # ------------------------------------------------------------------
    def init(self, params: dict) -> None:
        uri = params.get("rabit_tracker_uri") or os.environ.get("RABIT_TRACKER_URI")
        port = params.get("rabit_tracker_port") or os.environ.get("RABIT_TRACKER_PORT")
        check(uri is not None and port is not None,
              "pysocket engine needs rabit_tracker_uri/rabit_tracker_port")
        self._tracker_addr = (str(uri), int(port))
        self._task_id = str(params.get("rabit_task_id")
                            or os.environ.get("RABIT_TASK_ID", "0"))
        # Tenant identity: path-safe by contract — it names directories
        # on the tracker.
        self._job_id = str(params.get("rabit_job_id")
                           or os.environ.get("RABIT_JOB_ID")
                           or P.DEFAULT_JOB)
        check(P.valid_job_id(self._job_id),
              "rabit_job_id must be a path-safe token "
              "([A-Za-z0-9][A-Za-z0-9._-]{0,63}), got %r", self._job_id)
        self._world_hint = int(params.get("rabit_world_size")
                               or os.environ.get("RABIT_WORLD_SIZE", 0))
        # Peer-link IO timeout: a hung-but-alive peer surfaces as
        # LinkError after this long instead of wedging the job.
        # Tracker waits keep their own generous bound.
        self._timeout = float(params.get("rabit_timeout_sec")
                              or os.environ.get("RABIT_TIMEOUT_SEC", 600))
        if self._timeout <= 0:
            self._timeout = None  # <=0 disables the timeout (like native)
        # Collective scratch budget: payloads larger than this stream
        # through the tree/ring in budget-sized chunks, so per-op scratch
        # is bounded by configuration, not payload size.
        self._reduce_buffer = parse_byte_size(
            params.get("rabit_reduce_buffer")
            or os.environ.get("RABIT_REDUCE_BUFFER", "256MB"))
        self.scratch_peak_bytes = 0

        def _size_or_zero(raw, default):
            if raw is None or str(raw).strip() == "":
                return default
            if str(raw).strip() == "0":
                return 0  # explicit disable (parse_byte_size rejects 0)
            return parse_byte_size(raw)

        def _param_or_env(key: str):
            # `params.get(k) or env` would drop an explicit integer 0 —
            # the documented "disable" value — so test None, not truth.
            raw = params.get(key)
            return raw if raw is not None else os.environ.get(key.upper())

        self._refuse_unported(params, _param_or_env)
        # Small-op coalescing budget for the async path (0 disables
        # fusion; async ops still overlap).  Buckets are collective ops,
        # so this MUST be uniform across ranks — which is why it is
        # never derived from rank-local knobs like rabit_reduce_buffer.
        self._bucket_bytes = _size_or_zero(
            _param_or_env("rabit_bucket_bytes"), DEFAULT_BUCKET_BYTES)
        # Socket buffer sizes (SO_SNDBUF/SO_RCVBUF) for worker-worker
        # links; 0 keeps the kernel default.
        self._sock_buf = _size_or_zero(_param_or_env("rabit_sock_buf"), 0)
        # Schedule selection: BOTH knobs decide collective behaviour and
        # must be uniform across ranks — every rank dispatches the same
        # (op, size, world) point to the same algorithm or the peer
        # patterns deadlock.
        raw = _param_or_env("rabit_sched")
        self._sched_name = (str(raw).strip().lower()
                            if raw not in (None, "") else "static")
        check(self._sched_name in sched_mod.MODES,
              "rabit_sched must be one of %s, got %r",
              "/".join(sched_mod.MODES), self._sched_name)
        raw = _param_or_env("rabit_ring_threshold_bytes")
        self._ring_threshold = (None if raw in (None, "")
                                else _size_or_zero(raw, None))
        # Hop pipelining: depth 1 is the serial hop loop; the wire byte
        # stream is depth-independent, so this is a per-rank perf knob,
        # not a collective decision.
        raw = _param_or_env("rabit_pipeline_depth")
        self._pipe_depth = int(raw) if raw not in (None, "") else PIPE_DEPTH
        check(1 <= self._pipe_depth <= 64,
              "rabit_pipeline_depth must be in [1, 64], got %r",
              self._pipe_depth)
        self._pipe_chunk = _size_or_zero(
            _param_or_env("rabit_pipeline_chunk"), PIPE_CHUNK_BYTES)
        check(self._pipe_chunk > 0,
              "rabit_pipeline_chunk must be > 0")
        # Connect retry policy: a refused/timed-out dial (a peer merely
        # slow to listen, a tracker restarting) is retried with capped
        # exponential backoff + full jitter instead of killing the
        # worker on the first SYN.
        raw = _param_or_env("rabit_connect_retries")
        self._connect_retries = int(raw) if raw not in (None, "") else 4
        check(self._connect_retries >= 0,
              "rabit_connect_retries must be >= 0")
        raw = _param_or_env("rabit_backoff_base_ms")
        self._backoff_base_ms = float(raw) if raw not in (None, "") else 100.0
        check(self._backoff_base_ms > 0, "rabit_backoff_base_ms must be > 0")
        # Admission retry budget: a typed admission reject (tracker at
        # capacity) is re-registered with backoff this many extra times
        # before a typed AdmissionError.
        raw = _param_or_env("rabit_admission_retries")
        self._admission_retries = int(raw) if raw not in (None, "") else 10
        check(self._admission_retries >= 0,
              "rabit_admission_retries must be >= 0")
        raw = _param_or_env("rabit_shard_retries")
        self._shard_retries = int(raw) if raw not in (None, "") else 4
        check(self._shard_retries >= 0,
              "rabit_shard_retries must be >= 0")
        # Transports + integrity framing: all defaults keep the wire
        # byte-identical; every feature is negotiated per link at
        # rendezvous.  shm/auto raise in TransportConfig (ROADMAP A8).
        raw = _param_or_env("rabit_transport")
        transport = (str(raw).strip().lower()
                     if raw not in (None, "") else "tcp")
        raw = _param_or_env("rabit_wire_integrity")
        integrity = (str(raw).strip().lower()
                     if raw not in (None, "") else "off")
        self._tcfg = tr.TransportConfig(transport=transport,
                                        integrity=integrity)
        self._rendezvous(P.CMD_START)

    @staticmethod
    def _refuse_unported(params: dict, param_or_env) -> None:
        """Raise :class:`NotImplementedError`, naming its ROADMAP item,
        for every knob of the reference engine set to anything but its
        off value whose machinery the port does not have yet.  None is
        ignored: each decides wire behaviour that must be uniform
        across ranks (or, for telemetry, what the user asked to see)."""
        def refuse(key, raw, item):
            raise NotImplementedError(
                f"{key}={raw!r} is not ported to rabit_tpu_torch yet "
                f"(ROADMAP {item})")

        raw = param_or_env("rabit_sched")
        name = str(raw).strip().lower() if raw is not None else ""
        if name in _SCHED_ITEMS:
            refuse("rabit_sched", raw, _SCHED_ITEMS[name])
        for key, item in (("rabit_tune_dir", "A8"),
                          ("rabit_synth_plan", "A8"),
                          ("rabit_chaos", "A8"),
                          ("rabit_directory", "A8"),
                          ("rabit_obs_dir", "A8"),
                          ("rabit_trace_dir", "A8")):
            raw = param_or_env(key)
            if raw is not None and str(raw).strip():
                refuse(key, raw, item)
        raw = param_or_env("rabit_wire_codec")
        if not _off(raw):
            refuse("rabit_wire_codec", raw, "A8")
        raw = param_or_env("rabit_wire_dtype")
        wire = str(raw).strip().lower() if raw not in (None, "") else "native"
        if wire == "bf16":
            refuse("rabit_wire_dtype", raw, "A8")
        check(wire == "native",
              "rabit_wire_dtype must be 'native' or 'bf16', got %r", wire)
        codec_keys = {k for k in params if k.startswith("rabit_codec_")}
        codec_keys |= {k.lower() for k in os.environ
                       if k.startswith("RABIT_CODEC_")}
        for key in sorted(codec_keys):
            raw = param_or_env(key)
            if raw is not None and str(raw).strip():
                refuse(key, raw, "A8")
        for key, item in (("rabit_heartbeat_sec", "A3b"),
                          ("rabit_link_mbps", "A8"),
                          ("rabit_trace_sample", "A8")):
            raw = param_or_env(key)
            if raw not in (None, "") and float(raw) > 0:
                refuse(key, raw, item)
        raw = param_or_env("rabit_obs")
        if not _off(raw):
            refuse("rabit_obs", raw, "A8")

    # Lower bound for waits on a REGISTERED tracker socket: rendezvous
    # replies legitimately wait out a slow rank, so the barrier keeps a
    # generous floor even when rabit_timeout_sec is tuned low for fast
    # hung-peer detection.
    TRACKER_BARRIER_MIN_SEC = 600.0

    # Exponential backoff doubles up to this many times, so the delay
    # cap is rabit_backoff_base_ms * 2**5 = 32x the base.
    BACKOFF_CAP_DOUBLINGS = 5

    def _backoff_delay_ms(self, attempt: int) -> float:
        """One capped-exponential-full-jitter backoff step:
        uniform(0, min(base * 2**(attempt-1), 32 * base)).  Full jitter
        (not a fixed schedule) so a world of workers hammering one
        rendezvous point decorrelates instead of thundering in lockstep.
        """
        base = self._backoff_base_ms
        cap_ms = base * (1 << min(attempt - 1, self.BACKOFF_CAP_DOUBLINGS))
        return random.uniform(0.0, cap_ms)

    def _backoff(self, attempt: int, max_ms: Optional[float] = None) -> None:
        """Sleep one backoff step before a retry.  ``max_ms`` clamps the
        sleep to a caller's remaining time budget.  (The reference also
        counts and traces each step; telemetry is ROADMAP A8.)"""
        delay_ms = self._backoff_delay_ms(attempt)
        if max_ms is not None:
            delay_ms = min(delay_ms, max(max_ms, 0.0))
        time.sleep(delay_ms / 1000.0)

    def _dial_retry(self, addr: tuple[str, int], site: str) -> socket.socket:
        """Dial with retries: up to rabit_connect_retries + 1 attempts,
        backed off between failures, within ONE rabit_timeout_sec of
        total wall time — retrying must never multiply how long a dead
        peer can wedge a rendezvous round (each attempt's connect
        timeout shrinks to the remaining budget, so SYN-dropped hosts
        still fail in one timeout, while instantly-refused dials get
        every attempt).  Raises LinkError (an OSError) carrying the last
        failure once either budget is spent."""
        attempts = self._connect_retries + 1
        deadline = (None if self._timeout is None
                    else time.monotonic() + self._timeout)
        last: Optional[OSError] = None
        made = 0
        for attempt in range(attempts):
            if attempt:
                # Budget check BEFORE the sleep, and the sleep itself
                # clamped to what's left.
                left_ms = (None if deadline is None
                           else (deadline - time.monotonic()) * 1000.0)
                if left_ms is not None and left_ms <= 0:
                    break
                self._backoff(attempt, max_ms=left_ms)
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
            try:
                made += 1
                return socket.create_connection(addr, timeout=remaining)
            except OSError as e:
                last = e
        raise LinkError(f"connect to {site} {addr[0]}:{addr[1]} failed "
                        f"after {made} attempt(s): {last}") from last

    def _tracker_connect(self, cmd: str) -> socket.socket:
        # Connection ESTABLISHMENT honors rabit_timeout_sec and retries
        # with backoff; the barrier wait after registration keeps its
        # own generous bound.
        sock = self._dial_retry(self._tracker_addr, "tracker")
        sock.settimeout(None if self._timeout is None
                        else max(self._timeout, self.TRACKER_BARRIER_MIN_SEC))
        P.send_hello(sock, cmd, self._task_id, self._world_hint,
                     job=self._job_id)
        return sock

    def _rendezvous(self, cmd: str) -> None:
        """Register with the tracker, receive topology, wire up links.
        A failure closes the listener and any link already wired."""
        self._close_links()
        try:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.bind(("0.0.0.0", 0))
            self._listener.listen(64)
            my_port = self._listener.getsockname()[1]
            topo = self._register(cmd, self._advertised_host(), my_port)
            if topo.sched:
                # The reference's dispatch lets a live directive
                # override the static crossover; a rank that ignored it
                # would pick another schedule than its peers and
                # deadlock.
                raise NotImplementedError(
                    f"the tracker handed out a live schedule directive "
                    f"{topo.sched!r}; the adaptive controller is not "
                    f"ported to rabit_tpu_torch yet (ROADMAP A8)")
            self._rank = topo.rank
            self._world = topo.world
            self._epoch = topo.epoch
            self._relaunched = self._relaunched or bool(topo.relaunched)
            self._parent = topo.parent
            self._tree_links = list(topo.neighbors)
            self._ring_prev = topo.ring_prev
            self._ring_next = topo.ring_next
            # Host-group handout for the hierarchical schedule (one id
            # per rank; empty from a pre-sched tracker).
            self._groups = list(topo.groups)
            os.environ["RABIT_TPU_LOG_TAG"] = f"rank{self._rank}"
            self._lf = tr.LinkFactory(self._tcfg, self._rank,
                                      timeout=self._timeout,
                                      sock_buf=self._sock_buf)
            self._reconnect_links(topo)
        except BaseException:
            self._close_links()
            raise

    def _register(self, cmd: str, my_host: str,
                  my_port: int) -> P.TopologyReply:
        """One rendezvous registration with the tracker, retried whole.

        The single dial already carries the connect retry/backoff
        schedule; this loop additionally survives the tracker dying
        UNDER the exchange — mid-handshake, or while this worker sat
        parked in the barrier.  Exhausting the budget raises
        :class:`TrackerLostError`.

        A typed ADMISSION reject (tracker at capacity) rides its own,
        separate budget (``rabit_admission_retries``), and an exhausted
        budget raises typed :class:`AdmissionError`; a malformed
        handshake (``REJECT_BAD_HANDSHAKE``) raises it at once, since
        retrying cannot help.  A ``REJECT_SHARD_MOVED`` redirect
        re-targets the owning shard its reason names, bounded by
        ``rabit_shard_retries`` (:class:`ShardMovedError`)."""
        attempts = max(self._connect_retries + 1, 1)
        adm_attempts = max(self._admission_retries + 1, 1)
        last: Optional[OSError] = None
        net_tries = 0
        adm_tries = 0
        shard_tries = 0
        while True:
            sock = None
            reply: P.TopologyReply | P.RejectReply | None = None
            try:
                sock = self._tracker_connect(cmd)
                P.send_str(sock, my_host)
                P.send_u32(sock, my_port)
                reply = P.TopologyReply.recv_or_reject(sock)
            except OSError as e:
                last = e
                net_tries += 1
                if net_tries >= attempts:
                    raise TrackerLostError(
                        f"tracker {self._tracker_addr[0]}:"
                        f"{self._tracker_addr[1]} unreachable: "
                        f"registration (cmd={cmd}) failed "
                        f"{net_tries} time(s): {last}") from last
                log("tracker registration (cmd=%s) failed (%s); "
                    "re-registering (attempt %d/%d)", cmd, e,
                    net_tries + 1, attempts)
                self._backoff(net_tries)
                continue
            finally:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            if isinstance(reply, P.RejectReply) \
                    and reply.code == P.REJECT_SHARD_MOVED:
                # The job hashes to another shard.  The reason carries
                # the owner's generation and endpoint: re-target.
                shard_tries += 1
                parsed = P.parse_shard_moved(reply.reason)
                if shard_tries > max(self._shard_retries, 0):
                    last_ep = (f"{parsed[2]}:{parsed[3]}" if parsed
                               else f"{self._tracker_addr[0]}:"
                                    f"{self._tracker_addr[1]}")
                    last_gen = parsed[0] if parsed else -1
                    raise ShardMovedError(
                        f"job {self._job_id!r} redirected "
                        f"{shard_tries} time(s) without landing on its "
                        f"owning shard (cmd={cmd}; last redirect: "
                        f"generation {last_gen}, endpoint {last_ep}): "
                        f"{reply.reason}",
                        generation=last_gen,
                        shard=parsed[1] if parsed else -1,
                        endpoint=last_ep)
                if parsed is not None:
                    gen, owner, host, port = parsed
                    log("tracker redirect: job %r owned by shard %d at "
                        "%s:%d (generation %d)", self._job_id, owner,
                        host, port, gen)
                    self._tracker_addr = (host, port)
                    if shard_tries >= 2:
                        # A second redirect in one walk means the
                        # membership is mid-flip: back off so redirected
                        # workers converge decorrelated.
                        self._backoff(shard_tries - 1)
                else:
                    # No redirect payload (and no directory to consult
                    # in the port): back off and re-ask the same
                    # endpoint (its view may settle).
                    self._backoff(shard_tries)
                continue
            if isinstance(reply, P.RejectReply):
                adm_tries += 1
                if reply.code == P.REJECT_BAD_HANDSHAKE:
                    # Not a capacity race: the tracker could not parse
                    # us (version/config skew) — retrying can't help.
                    raise AdmissionError(
                        f"tracker rejected the registration handshake "
                        f"(cmd={cmd}, job={self._job_id!r}): "
                        f"{reply.reason}",
                        code=reply.code, reason=reply.reason)
                if adm_tries >= adm_attempts:
                    raise AdmissionError(
                        f"job {self._job_id!r} refused admission "
                        f"{adm_tries} time(s) (cmd={cmd}): "
                        f"{reply.reason}",
                        code=reply.code, reason=reply.reason)
                log("tracker admission refused job %r (%s); backing off "
                    "and re-polling (attempt %d/%d)", self._job_id,
                    reply.reason, adm_tries + 1, adm_attempts)
                self._backoff(adm_tries)
                continue
            return reply

    def _reconnect_links(self, topo) -> None:
        """Wire the worker-worker links for a fresh topology.

        Outgoing dials (to lower ranks, already listening) honor
        rabit_timeout_sec AND the connect retry/backoff policy — during
        a rendezvous a peer is routinely slow to reach listen(), and
        one refused SYN must not kill the worker.  Incoming accepts are
        bounded like the dials: a peer that died between its tracker
        reply and dialing us must surface as a timeout, not an
        unbounded accept() wedge.

        Each established socket is handed to the transport factory,
        which runs the link handshake (classic bytes under default
        config), negotiates integrity framing where configured, and
        applies the shared socket setup (rabit_sock_buf, TCP_NODELAY,
        timeout) on every link.

        The listener's port is an ephemeral one, so a stray client — a
        process still dialing a port it once knew, such as a worker
        whose tracker died — can reach it.  The reference would take
        such a connection as a link; here a connection whose handshake
        fails, or that names a rank that cannot dial this one (only
        higher ranks of the world do, each once), is logged and closed,
        and the accepts go on within the same ``rabit_timeout_sec``.
        A valid peer's bytes are the reference's either way.
        """
        for peer_rank, host, port in topo.connect:
            s = self._dial_retry((host, port), "connect")
            self._links[peer_rank] = self._lf.dial(s, peer_rank)
        deadline = (None if self._timeout is None
                    else time.monotonic() + self._timeout)
        need = topo.naccept
        while need:
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise socket.timeout(
                        f"rank {self._rank}: {need} peer link(s) not "
                        f"accepted within rabit_timeout_sec")
                self._listener.settimeout(left)
            s, addr = self._listener.accept()
            try:
                link, peer_rank = self._lf.accept(s)
            except (OSError, RabitError, P.HandshakeError) as e:
                log("dropped a stray connection from %s:%d on the link "
                    "listener: %s", addr[0], addr[1], e)
                s.close()
                continue
            if not self._rank < peer_rank < self._world \
                    or peer_rank in self._links:
                log("dropped a stray connection from %s:%d on the link "
                    "listener: it named rank %d", addr[0], addr[1],
                    peer_rank)
                link.close()
                continue
            self._links[peer_rank] = link
            need -= 1
        self._listener.close()
        self._listener = None

    def _advertised_host(self) -> str:
        # Single-host jobs (tests, local launches) rendezvous via
        # loopback; multi-host workers advertise the interface that
        # routes to the tracker.
        return routable_ip(self._tracker_addr)

    def _close_links(self) -> None:
        for s in self._links.values():
            try:
                s.close()
            except OSError:
                pass
        self._links.clear()
        if self._listener is not None:
            self._listener.close()
            self._listener = None

    def shutdown(self) -> None:
        self._fence()
        self._stop_pump()
        if self._tracker_addr is not None:
            try:
                self._tracker_connect(P.CMD_SHUTDOWN).close()
            except OSError:
                pass  # tracker gone: leaving needs no goodbye
        self._close_links()

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
    def was_relaunched(self) -> bool:
        return self._relaunched

    @property
    def epoch(self) -> int:
        """Membership epoch of the topology this engine runs under."""
        return self._epoch

    def tracker_print(self, msg: str) -> None:
        # One-shot command connect, best effort by design: a tracker
        # that died after the last barrier must never turn a worker's
        # successful exit into a traceback — the message falls back to
        # the local stream instead.
        try:
            with self._tracker_connect(P.CMD_PRINT) as sock:
                P.send_str(sock, msg)
        except OSError:
            print(f"@tracker[{self._rank}] {msg}", flush=True)

    # ------------------------------------------------------------------
    # link IO helpers (delegating to rabit_tpu_torch/transport)
    # ------------------------------------------------------------------
    def _send(self, rank: int, data: bytes | memoryview) -> None:
        self._links[rank].sendall(data)

    def _recv(self, rank: int, nbytes: int, into: memoryview | None = None):
        return self._links[rank].recv_exact(nbytes, into)

    def _sendv(self, rank: int, *parts) -> None:
        """Scatter-gather send: coalesce several buffers (header +
        payload) into as few syscalls as the transport allows — the byte
        stream is identical to sequential ``sendall`` calls."""
        self._links[rank].sendv(parts)

    def _recv_all(self, ranks: list[int], nbytes: int,
                  bufs: list[memoryview]) -> None:
        """Multi-link pump: fill ``bufs[i][:nbytes]`` from ``ranks[i]``,
        draining every link concurrently.  Callers merge in
        deterministic rank order afterwards — reduction order is
        unchanged."""
        tr.recv_all([self._links[r] for r in ranks], nbytes, bufs,
                    self._timeout)

    def _exchange(self, send_rank: int, send_data: memoryview,
                  recv_rank: int, recv_buf: memoryview) -> None:
        """Full-duplex: stream send_data to one peer while filling
        recv_buf from another — avoids ring deadlock without threads."""
        self._exchange_v(send_rank, [send_data], recv_rank, [recv_buf])

    def _exchange_v(self, send_rank: int, send_parts: list,
                    recv_rank: int, recv_parts: list) -> None:
        """Vectored full-duplex exchange: scatter-gather send of
        ``send_parts`` (no intermediate concatenation copy) while
        filling ``recv_parts`` in order.  The fused segmented-ring hot
        path moves every member's block through here."""
        tr.exchange(self._links[send_rank], send_parts,
                    self._links[recv_rank], recv_parts, self._timeout)

    # ------------------------------------------------------------------
    # hop pipelining
    # ------------------------------------------------------------------
    def _hop_exchange_merge(self, send_rank: int, sblk, recv_rank: int,
                            rbytes: int, cbytes: int, item: int,
                            merge, what: str = "hop") -> None:
        """One collective hop: stream ``sblk`` to ``send_rank`` while
        receiving ``rbytes`` from ``recv_rank`` in chunks, folding each
        received chunk via ``merge(coff, rl, src)`` (``rl`` bytes at
        hop byte-offset ``coff``).  With ``rabit_pipeline_depth`` > 1
        and a hop large enough to split, up to depth chunk exchanges
        stay in flight while earlier chunks merge.  Depth 1 (or a hop
        that fits one pipeline chunk) runs the serial loop.  Results
        are bit-identical across depths: merges touch disjoint
        item-aligned ranges in the same order with the same values, and
        the per-link byte stream is depth-independent — mixed-depth
        peers interoperate.

        ``cbytes`` is the caller's reduce-buffer chunk budget; the
        pipeline sub-chunk is ``cbytes // depth`` floored at
        ``rabit_pipeline_chunk`` (item-aligned), and the in-flight
        window is capped so its leases together never exceed the
        configured budget: ``rabit_reduce_buffer`` stays an honest
        per-op scratch ceiling with the pipeline armed.  Either side
        may be empty (the halving fold pre-step pipelines a recv-only
        drain)."""
        slen = len(sblk)
        depth = self._pipe_depth
        if depth > 1 and (slen or rbytes):
            pcb = min(cbytes, max(cbytes // depth, self._pipe_chunk))
            pcb = max(pcb - pcb % item, item)
            nsteps = max(-(-slen // pcb), -(-rbytes // pcb))
            # Window cap: the in-flight leases (window * pcb) must fit
            # the CONFIGURED budget.
            window = min(depth, nsteps,
                         max(self._reduce_buffer // pcb, 1))
            if nsteps >= 2 and window >= 2:
                self._hop_pipelined(send_rank, sblk, recv_rank, rbytes,
                                    pcb, merge, nsteps, window, what)
                return
        # Serial hop loop (depth 1, or nothing to overlap): exchange one
        # chunk, merge it, repeat.
        nsteps = max(-(-slen // cbytes), -(-rbytes // cbytes), 0)
        if not nsteps:
            return
        lease = self._arena.take(min(cbytes, max(rbytes, 1)))
        self._note_scratch(len(lease))
        try:
            for ci in range(nsteps):
                coff = ci * cbytes
                sl = min(cbytes, max(slen - coff, 0))
                rl = min(cbytes, max(rbytes - coff, 0))
                self._exchange(send_rank, sblk[coff:coff + sl],
                               recv_rank, lease[:rl])
                if rl:
                    merge(coff, rl, lease[:rl])
        finally:
            self._arena.give(lease)

    def _pipe_run(self, send_rank: int, recv_rank: int, what: str,
                  body) -> None:
        """Run ``body(pipe)`` under the choreography every pipelined
        hop shares: open (pump_begin may raise on a dead link), flush
        + restore on success, ABORT on any exception (framed backlog
        dropped)."""
        pipe = None
        try:
            pipe = tr.HopPipeline(self._links[send_rank],
                                  self._links[recv_rank],
                                  self._timeout, what)
            body(pipe)
            pipe.close()
        except BaseException:
            if pipe is not None:
                pipe.abort()
            raise

    def _hop_pipelined(self, send_rank: int, sblk, recv_rank: int,
                       rbytes: int, pcb: int, merge, nsteps: int,
                       window: int, what: str) -> None:
        """The depth-window body of :meth:`_hop_exchange_merge`: chunk
        k merges while chunk k+1's exchange is in flight on the
        transport pump.  Scratch: one recv lease per window slot —
        chunk ci reuses lease ``ci % window``, safe because ci only
        pushes after ci-window (the slot's previous user) was popped
        and merged."""
        depth = window
        slen = len(sblk)
        lease_bytes = min(pcb, max(rbytes, 1))
        leases = [self._arena.take(lease_bytes) for _ in range(depth)]
        self._note_scratch(lease_bytes * depth)

        def body(pipe) -> None:
            def pop_merge() -> None:
                coff, rl, li = pipe.pop()
                if rl:
                    merge(coff, rl, leases[li][:rl])

            for ci in range(nsteps):
                if ci >= depth:
                    pop_merge()
                coff = ci * pcb
                sl = min(pcb, max(slen - coff, 0))
                rl = min(pcb, max(rbytes - coff, 0))
                pipe.push([sblk[coff:coff + sl]] if sl else [],
                          [leases[ci % depth][:rl]] if rl else [],
                          (coff, rl, ci % depth))
            while pipe.inflight:
                pop_merge()

        try:
            self._pipe_run(send_rank, recv_rank, what, body)
        finally:
            for lease in leases:
                self._arena.give(lease)

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------
    @staticmethod
    def _host_only(buf, what: str) -> None:
        """This engine moves numpy through the host wire; a tensor is
        refused before any byte moves, never copied to the host
        quietly."""
        if isinstance(buf, torch.Tensor):
            raise TypeError(
                f"{what}: the pysocket engine reduces numpy arrays; got a "
                f"torch.Tensor on {buf.device} (move it with .cpu().numpy() "
                f"or use a device-plane engine, ROADMAP A5)")

    def allreduce(
        self,
        buf: np.ndarray,
        op: ReduceOp,
        prepare_fun: Optional[Callable[[], None]] = None,
    ) -> np.ndarray:
        self._host_only(buf, "allreduce")
        self._fence()
        return self._allreduce_blocking(buf, op, prepare_fun)

    def _allreduce_blocking(
        self,
        buf: np.ndarray,
        op: ReduceOp,
        prepare_fun: Optional[Callable[[], None]] = None,
    ) -> np.ndarray:
        """The blocking op body: fill (``prepare_fun``), then reduce in
        place through the wire.  Also run (in issue order) by the async
        progress thread — which must not re-enter the fence."""
        if prepare_fun is not None:
            prepare_fun()
        if self._world == 1:
            return buf
        self._allreduce_dispatch(buf, op)
        return buf

    def _wire_merge(self, op: ReduceOp, rflat: np.ndarray, e0: int,
                    ne: int, src: np.ndarray) -> None:
        """The schedules' single reduction primitive: fold ``ne``
        received elements into ``rflat[e0:e0+ne]`` with
        ``apply_op_numpy`` (the reference's classic full-width branch;
        its codec branches wait for ROADMAP A8)."""
        apply_op_numpy(op, rflat[e0:e0 + ne], src[:ne])

    # ------------------------------------------------------------------
    # schedule selection (rabit_tpu_torch/sched/)
    # ------------------------------------------------------------------
    def _ring_crossover(self) -> int:
        """Static tree/ring byte crossover: the configured
        rabit_ring_threshold_bytes, else the module default."""
        return (self._ring_threshold if self._ring_threshold is not None
                else TREE_RING_CROSSOVER_BYTES)

    def _static_schedule(self, nbytes: int) -> "sched_mod.Schedule":
        if nbytes <= self._ring_crossover() or self._world == 2:
            return sched_mod.TREE
        return sched_mod.RING

    def _pick_schedule(self, nbytes: int) -> "sched_mod.Schedule":
        """Resolve the schedule for one dispatch point.  Every input is
        replicated across ranks (payload size, world, topology handout,
        the uniform rabit_sched/threshold config), so all ranks pick the
        same algorithm — a collective decision.  A forced schedule that
        does not apply here takes the static crossover."""
        name = self._sched_name
        if name == "static":
            return self._static_schedule(nbytes)
        s = sched_mod.SCHEDULES[name]
        if s.applies(self, nbytes):
            return s
        return self._static_schedule(nbytes)

    def set_schedule(self, name: str) -> None:
        """Switch the selection mode at runtime (bench/tests hook).
        Like rabit_sched itself, the value MUST be uniform across ranks
        and changed only between collectives.  The reference's modes
        that are not ported raise :class:`NotImplementedError` naming
        their ROADMAP item, as the knob does."""
        if name in _SCHED_ITEMS:
            raise NotImplementedError(
                f"schedule {name!r} is not ported to rabit_tpu_torch yet "
                f"(ROADMAP {_SCHED_ITEMS[name]})")
        check(name in sched_mod.MODES,
              "schedule must be one of %s, got %r",
              "/".join(sched_mod.MODES), name)
        self._sched_name = name

    def _allreduce_dispatch(self, buf: np.ndarray, op: ReduceOp) -> None:
        if buf.nbytes == 0:
            self._op_sched = None  # no wire phase: no schedule label
            return  # zero-size payloads move no wire bytes anywhere
        s = self._pick_schedule(buf.nbytes)
        self._op_sched = s.name
        s.run(self, buf, op)

    def _children(self) -> list[int]:
        return [r for r in self._tree_links if r != self._parent]

    def _note_scratch(self, nbytes: int) -> None:
        if nbytes > self.scratch_peak_bytes:
            self.scratch_peak_bytes = nbytes

    def _drain_merge(self, peers: list[int], nitems: int, item: int,
                     merge, after_chunk=None) -> int:
        """Chunked concurrent drain-and-merge from ``peers``, the tree
        collective's deadlock-sensitive inner pump.

        Peers drain CONCURRENTLY through the transport pump, but merges
        stay in fixed peer order so the reduction order — and hence
        every result bit — matches the sequential protocol.  The
        rabit_reduce_buffer chunk budget divides across the peer
        buffers (chunk size never changes the per-link byte stream, so
        mixed-budget peers still interoperate); ``merge(off, n, src)``
        folds ``n`` items of received bytes ``src`` into the payload at
        item offset ``off``, and ``after_chunk(off, n)`` runs once per
        chunk window after its merges (the tree pump forwards the
        merged window to its parent there).  Returns the chunk size so
        callers can stream a symmetric follow-up phase.
        """
        denom = item * max(len(peers), 1)
        chunk = min(max(self._reduce_buffer // denom, 1), nitems)
        leases = [self._arena.take(chunk * item) for _ in peers]
        # scratch_peak reports the chunked working-set BUDGET (floored
        # at one chunk): peer-less ranks lease no scratch, but still
        # stream through chunk-sized windows, so `0 < peak <= budget`
        # holds on every rank.
        self._note_scratch(chunk * item * max(len(peers), 1))
        try:
            for off in range(0, nitems, chunk):
                n = min(chunk, nitems - off)
                if len(peers) == 1:
                    self._recv(peers[0], n * item, leases[0][: n * item])
                elif peers:
                    self._recv_all(peers, n * item, leases)
                for ci in range(len(peers)):
                    merge(off, n, leases[ci][: n * item])
                if after_chunk is not None:
                    after_chunk(off, n)
        finally:
            for lease in leases:
                self._arena.give(lease)
        return chunk

    def _tree_chunked(self, view: memoryview, nitems: int, item: int,
                      merge) -> None:
        """Two-phase chunked tree collective.

        Chunked to the rabit_reduce_buffer budget in two strictly
        one-directional phases (all chunks up, then all chunks down):
        blocking sockets cannot deadlock, chunks stream across tree
        levels, and the per-link byte stream matches the unchunked
        protocol, so peers with different budgets interoperate.
        ``merge(off, n, src)`` folds ``n`` items of received bytes
        ``src`` into the payload at item offset ``off``.
        """
        children = self._children()
        send_up = None
        if self._parent != P.NONE:
            def send_up(off: int, n: int) -> None:
                self._send(self._parent,
                           view[off * item:(off + n) * item])
        # Phase 1: reduce up.
        chunk = self._drain_merge(children, nitems, item, merge,
                                  after_chunk=send_up)
        # Phase 2: broadcast down.
        for off in range(0, nitems, chunk):
            n = min(chunk, nitems - off)
            if self._parent != P.NONE:
                self._recv(self._parent, n * item,
                           view[off * item:(off + n) * item])
            for r in children:
                self._send(r, view[off * item:(off + n) * item])

    def _tree_allreduce(self, buf: np.ndarray, op: ReduceOp) -> None:
        """Reduce up the binary tree, broadcast the result down.  (The
        reference's ``red_dtype``, the merge type of its bf16 wire, comes
        with the codecs, ROADMAP A8.)"""
        flat = buf.reshape(-1)
        if flat.nbytes == 0:
            return  # zero-size payloads move no wire bytes on any rank

        def merge(off: int, n: int, src: memoryview) -> None:
            self._wire_merge(op, flat, off, n,
                             np.frombuffer(src, dtype=flat.dtype, count=n))

        self._tree_chunked(memoryview(flat).cast("B"), len(flat),
                           flat.itemsize, merge)

    def allreduce_custom(self, buf: np.ndarray, reducer, prepare_fun=None
                         ) -> np.ndarray:
        """Tree-fold custom allreduce: the Python ``reducer(dst, src)``
        merges per tree edge, O(log n) payload hops — replacing the
        interface's allgather-and-fold default (O(world x payload)).
        Chunked row-wise to the reduce-buffer budget like
        _tree_allreduce; the reducer must be associative+commutative
        (merge order is tree order)."""
        self._host_only(buf, "allreduce_custom")
        self._fence()
        return self._allreduce_custom_blocking(buf, reducer, prepare_fun)

    def _allreduce_custom_blocking(self, buf: np.ndarray, reducer,
                                   prepare_fun=None) -> np.ndarray:
        if prepare_fun is not None:
            prepare_fun()
        if self._world == 1:
            return buf
        return self._allreduce_custom_impl(buf, reducer)

    def _allreduce_custom_impl(self, buf: np.ndarray, reducer) -> np.ndarray:
        # Custom allreduces always ride the tree fold.
        self._op_sched = "tree"
        rows = buf.shape[0] if buf.ndim > 0 else buf.size
        check(rows > 0, "allreduce_custom: empty buffer")
        if buf.nbytes == 0:
            return buf  # zero-size rows: nothing to merge or move
        row_shape = buf.shape[1:] if buf.ndim > 1 else ()
        flat = buf.reshape(rows, -1)
        item = flat.shape[1] * flat.itemsize  # bytes per axis-0 row
        dst_rows = buf.reshape((rows,) + row_shape)

        def merge(off: int, n: int, src: memoryview) -> None:
            rows_in = np.frombuffer(src, dtype=buf.dtype,
                                    count=n * flat.shape[1])
            reducer(dst_rows[off:off + n], rows_in.reshape((n,) + row_shape))

        self._tree_chunked(memoryview(flat).cast("B"), rows, item, merge)
        return buf

    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        self._fence()
        return self._broadcast_blocking(data, root)

    def _broadcast_blocking(self, data: Optional[bytes], root: int) -> bytes:
        if self._world == 1:
            check(data is not None, "broadcast: root rank must supply data")
            return data
        return self._bcast_impl(data, root)

    def _bcast_impl(self, data: Optional[bytes], root: int) -> bytes:
        """Tree flood from ``root``."""
        if self._rank == root:
            check(data is not None, "broadcast: root rank must supply data")
            header = struct.pack("<Q", len(data))
            view = memoryview(data)
            # Header + first chunk coalesce into one scatter-gather
            # write per link (the payload is resident at the root);
            # the byte stream per link is unchanged.
            for r in self._tree_links:
                self._sendv(r, header, view[:CHUNK_BYTES])
            for off in range(CHUNK_BYTES, len(data), CHUNK_BYTES):
                chunk = view[off:off + CHUNK_BYTES]
                for r in self._tree_links:
                    self._send(r, chunk)
            return data
        # Non-root: the payload arrives on exactly one tree link — the
        # first hop on the tree path toward the root, computable
        # locally.  Chunk-pipelined: each chunk is forwarded downstream
        # as soon as it arrives, so the payload streams through the
        # tree instead of paying full-payload latency per level.
        src = self._toward(root)
        raw = self._recv(src, 8)
        (size,) = struct.unpack("<Q", bytes(raw))
        payload = memoryview(bytearray(size))
        header = struct.pack("<Q", size)
        downstream = [r for r in self._tree_links if r != src]
        for r in downstream:
            self._send(r, header)
        for off in range(0, size, CHUNK_BYTES):
            end = min(off + CHUNK_BYTES, size)
            self._recv(src, end - off, payload[off:end])
            for r in downstream:
                self._send(r, payload[off:end])
        return bytes(payload)

    def _toward(self, root: int) -> int:
        """First hop on the binary-heap-tree path from this rank to ``root``.

        Walk ``root``'s ancestor chain (indices strictly decrease); if it
        passes through this rank, the hop is the child we came through,
        else it is our parent.
        """
        r, prev = root, P.NONE
        while r > self._rank:
            prev = r
            r = (r - 1) // 2
        return prev if r == self._rank else self._parent

    def allgather(self, buf: np.ndarray) -> np.ndarray:
        self._host_only(buf, "allgather")
        self._fence()
        return self._allgather_blocking(buf)

    def _allgather_blocking(self, buf: np.ndarray) -> np.ndarray:
        if self._world == 1:
            return buf[None]
        return self._allgather_impl(buf)

    def _allgather_impl(self, buf: np.ndarray) -> np.ndarray:
        """Ring all-gather: n-1 steps, each forwarding the newest block."""
        n = self._world
        out = np.empty((n,) + buf.shape, dtype=buf.dtype)
        out[self._rank] = buf
        for s in range(n - 1):
            send_b = (self._rank - s) % n
            recv_b = (self._rank - s - 1) % n
            self._exchange(
                self._ring_next, memoryview(out[send_b]).cast("B"),
                self._ring_prev, memoryview(out[recv_b]).cast("B"))
        return out

    # ------------------------------------------------------------------
    # async collectives: progress thread + small-op bucket fusion
    # ------------------------------------------------------------------
    # One background progress thread owns the links while async ops are
    # in flight; queued ops run strictly in issue order, so the wire
    # sees exactly the op sequence a blocking caller would produce.
    # Blocking entry points _fence() first, which also flushes the
    # coalescing bucket — mixing the two styles is always safe, never
    # reordered.

    def _ensure_pump(self) -> None:
        if self._aq_thread is None:
            self._aq_thread = threading.Thread(
                target=self._pump, name="rabit-async-pump", daemon=True)
            self._aq_thread.start()

    def _stop_pump(self) -> None:
        t = self._aq_thread
        if t is None:
            return
        with self._aq_cv:
            self._aq.append(None)
            self._aq_cv.notify_all()
        t.join(timeout=30)
        self._aq_thread = None

    def _pump(self) -> None:
        try:
            while True:
                with self._aq_cv:
                    while not self._aq:
                        self._aq_cv.wait()
                    item = self._aq.popleft()
                if item is None:
                    return
                fn, handles = item
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — surfaces at wait()
                    self._async_fail(e, handles)
                except BaseException as e:  # pump-killing failure
                    self._async_fail(e, handles)
                    raise
                finally:
                    with self._aq_cv:
                        self._aq_inflight -= 1
                        self._aq_cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — pump death: poison,
            self._poison_pending(e)  # never a downstream hang

    def _poison_pending(self, cause: BaseException) -> None:
        """The pump thread is dying: every queued (and future) async op
        can never run.  Fail their handles so ``wait()`` raises
        :class:`AsyncPumpError` instead of hanging forever, and wake
        any ``_fence()`` waiter."""
        err = AsyncPumpError(f"async progress pump died: "
                             f"{type(cause).__name__}: {cause}")
        err.__cause__ = cause
        log("async progress pump died (%s: %s); poisoning %d queued op "
            "group(s)", type(cause).__name__, cause, len(self._aq))
        with self._aq_cv:
            self._pump_error = err
            drained = list(self._aq)
            self._aq.clear()
            self._aq_inflight = 0
            self._aq_cv.notify_all()
        for item in drained:
            if item is None:
                continue
            for h in item[1]:
                if not h.done():
                    h._fail(err)

    def _async_fail(self, exc: BaseException, handles: tuple) -> None:
        """Progress-thread failure path: no bare thread tracebacks — the
        error is logged and re-raises at the caller's ``wait()`` (a link
        failure surfaces there as :class:`LinkError`, same as the
        blocking path).  The reference's ``WorldChangedError`` branch
        (drain the queue, realign the wait cursor, keep the pump alive
        for a rescaled world) comes with elastic membership, ROADMAP
        A4."""
        log("async collective failed in the progress thread: %s: %s",
            type(exc).__name__, exc)
        for h in handles:
            if not h.done():
                h._fail(exc)

    def _submit(self, fn: Callable[[], None], handles: tuple) -> None:
        # The pump-death check and the enqueue must be one atomic
        # section: _poison_pending drains the queue under this same
        # lock, so an item appended here is either drained by the
        # poison pass or observed the error first — never enqueued
        # behind a pump that already exited.
        with self._aq_cv:
            if self._pump_error is None:
                self._ensure_pump()
                self._aq.append((fn, handles))
                self._aq_inflight += 1
                self._aq_cv.notify_all()
                return
            err = self._pump_error
        # The pump is dead; the op can never run.  Poison the handles
        # at issue so wait() raises immediately.
        for h in handles:
            if not h.done():
                h._fail(err)

    def _fence(self) -> None:
        """Drain the async stream: flush the pending bucket and wait for
        every queued op to finish.  Called by every blocking collective,
        checkpoint and shutdown (never from the pump itself)."""
        if self._pending is not None:
            self._flush_bucket()
        if self._aq_thread is None:
            return
        with self._aq_cv:
            while self._aq_inflight:
                self._aq_cv.wait()

    def _new_handle(self) -> CollectiveHandle:
        h = CollectiveHandle(on_wait=self._before_wait)
        h._issue_index = self._issue_idx
        self._issue_idx += 1
        return h

    def _resolve_handle(self, h: CollectiveHandle, result) -> None:
        h._resolve(result)

    def _before_wait(self, h: CollectiveHandle) -> None:
        idx = h._issue_index
        with self._aq_cv:
            if idx > self._wait_idx:
                raise AsyncOrderError(
                    f"async handles must be waited in issue order: handle "
                    f"#{idx} waited before handle #{self._wait_idx}")
            if idx < self._wait_idx:
                return  # idempotent re-wait
            self._wait_idx = idx + 1
        if self._pending is not None:
            self._flush_bucket()

    def allreduce_async(
        self,
        buf: np.ndarray,
        op: ReduceOp,
        prepare_fun: Optional[Callable[[], None]] = None,
        fuse: bool = True,
        codec: bool = True,
    ) -> CollectiveHandle:
        """``fuse=False`` is the lone-op escape hatch: a bucketed op
        only reaches the wire when its bucket flushes (next incompatible
        op, ``wait()``, or a fence), so a latency-sensitive op with no
        stream behind it should opt out of coalescing to start
        immediately and actually overlap the caller's compute.
        ``codec=False`` is the reference's per-op codec opt-out: no
        codec is ported (ROADMAP A8), so every op rides the full-width
        wire, but the flag keys the buckets as the reference's does.
        Both flags are program order, hence deterministic across
        ranks."""
        self._host_only(buf, "allreduce_async")
        if self._world == 1:
            return CollectiveHandle.resolved(
                self.allreduce(buf, op, prepare_fun))
        h = self._new_handle()
        flat = buf.reshape(-1)
        if fuse and 0 < flat.nbytes <= self._bucket_bytes:
            self._bucket_add(flat, buf, op, prepare_fun, h, codec)
        else:
            self._flush_bucket()
            self._submit(lambda: self._resolve_handle(
                h, self._allreduce_blocking(buf, op, prepare_fun)), (h,))
        return h

    def allgather_async(self, buf: np.ndarray) -> CollectiveHandle:
        self._host_only(buf, "allgather_async")
        if self._world == 1:
            return CollectiveHandle.resolved(self.allgather(buf))
        h = self._new_handle()
        self._flush_bucket()
        self._submit(lambda: self._resolve_handle(
            h, self._allgather_blocking(buf)), (h,))
        return h

    def _bucket_add(self, flat: np.ndarray, buf: np.ndarray, op: ReduceOp,
                    prepare_fun, h: CollectiveHandle,
                    codec: bool = True) -> None:
        p = self._pending
        # The codec flag joins op/dtype as a bucket-compatibility key,
        # as in the reference: a fused wire op has ONE wire format.
        if p is not None and (p["op"] != op or p["dtype"] != flat.dtype
                              or p["codec"] != codec
                              or p["nbytes"] + flat.nbytes
                              > self._bucket_bytes):
            self._flush_bucket()
            p = None
        if p is None:
            p = self._pending = {"op": op, "dtype": flat.dtype,
                                 "codec": codec, "nbytes": 0, "items": []}
        p["items"].append((flat, buf, prepare_fun, h))
        p["nbytes"] += flat.nbytes

    def _flush_bucket(self) -> None:
        p, self._pending = self._pending, None
        if p is None:
            return
        items, op = p["items"], p["op"]
        if len(items) == 1:
            _flat, buf, prep, h = items[0]
            self._submit(lambda: self._resolve_handle(
                h, self._allreduce_blocking(buf, op, prep)), (h,))
            return
        self._submit(lambda: self._fused_allreduce_exec(items, op),
                     tuple(it[3] for it in items))

    @staticmethod
    def _scatter_fused(flats: list[np.ndarray], work: np.ndarray) -> None:
        off = 0
        for f in flats:
            f[:] = work[off:off + len(f)]
            off += len(f)

    def _fused_allreduce_exec(self, items: list, op: ReduceOp) -> None:
        """Runs ON the progress thread: one wire op for a whole bucket
        of small same-op/same-dtype allreduces.  The robust engine
        (ROADMAP A4) overrides this with its consensus/cache/replay
        protocol (one seqno per bucket)."""
        for _flat, _buf, prep, _h in items:
            if prep is not None:
                prep()
        self._fused_wire([it[0] for it in items], op)
        for _flat, buf, _prep, h in items:
            self._resolve_handle(h, buf)

    def _member_rides_tree(self, flat: np.ndarray, op: ReduceOp) -> bool:
        """Would this member solo on the tree?  Classified on the same
        quantity the solo dispatch uses (its bytes, with no codec), so
        a member takes the identical algorithm (and reduction order)
        fused or solo."""
        if self._world == 2:
            return True
        return flat.nbytes <= self._ring_crossover()

    def _fused_wire(self, flats: list[np.ndarray], op: ReduceOp) -> None:
        """In-place fused reduction of same-op/same-dtype member arrays.

        Bit-transparency is the design constraint: fusion must not
        change any member's element-wise reduction ORDER.  Tree order is
        position-independent (children-then-parent for every element),
        so members that would solo on the tree reduce as one
        concatenated tree op — forced onto the tree even when the
        concatenation crosses the tree/ring size threshold; ring order
        depends on a member's own block partition, so ring-class members
        ride a SEGMENTED ring (per-member block bounds, vectored
        exchanges) and come out bit-identical to their solo runs.

        Under a forced schedule the bucket instead concatenates whole
        and rides the selected schedule for the concatenated size: the
        halving and hierarchical peer patterns partition by block
        position, so per-member solo order cannot be preserved through
        fusion anyway — results are exact for exactly-representable
        payloads and deterministic either way.  (The reference's codec
        branches wait for ROADMAP A8; without them its
        ``_ring_allreduce_fused``/``_ring_segmented`` faces are the one
        call to the segmented pump, ``sched/ring.py``.)
        """
        if self._sched_name != "static":
            if len(flats) == 1:
                self._allreduce_dispatch(flats[0], op)
            else:
                work = np.concatenate(flats)
                self._allreduce_dispatch(work, op)
                self._scatter_fused(flats, work)
            return
        tree = [f for f in flats if self._member_rides_tree(f, op)]
        ring = [f for f in flats if not self._member_rides_tree(f, op)]
        # Span label, as the reference keeps it: a mixed bucket keeps
        # the label of its LAST wire phase.
        self._op_sched = "ring" if ring else "tree"
        if len(tree) == 1:
            self._allreduce_dispatch(tree[0], op)
        elif tree:
            work = np.concatenate(tree)
            self._tree_allreduce(work, op)
            self._scatter_fused(tree, work)
        if ring:
            sched_mod.ring_segmented(self, ring, op)

    # ------------------------------------------------------------------
    # checkpoints (non-fault-tolerant: process-local, like the reference
    # base engine — the robust layer adds replication/recovery, A4)
    # ------------------------------------------------------------------
    def load_checkpoint(self):
        self._fence()
        return (self._version, self._global, self._local)

    def checkpoint(self, global_model, local_model=None, lazy_global=None):
        self._fence()
        if global_model is None and lazy_global is not None:
            global_model = lazy_global()
        self._global = global_model
        self._local = local_model
        self._version += 1

    @property
    def version_number(self) -> int:
        return self._version
