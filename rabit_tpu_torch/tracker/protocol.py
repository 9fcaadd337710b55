"""Wire protocol between workers and the tracker.

A fresh design (not the reference's ad-hoc handshake, though it serves the
same role — reference: src/allreduce_base.cc:138-158 ConnectTracker and
tracker/rabit_tracker.py:47-122): little-endian length-prefixed primitives
chosen so the C++ native engine can speak it with a few dozen lines and no
JSON dependency.

PyTorch-port counterpart of :mod:`rabit_tpu.tracker.protocol`, copied
whole (it imports only the stdlib), so every message is byte-identical
in both directions and a world may mix the two packages' ranks under one
tracker.  The port's tracker (:mod:`rabit_tpu_torch.tracker.tracker`)
serves start, recover, print and shutdown; it refuses the other commands
named below as the reference refuses an unknown command.

All integers are u32 little-endian.  Strings are u32 length + utf-8 bytes.

Worker → tracker, on every fresh tracker connection:

    u32 magic       MAGIC (protocol/version gate), or MAGIC_JOB for the
                    multi-tenant hello — then `str job` follows
                    immediately (the tenant this connection belongs to,
                    [A-Za-z0-9._-], 64 chars max).  A worker whose job
                    id is the DEFAULT_JOB sends the plain MAGIC hello,
                    so the default-tenant byte stream is IDENTICAL to
                    the pre-multi-tenant wire in both directions: old
                    workers land in the "default" job on a new tracker,
                    and a new worker without a job id still speaks to
                    an old tracker.
    str cmd         "start" | "recover" | "rescale" | "print" | "shutdown"
    str task_id     stable worker identity (rank reassignment on restart)
    u32 world       world size the worker was launched with (0 = unknown)

then, for cmd in {start, recover, rescale}:

    str host        worker's listening address
    u32 port        worker's listening port

The tracker length-caps and charset-checks every handshake read
(:func:`recv_hello`): a stray client on the tracker port (port scanner,
HTTP probe) is logged and dropped at the magic check, and a client that
passed the magic but sent garbage lengths / non-utf-8 gets a typed
reject reply (:class:`RejectReply`, code ``REJECT_BAD_HANDSHAKE``)
instead of wedging or crashing the accept thread.

tracker → worker reply (start/recover/rescale only) — EITHER a reject
frame (the first u32 is the REJECT sentinel, which can never be a real
rank):

    u32 REJECT      0xFFFFFFFE
    u32 code        REJECT_* (admission / handshake)
    str reason      human-readable detail

— sent when admission control (tracker --max-jobs /
--max-total-workers) refuses the job; workers retry it with backoff
and surface a typed ``AdmissionError`` once the budget is spent
(engine/pysocket.py) — or the topology:

    u32 rank
    u32 world
    u32 parent      tree parent rank, NONE if root
    u32 nneighbor   tree neighbor count, then that many u32 ranks
    u32 ring_prev   ring predecessor rank
    u32 ring_next   ring successor rank
    u32 nconnect    peers to actively connect: (u32 rank, str host, u32 port)*
    u32 naccept     number of inbound connections to expect
    u32 relaunched  1 iff this is a cmd=start re-registration of a task_id
                    that already completed a rendezvous round — i.e. a
                    mid-job relaunch.  Lets engines detect relaunch even
                    when the platform restarts workers with a clean
                    environment (no RABIT_NUM_TRIAL/RABIT_RELAUNCH).
    u32 epoch       the membership epoch this topology belongs to; bumped
                    every time the tracker completes a RESCALE round
                    (world grew or shrank, ranks reassigned).  Trailing
                    field on purpose: a reader of the pre-elastic layout
                    simply leaves it unread on the one-shot socket.
    u32 ngroups     host-group handout for the topology-aware schedules:
                    one group id per rank (ranks on the same host share
                    an id — or the RABIT_TRACKER_GROUPS override), then
                    that many u32 ids.  The hierarchical two-level
                    schedule keys off it (sched/hier.py).
                    Trailing like epoch: older readers leave it unread.
    str sched       live schedule directive from the tracker's adaptive
                    controller ("" = none): per-payload-bucket override
                    entries "bytes:name,..." the engine consults before
                    its static/auto pick (sched/tuner.py
                    decode_directive; doc/performance.md "Online
                    adaptation").  Pushed to the whole world together
                    at a schedule-switch epoch.
    u32 ndemoted    straggler-demoted ranks (then that many u32 ranks):
                    excluded from hierarchical leader election on every
                    rank identically (sched/topo.py group_leader).
                    Both fields are trailing like epoch/groups — and
                    the READER also tolerates their absence (a
                    pre-adaptive tracker closes the one-shot socket
                    after groups; the worker defaults to no directive).

for cmd == "print": str message follows, no reply.
for cmd == "shutdown": nothing follows, no reply.
for cmd == "heartbeat": u32 period_ms follows, then the connection stays
    OPEN (the one persistent tracker connection) carrying one u32 beat
    per period; HEARTBEAT_BYE closes it cleanly at worker shutdown.
    EOF without the bye, or a missed-beat budget, marks the worker dead
    on the control plane (tracker/tracker.py heartbeat sweep).
    Telemetry-streaming workers multiplex **obs frames** onto the same
    byte stream: u32 HEARTBEAT_OBS, u32 length, then ``length`` bytes
    of JSON padded with spaces to a u32 boundary (delta metric
    snapshot + buffered collective spans — doc/observability.md "Live
    telemetry").  Frames count as liveness like beats.  Once a worker
    has sent any obs frame the tracker ECHOES each subsequent beat
    number back on the connection (best-effort, dropped when the
    socket buffer is full); the worker measures the round trip as its
    ``hb.rtt.seconds`` histogram.  A pre-obs tracker reads a frame as
    a run of meaningless beat values — the padding keeps the stream
    u32-ALIGNED, and no aligned payload word can collide with
    HEARTBEAT_BYE (ASCII JSON + 0x20 padding), so the worker's real
    BYE is still recognized; a pre-obs worker never sends the sentinel
    nor reads echoes.  The channel stays compatible in both
    directions.

Worker ↔ worker, on each data link after connect:

    u32 magic, u32 own_rank     (both directions; ranks identify links)
"""
from __future__ import annotations

import re
import socket
import struct
from dataclasses import dataclass, field

MAGIC = 0x7AB17901
# Multi-tenant hello: `str job` follows the magic, then the classic
# layout (cmd, task_id, world, ...).  Only sent when the job id is not
# DEFAULT_JOB, so default-tenant traffic is byte-identical to the
# pre-multi-tenant wire (back-compat both directions).
MAGIC_JOB = 0x7AB17908
NONE = 0xFFFFFFFF

# The implicit tenant of every classic (MAGIC) hello.
DEFAULT_JOB = "default"
# Job ids become directory names (obs/<job>/, state_dir/<job>/) and log
# tags: one path-safe token, no leading dot, bounded length.
_JOB_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}\Z")
# Handshake string caps (recv_hello): task ids/commands/hosts are tens
# of bytes — a length prefix beyond this is a stray or hostile client,
# not a worker, and must not turn into an unbounded buffering recv.
MAX_HELLO_STR = 1024
# Print-channel payload cap: obs summaries are multi-KB JSON blobs, so
# the bound is generous — but still finite, so a corrupt length prefix
# cannot make the tracker buffer gigabytes.
MAX_PRINT_LEN = 8 << 20

# Reject reply sentinel: the first u32 of a registration reply is the
# assigned rank, which can never be this value (NONE is already taken
# by "no parent").  A reject frame follows: u32 code, str reason.
REJECT = 0xFFFFFFFE
REJECT_BAD_HANDSHAKE = 1   # parsed the magic, then garbage
REJECT_MAX_JOBS = 2        # admission: job count at --max-jobs
REJECT_MAX_WORKERS = 3     # admission: worker sum at --max-total-workers
# Sharded control plane (doc/fault_tolerance.md "Sharded tracker").
# Both codes only ever fire on a multi-shard deployment, so the
# single-shard wire stays byte-identical in both directions.
REJECT_SHARD_MOVED = 4     # job hashes to another shard; reason carries
#                            "gen=<G>;shard=<I>;endpoint=<host>:<port>"
#                            so a stale-directory client re-targets
#                            without a second directory round trip
REJECT_REPLAYING = 5       # shard mid-journal-replay (handoff adopt):
#                            typed backoff-retry, linger-covered — a
#                            submission racing an adoption never gets a
#                            silent close or a duplicate JobState

CMD_START = "start"
CMD_RECOVER = "recover"
CMD_PRINT = "print"
CMD_SHUTDOWN = "shutdown"
# "jaxsvc": rank 0 of the XLA engine asks the tracker to host a fresh
# JAX coordination service for the job's world size.  Reply: u32 port
# (0 = tracker cannot host, e.g. no jaxlib).  Hosting the service in
# the long-lived tracker decouples the device-plane coordinator from
# worker lifetimes: ANY worker's death — including rank 0's — is then a
# recoverable peer failure instead of a fatal loss of the coordination
# service.  Previous epochs' services are retained until the tracker
# closes (a degraded member may still be attached to one).
CMD_JAXSVC = "jaxsvc"
# "formbar": the formation barrier.  Each XLA-engine worker posts this
# as its LAST act before the blocking jaxlib group registration; the
# tracker replies u32 1 (proceed) only once every worker of the job has
# posted, and 0 (abort — start degraded) when any task re-registers as
# a mid-job relaunch or the barrier times out.  Needed because a client
# stuck in a doomed registration barrier cannot escape: when a
# co-registrant dies the coordination service's error push fatally
# terminates the blocked clients (jaxlib client.h:80), and the client's
# own init_timeout is routed through the same fatal path rather than
# raising.  So liveness is decided on the control plane BEFORE anyone
# blocks in the device-plane registration.
CMD_FORMBAR = "formbar"
# "heartbeat": the persistent liveness channel.  A worker opens ONE of
# these right after its first rendezvous, sends its period (u32 ms),
# then one u32 beat per period for the life of the process.  The
# tracker's deadline sweep marks a worker dead once
# rabit_heartbeat_miss periods pass without a beat — liveness is
# decided PROACTIVELY on the control plane, so a hung rank is evicted
# (and its supervisor notified) without any collective op having to
# touch it first.  A clean shutdown sends HEARTBEAT_BYE before close;
# EOF without the bye means the process died.
CMD_HEARTBEAT = "heartbeat"
HEARTBEAT_BYE = 0xFFFFFFFF
# Obs-frame sentinel on the heartbeat byte stream (see the module
# docstring): u32 HEARTBEAT_OBS, u32 length, JSON payload.  Never a
# plausible beat number (beats count up from 1) and distinct from the
# BYE sentinel.
HEARTBEAT_OBS = 0xFFFFFFFD
# "rescale": a current member re-registering for an elastic membership
# epoch (doc/fault_tolerance.md "Elastic membership & tracker HA").
# Same payload/reply as start/recover; the round it joins completes at
# the tracker's pending TARGET world (grown by admitted joiners, shrunk
# by heartbeat-detected deaths), ranks are reassigned deterministically
# (surviving members by old rank, then joiners by task_id) and the
# reply's epoch field is bumped.  Members enter this round together at
# a checkpoint-commit boundary (the K_RESCALE consensus bit — see
# engine/robust.py), so no in-flight collective ever spans two worlds.
CMD_RESCALE = "rescale"
# "epoch": one-shot membership poll.  u32 committed_version follows
# (the worker's current checkpoint version — the tracker journals the
# max as the job's committed progress); reply u32 epoch, u32
# target_epoch, u32 target_world.  target_epoch > epoch means a rescale
# is pending and the next commit boundary should re-rendezvous with
# cmd=rescale.  Best-effort on the worker side: an unreachable tracker
# (e.g. restarting) reads as "no change" — polling never stalls
# training.
CMD_EPOCH = "epoch"


class HandshakeError(ValueError):
    """A tracker-port client sent something that is not a worker hello.

    ``parsed_magic`` distinguishes a stray client (bad magic — an HTTP
    probe, a port scanner: log and drop, no reply owed) from a client
    that spoke the magic and then went wrong (oversized length prefix,
    non-utf-8, bad job id: it understands the protocol enough to be
    sent a typed ``REJECT_BAD_HANDSHAKE`` reply)."""

    def __init__(self, msg: str, parsed_magic: bool = False) -> None:
        super().__init__(msg)
        self.parsed_magic = parsed_magic


def valid_job_id(job: str) -> bool:
    """Path-safe single token (job ids name obs/journal directories)."""
    return bool(_JOB_ID_RE.match(job))


def require_valid_job_id(job) -> None:
    """Launcher-side early validation: fail before any worker spawns
    (each worker's own engine check would otherwise burn its restart
    budget on a config typo)."""
    if not valid_job_id(str(job)):
        raise ValueError(
            f"--job {job!r} is not a valid job id "
            "([A-Za-z0-9][A-Za-z0-9._-]{0,63})")


def send_all(sock: socket.socket, data: bytes) -> None:
    sock.sendall(data)


def recv_all(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionResetError("peer closed during recv")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_u32(sock: socket.socket, value: int) -> None:
    send_all(sock, struct.pack("<I", value))


def recv_u32_or_eof(sock: socket.socket) -> int | None:
    """Receive one u32 — or None on a CLEAN EOF at the field boundary
    (zero bytes read).  Optional-trailing-field reads use this to tell
    "the peer's protocol version simply ends here" (old tracker:
    default the field) apart from a genuine mid-field failure (raise —
    the caller must retry, not silently diverge from peers that read
    the full reply)."""
    buf = b""
    while len(buf) < 4:
        chunk = sock.recv(4 - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ConnectionResetError("peer closed mid-field")
        buf += chunk
    return struct.unpack("<I", buf)[0]


def recv_u32(sock: socket.socket) -> int:
    return struct.unpack("<I", recv_all(sock, 4))[0]


def send_str(sock: socket.socket, s: str) -> None:
    raw = s.encode("utf-8")
    send_all(sock, struct.pack("<I", len(raw)) + raw)


def recv_str(sock: socket.socket, max_len: int | None = None) -> str:
    """Receive one length-prefixed string.  ``max_len`` (tracker-side
    handshake reads) turns an absurd length prefix — a stray client's
    bytes misread as a length — into a typed :class:`HandshakeError`
    instead of an unbounded buffering loop."""
    n = recv_u32(sock)
    if max_len is not None and n > max_len:
        raise HandshakeError(
            f"string length {n} exceeds the handshake cap {max_len}",
            parsed_magic=True)
    try:
        return recv_all(sock, n).decode("utf-8")
    except UnicodeDecodeError as e:
        if max_len is None:
            raise
        raise HandshakeError(f"non-utf-8 handshake string: {e}",
                             parsed_magic=True) from e


def send_hello(sock: socket.socket, cmd: str, task_id: str, world: int,
               job: str = DEFAULT_JOB) -> None:
    """The worker→tracker hello every fresh tracker connection opens
    with.  The default job sends the classic MAGIC layout — byte-
    identical to the pre-multi-tenant wire, so it still speaks to old
    trackers; a named job rides the MAGIC_JOB extension."""
    if job == DEFAULT_JOB:
        send_u32(sock, MAGIC)
    else:
        send_u32(sock, MAGIC_JOB)
        send_str(sock, job)
    send_str(sock, cmd)
    send_str(sock, task_id)
    send_u32(sock, world)


def recv_hello(sock: socket.socket) -> tuple[str, str, str, int]:
    """Tracker-side hardened hello parse: ``(job, cmd, task_id,
    world)``.  Raises :class:`HandshakeError` — with ``parsed_magic``
    False for a stray client (drop silently) and True once the magic
    checked out (a typed reject reply is appropriate)."""
    magic = recv_u32(sock)
    if magic == MAGIC:
        job = DEFAULT_JOB
    elif magic == MAGIC_JOB:
        job = recv_str(sock, max_len=MAX_HELLO_STR)
        if not valid_job_id(job):
            raise HandshakeError(f"invalid job id {job!r}",
                                 parsed_magic=True)
    else:
        raise HandshakeError(f"bad magic 0x{magic:08x}")
    cmd = recv_str(sock, max_len=MAX_HELLO_STR)
    task_id = recv_str(sock, max_len=MAX_HELLO_STR)
    world = recv_u32(sock)
    return job, cmd, task_id, world


@dataclass
class RejectReply:
    """Typed refusal in place of a topology reply (admission control /
    malformed handshake).  On the wire: u32 REJECT, u32 code, str
    reason."""

    code: int
    reason: str = ""

    def send(self, sock: socket.socket) -> None:
        send_u32(sock, REJECT)
        send_u32(sock, self.code)
        send_str(sock, self.reason)

    @classmethod
    def recv_tail(cls, sock: socket.socket) -> "RejectReply":
        """Read the frame after the caller consumed the REJECT u32."""
        code = recv_u32(sock)
        reason = recv_str(sock, max_len=MAX_HELLO_STR)
        return cls(code, reason)


def shard_moved_reason(generation: int, shard: int, host: str,
                       port: int) -> str:
    """The REJECT_SHARD_MOVED reason payload: enough for the rejected
    client to re-target the owning shard without another directory
    round trip (and to drop a stale cached ring older than ``gen``)."""
    return f"gen={int(generation)};shard={int(shard)};" \
           f"endpoint={host}:{int(port)}"


def parse_shard_moved(reason: str) -> tuple[int, int, str, int] | None:
    """Parse a :func:`shard_moved_reason` string into ``(generation,
    shard, host, port)``; None when the reason does not carry a
    redirect (an old or third-party tracker — the client then falls
    back to a full directory refresh)."""
    fields: dict[str, str] = {}
    for part in str(reason).split(";"):
        k, sep, v = part.partition("=")
        if sep:
            fields[k.strip()] = v.strip()
    ep = fields.get("endpoint", "")
    host, sep, port_s = ep.rpartition(":")
    if not ("gen" in fields and sep and host):
        return None
    try:
        return (int(fields["gen"]), int(fields.get("shard", -1)),
                host, int(port_s))
    except ValueError:
        return None


@dataclass
class TopologyReply:
    """What the tracker tells each worker at rendezvous."""

    rank: int
    world: int
    parent: int                      # NONE if root
    neighbors: list[int] = field(default_factory=list)
    ring_prev: int = NONE
    ring_next: int = NONE
    connect: list[tuple[int, str, int]] = field(default_factory=list)
    naccept: int = 0
    relaunched: int = 0
    epoch: int = 0
    groups: list[int] = field(default_factory=list)
    sched: str = ""                  # live schedule directive ("" = none)
    demoted: list[int] = field(default_factory=list)

    def send(self, sock: socket.socket) -> None:
        send_u32(sock, self.rank)
        send_u32(sock, self.world)
        send_u32(sock, self.parent)
        send_u32(sock, len(self.neighbors))
        for r in self.neighbors:
            send_u32(sock, r)
        send_u32(sock, self.ring_prev)
        send_u32(sock, self.ring_next)
        send_u32(sock, len(self.connect))
        for r, host, port in self.connect:
            send_u32(sock, r)
            send_str(sock, host)
            send_u32(sock, port)
        send_u32(sock, self.naccept)
        send_u32(sock, self.relaunched)
        send_u32(sock, self.epoch)
        send_u32(sock, len(self.groups))
        for g in self.groups:
            send_u32(sock, g)
        send_str(sock, self.sched)
        send_u32(sock, len(self.demoted))
        for r in self.demoted:
            send_u32(sock, r)

    @classmethod
    def recv(cls, sock: socket.socket) -> "TopologyReply":
        return cls._recv_tail(sock, recv_u32(sock))

    @classmethod
    def recv_or_reject(cls, sock: socket.socket
                       ) -> "TopologyReply | RejectReply":
        """Registration reply dispatch: the REJECT sentinel in the rank
        slot means an admission/handshake refusal frame follows."""
        first = recv_u32(sock)
        if first == REJECT:
            return RejectReply.recv_tail(sock)
        return cls._recv_tail(sock, first)

    @classmethod
    def _recv_tail(cls, sock: socket.socket, rank: int) -> "TopologyReply":
        world = recv_u32(sock)
        parent = recv_u32(sock)
        neighbors = [recv_u32(sock) for _ in range(recv_u32(sock))]
        ring_prev = recv_u32(sock)
        ring_next = recv_u32(sock)
        connect = []
        for _ in range(recv_u32(sock)):
            r = recv_u32(sock)
            host = recv_str(sock)
            port = recv_u32(sock)
            connect.append((r, host, port))
        naccept = recv_u32(sock)
        relaunched = recv_u32(sock)
        epoch = recv_u32(sock)
        groups = [recv_u32(sock) for _ in range(recv_u32(sock))]
        # Adaptive-controller trailing fields: a pre-adaptive tracker
        # sends nothing past groups and closes the one-shot socket —
        # a CLEAN EOF exactly at this boundary means "old layout",
        # default the fields.  Anything else (reset mid-field, timeout,
        # garbage length) RAISES like any other truncated reply, so the
        # registration retries instead of one rank silently running
        # without the directive its peers adopted (schedule choice is
        # a collective decision).
        sched, demoted = "", []
        n = recv_u32_or_eof(sock)
        if n is not None:
            if n > MAX_HELLO_STR:
                raise HandshakeError(
                    f"sched directive length {n} exceeds the cap",
                    parsed_magic=True)
            sched = recv_all(sock, n).decode("utf-8")
            demoted = [recv_u32(sock) for _ in range(recv_u32(sock))]
        return cls(rank, world, parent, neighbors, ring_prev, ring_next,
                   connect, naccept, relaunched, epoch, groups,
                   sched, demoted)
