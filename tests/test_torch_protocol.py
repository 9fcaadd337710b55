"""The port's worker<->tracker wire protocol against rabit_tpu's, byte for
byte: every message is captured from a socketpair, the two packages must
write the same bytes, and each package decodes the other's."""
import dataclasses
import socket

import pytest

from rabit_tpu.tracker import protocol as JP
from rabit_tpu_torch.tracker import protocol as TP

PACKAGES = {"jax": JP, "torch": TP}


def wire(write) -> bytes:
    """The bytes ``write(sock)`` puts on a socket (one end of a pair)."""
    a, b = socket.socketpair()
    try:
        write(a)
        a.close()
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


def read(raw: bytes, parse):
    """``parse(sock)`` over a socket whose peer wrote ``raw`` and closed."""
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.close()
        b.settimeout(5)
        return parse(b)
    finally:
        a.close()
        b.close()


def same_bytes(write_with) -> bytes:
    """Run ``write_with(P, sock)`` for both packages; return the bytes
    after checking that they agree."""
    got = {name: wire(lambda s, P=P: write_with(P, s))
           for name, P in PACKAGES.items()}
    assert got["jax"] == got["torch"]
    return got["torch"]


def test_constants_match():
    for name in ("MAGIC", "MAGIC_JOB", "NONE", "DEFAULT_JOB",
                 "MAX_HELLO_STR", "MAX_PRINT_LEN", "REJECT",
                 "REJECT_BAD_HANDSHAKE", "REJECT_MAX_JOBS",
                 "REJECT_MAX_WORKERS", "REJECT_SHARD_MOVED",
                 "REJECT_REPLAYING", "CMD_START", "CMD_RECOVER", "CMD_PRINT",
                 "CMD_SHUTDOWN", "CMD_JAXSVC", "CMD_FORMBAR", "CMD_HEARTBEAT",
                 "HEARTBEAT_BYE", "HEARTBEAT_OBS", "CMD_RESCALE",
                 "CMD_EPOCH"):
        assert getattr(TP, name) == getattr(JP, name), name


@pytest.mark.parametrize("value", [0, 1, 0x7AB17901, 0xFFFFFFFE, 0xFFFFFFFF])
def test_u32_bytes_and_cross_decode(value):
    raw = same_bytes(lambda P, s: P.send_u32(s, value))
    assert len(raw) == 4
    for P in PACKAGES.values():
        assert read(raw, P.recv_u32) == value
        assert read(raw, P.recv_u32_or_eof) == value
    # a clean EOF at the field boundary is "absent", a torn field raises
    for P in PACKAGES.values():
        assert read(b"", P.recv_u32_or_eof) is None
        with pytest.raises(ConnectionResetError):
            read(raw[:2], P.recv_u32_or_eof)


@pytest.mark.parametrize("text", ["", "a", "héllo wörld ✓", "x" * 1024,
                                  "y" * 5000])
def test_str_bytes_and_cross_decode(text):
    raw = same_bytes(lambda P, s: P.send_str(s, text))
    assert len(raw) == 4 + len(text.encode("utf-8"))
    for P in PACKAGES.values():
        assert read(raw, P.recv_str) == text


@pytest.mark.parametrize("cmd,task_id,world,job", [
    ("start", "0", 4, "default"),
    ("recover", "worker-17", 0, "default"),
    ("print", "t", 2, "jobA"),
    ("shutdown", "x" * 200, 0xFFFF, "a.b-c_9"),
])
def test_hello_bytes_and_cross_decode(cmd, task_id, world, job):
    raw = same_bytes(lambda P, s: P.send_hello(s, cmd, task_id, world,
                                               job=job))
    magic = JP.MAGIC if job == JP.DEFAULT_JOB else JP.MAGIC_JOB
    assert raw[:4] == magic.to_bytes(4, "little")
    for P in PACKAGES.values():
        assert read(raw, P.recv_hello) == (job, cmd, task_id, world)


def _bad_hello(case: str) -> bytes:
    def write(s):
        if case == "bad_magic":
            JP.send_u32(s, 0x47455420)          # "GET " of an HTTP probe
            JP.send_str(s, "start")
        elif case == "long_cmd":
            JP.send_u32(s, JP.MAGIC)
            JP.send_u32(s, JP.MAX_HELLO_STR + 1)
        elif case == "long_job":
            JP.send_u32(s, JP.MAGIC_JOB)
            JP.send_u32(s, 1 << 30)
        elif case == "bad_job":
            JP.send_u32(s, JP.MAGIC_JOB)
            JP.send_str(s, "../etc")
        elif case == "non_utf8":
            JP.send_u32(s, JP.MAGIC)
            JP.send_u32(s, 2)
            s.sendall(b"\xff\xfe")
    return wire(write)


@pytest.mark.parametrize("case,parsed_magic", [
    ("bad_magic", False), ("long_cmd", True), ("long_job", True),
    ("bad_job", True), ("non_utf8", True)])
def test_malformed_hello_raises_the_same_handshake_error(case, parsed_magic):
    raw = _bad_hello(case)
    errors = {}
    for name, P in PACKAGES.items():
        with pytest.raises(P.HandshakeError) as info:
            read(raw, P.recv_hello)
        assert isinstance(info.value, ValueError)
        errors[name] = info.value
    assert errors["jax"].parsed_magic == errors["torch"].parsed_magic \
        == parsed_magic
    assert str(errors["jax"]) == str(errors["torch"])


@pytest.mark.parametrize("code", [TP.REJECT_BAD_HANDSHAKE, TP.REJECT_MAX_JOBS,
                                  TP.REJECT_MAX_WORKERS,
                                  TP.REJECT_SHARD_MOVED, TP.REJECT_REPLAYING])
def test_reject_reply_bytes_and_cross_decode(code):
    reason = ("" if code == TP.REJECT_BAD_HANDSHAKE
              else TP.shard_moved_reason(3, 1, "10.0.0.2", 9091)
              if code == TP.REJECT_SHARD_MOVED else f"refused with {code}")
    raw = same_bytes(lambda P, s: P.RejectReply(code, reason).send(s))
    for P in PACKAGES.values():
        got = read(raw, P.TopologyReply.recv_or_reject)
        assert type(got).__name__ == "RejectReply"
        assert (got.code, got.reason) == (code, reason)


_REPLIES = {
    "world1": dict(rank=0, world=1, parent=TP.NONE, neighbors=[],
                   ring_prev=0, ring_next=0, connect=[], naccept=0,
                   groups=[0]),
    "empty_connect": dict(rank=0, world=4, parent=TP.NONE, neighbors=[1, 2],
                          ring_prev=3, ring_next=1, connect=[], naccept=3,
                          groups=[0, 0, 1, 1]),
    "full": dict(rank=5, world=8, parent=2, neighbors=[2], ring_prev=4,
                 ring_next=6,
                 connect=[(1, "10.0.0.1", 9000), (2, "host-b", 65535),
                          (4, "", 1)],
                 naccept=2, relaunched=1, epoch=7,
                 groups=[0, 0, 1, 1, 2, 2, 3, 3],
                 sched="4096:ring,1048576:halving/int8", demoted=[3, 6]),
    "wide": dict(rank=31, world=33, parent=15, neighbors=[15, 32],
                 ring_prev=30, ring_next=32,
                 connect=[(r, f"h{r % 3}", 40000 + r) for r in range(31)],
                 naccept=1, groups=list(range(33)), sched="", demoted=[]),
}


@pytest.mark.parametrize("case", sorted(_REPLIES))
def test_topology_reply_bytes_and_cross_decode(case):
    fields = _REPLIES[case]
    raw = same_bytes(lambda P, s: P.TopologyReply(**fields).send(s))
    want = dataclasses.asdict(TP.TopologyReply(**fields))
    for P in PACKAGES.values():
        for parse in (P.TopologyReply.recv, P.TopologyReply.recv_or_reject):
            got = read(raw, parse)
            assert type(got).__name__ == "TopologyReply"
            assert dataclasses.asdict(got) == want


def test_topology_reply_old_layout_ends_after_groups():
    """A pre-adaptive tracker closes after ``groups``: both readers default
    the trailing fields; a torn trailing field raises in both."""
    fields = dict(_REPLIES["full"], sched="", demoted=[])
    raw = wire(lambda s: JP.TopologyReply(**fields).send(s))
    old = raw[:-8]                      # no sched length, no ndemoted
    for P in PACKAGES.values():
        got = read(old, P.TopologyReply.recv)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            TP.TopologyReply(**fields))
        with pytest.raises(ConnectionResetError):
            read(old + b"\x00\x00", P.TopologyReply.recv)


def test_topology_reply_oversized_directive_raises_in_both():
    fields = dict(_REPLIES["empty_connect"], sched="")
    raw = wire(lambda s: JP.TopologyReply(**fields).send(s))[:-8]
    raw += (JP.MAX_HELLO_STR + 1).to_bytes(4, "little")
    for P in PACKAGES.values():
        with pytest.raises(P.HandshakeError) as info:
            read(raw, P.TopologyReply.recv)
        assert info.value.parsed_magic


@pytest.mark.parametrize("reason", [
    TP.shard_moved_reason(2, 5, "127.0.0.1", 4242),
    "gen=9;shard=1;endpoint=[::1]:80", "gen=x;endpoint=h:1",
    "no redirect here", "gen=4;endpoint=:7"])
def test_shard_moved_helpers_match(reason):
    assert TP.parse_shard_moved(reason) == JP.parse_shard_moved(reason)


def test_job_ids_match():
    for job in ("default", "a", "A.b-c_9", "x" * 64, "x" * 65, ".hidden",
                "-lead", "with space", "", "ü", "a/b"):
        assert TP.valid_job_id(job) == JP.valid_job_id(job), job
        if not JP.valid_job_id(job):
            with pytest.raises(ValueError):
                TP.require_valid_job_id(job)
