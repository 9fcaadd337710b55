"""The port's link handshake (``LinkFactory``, TCP path) against
rabit_tpu's: the classic hello, the feature hello and its negotiation,
byte for byte, over loopback pairs in two threads — port with port,
and port with reference in both directions."""
import socket
import threading

import numpy as np
import pytest

from rabit_tpu.tracker import protocol as JP
from rabit_tpu.transport import base as jbase
from rabit_tpu.transport import factory as jfactory
from rabit_tpu_torch.transport import base as tbase
from rabit_tpu_torch.transport import factory as tfactory
from rabit_tpu_torch.utils import RabitError

PKGS = {"jax": (jbase, jfactory), "torch": (tbase, tfactory)}
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
TIMEOUT = 10.0


class _Log:
    def __init__(self):
        self.warnings = []

    def warn(self, fmt, *args):
        self.warnings.append(fmt % args)

    def info(self, fmt, *args):
        pass


def tcp_pair():
    """Two ends of one loopback TCP connection (a listener on port 0,
    closed once the connection is accepted)."""
    with socket.socket() as lst:
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        a = socket.create_connection(lst.getsockname(), timeout=TIMEOUT)
        b, _ = lst.accept()
    b.settimeout(TIMEOUT)
    return a, b


def factory(pkg, rank, log=None, groups=(), **cfg):
    """A link factory of either package as rank ``rank``; the reference's
    also takes a logger and its host groups (the port's logs to stderr
    and has no use for groups without shm)."""
    if pkg == "torch":
        return tfactory.LinkFactory(tbase.TransportConfig(**cfg), rank,
                                    timeout=TIMEOUT)
    f = jfactory.LinkFactory(jbase.TransportConfig(**cfg), timeout=TIMEOUT,
                             log=log)
    f.set_topology(rank, list(groups))
    return f


def handshake(dialer, acceptor):
    """Dial on one thread, accept on another; returns (dialed, accepted,
    peer rank the acceptor read)."""
    a, b = tcp_pair()
    out, errors = {}, []

    def run(key, fn):
        try:
            out[key] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=("dial", lambda: dialer.dial(
                   a, peer=acceptor.rank))),
               threading.Thread(target=run, args=("accept", lambda:
                                                  acceptor.accept(b)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive(), "handshake thread did not finish"
    if errors:
        raise errors[0]
    accepted, peer = out["accept"]
    return out["dial"], accepted, peer


def exchange(x, y):
    """Bytes both ways over two linked ends; both arrive intact."""
    rng = np.random.default_rng(5)
    p = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    q = rng.integers(0, 256, 333, dtype=np.uint8).tobytes()
    done = []
    t = threading.Thread(target=lambda: (x.sendall(p),
                                         done.append(bytes(x.recv_exact(
                                             len(q))))))
    t.start()
    got = bytes(y.recv_exact(len(p)))
    y.sendv([q[:100], q[100:]])
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert got == p and done == [q]


# (dialer integrity, acceptor integrity, framed?) — the reference's
# test_negotiation_degrades_to_common_subset cases without its engines,
# plus the two offers that name different modes
CASES = [("off", "off", False), ("crc32c", "crc32c", True),
         ("crc32", "crc32", True), ("crc32c", "off", False),
         ("off", "crc32c", False), ("crc32", "crc32c", False)]


@pytest.mark.parametrize("dial_cfg,acc_cfg,framed", CASES,
                         ids=[f"{a}-{b}" for a, b, _ in CASES])
@pytest.mark.parametrize("dial_pkg,acc_pkg", PAIRS,
                         ids=[f"{a}-dials-{b}" for a, b in PAIRS])
def test_negotiation(dial_pkg, acc_pkg, dial_cfg, acc_cfg, framed, capsys):
    logs = (_Log(), _Log())
    dialer = factory(dial_pkg, 0, logs[0], integrity=dial_cfg)
    acceptor = factory(acc_pkg, 1, logs[1], integrity=acc_cfg)
    x, y, peer = handshake(dialer, acceptor)
    try:
        assert peer == 0 and x.peer == 1 and y.peer == 0
        for link in (x, y):
            assert link.kind == "tcp" and link._frames == framed
        exchange(x, y)
        # a mode mismatch is logged once on each end: the reference's
        # through its logger, the port's on stderr
        mismatch = "off" not in (dial_cfg, acc_cfg) and dial_cfg != acc_cfg
        warned = capsys.readouterr().err.count("integrity mode mismatch")
        assert [len(lg.warnings) for lg in logs] == [
            int(mismatch and pkg == "jax") for pkg in (dial_pkg, acc_pkg)]
        assert warned == int(mismatch) * (dial_pkg, acc_pkg).count("torch")
    finally:
        x.close()
        y.close()


def _read_hello(sock):
    """The dialer's hello, read by hand: classic or feature."""
    head = JP.recv_all(sock, 8)
    if int.from_bytes(head[:4], "little") == jfactory.XMAGIC:
        n = JP.recv_all(sock, 4)
        return head + n + JP.recv_all(sock, int.from_bytes(n, "little"))
    return head


@pytest.mark.parametrize("integrity", ["off", "crc32", "crc32c"])
def test_dial_and_accept_bytes_match(integrity):
    """Each package's dialer writes the same hello, and its acceptor the
    same answer, for the same configuration."""
    hellos, answers = {}, {}
    for pkg in PKGS:
        f = factory(pkg, 3, integrity=integrity)
        a, b = tcp_pair()
        out = []
        t = threading.Thread(target=lambda: out.append(f.dial(a, peer=4)))
        t.start()
        hellos[pkg] = _read_hello(b)
        # answer as rank 4 with the same configuration
        b.sendall(hellos[pkg].replace((3).to_bytes(4, "little"),
                                      (4).to_bytes(4, "little"), 1))
        t.join(TIMEOUT)
        assert not t.is_alive() and out[0].peer == 4
        out[0].close()
        b.close()
        # the acceptor's answer to that hello
        a, b = tcp_pair()
        out = []
        f = factory(pkg, 4, integrity=integrity)
        t = threading.Thread(target=lambda: out.append(f.accept(b)))
        t.start()
        a.sendall(hellos[pkg])
        answers[pkg] = _read_hello(a)
        t.join(TIMEOUT)
        assert not t.is_alive() and out[0][1] == 3
        out[0][0].close()
        a.close()
    assert hellos["jax"] == hellos["torch"]
    assert answers["jax"] == answers["torch"]
    magic = JP.MAGIC if integrity == "off" else jfactory.XMAGIC
    assert hellos["torch"][:8] == (magic.to_bytes(4, "little")
                                   + (3).to_bytes(4, "little"))


@pytest.mark.parametrize("ref_side", ["dialer", "acceptor"])
def test_reference_shm_offer_gets_tcp(ref_side):
    """A reference peer configured for shm in the same host group offers
    ``shm:<bytes>``; the port never offers it, so the intersection is the
    integrity mode alone and both ends build a framed TCP link."""
    ref = factory("jax", 0 if ref_side == "dialer" else 1, groups=[0, 0],
                  transport="shm", integrity="crc32c")
    port = factory("torch", 1 if ref_side == "dialer" else 0,
                   integrity="crc32c")
    assert "shm" in ref._offer(port.rank)
    pair = (ref, port) if ref_side == "dialer" else (port, ref)
    x, y, _ = handshake(*pair)
    try:
        for link in (x, y):
            assert type(link).__name__ == "TcpLink" and link._frames
        exchange(x, y)
    finally:
        x.close()
        y.close()


@pytest.mark.parametrize("transport", ["shm", "auto"])
def test_shm_config_raises_in_the_port(transport):
    jbase.TransportConfig(transport=transport)      # the reference takes it
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tbase.TransportConfig(transport=transport)
    with pytest.raises(RabitError, match="rabit_transport must be one of"):
        tbase.TransportConfig(transport="rdma")
    assert tbase.TransportConfig().transport == "tcp"


def test_bad_link_magic_fails_the_handshake():
    acceptor = factory("torch", 1)
    a, b = tcp_pair()
    a.sendall((0xDEADBEEF).to_bytes(4, "little"))
    with pytest.raises(RabitError, match="link handshake: bad magic"):
        acceptor.accept(b)
    a.close()
    b.close()
