"""The port's ``TcpLink`` against rabit_tpu's, plain and framed: one end of
each connected pair is a link of one package and the other end a link
of the other (or of the port again), in both directions, blocking and
in pump mode; the wire bytes and the errors of a closed peer match."""
import select
import socket
import threading

import numpy as np
import pytest

from rabit_tpu.transport import base as jbase
from rabit_tpu.transport import tcp as jtcp
from rabit_tpu_torch.transport import base as tbase
from rabit_tpu_torch.transport import tcp as ttcp

LINKS = {"jax": jtcp.TcpLink, "torch": ttcp.TcpLink}
ERRORS = {"jax": jbase.LinkError, "torch": tbase.LinkError}
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
TIMEOUT = 10.0


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


def _payloads(seed):
    rng = np.random.default_rng(seed)
    sizes = (1000, 300_000, 0, 17, tbase.FRAME_MAX + 3)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def _run(fn):
    """Run ``fn`` on a thread; return a join() that re-raises its error."""
    errors = []

    def body():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by join
            errors.append(e)

    t = threading.Thread(target=body)
    t.start()

    def join():
        t.join(TIMEOUT)
        assert not t.is_alive(), "link thread did not finish"
        if errors:
            raise errors[0]
    return join


@pytest.mark.parametrize("framed", [False, True], ids=["plain", "framed"])
@pytest.mark.parametrize("sender,receiver", PAIRS,
                         ids=[f"{s}-to-{r}" for s, r in PAIRS])
def test_blocking_sendall_sendv_recv_exact(sender, receiver, framed):
    a, b = tcp_pair()
    tx = LINKS[sender](a, peer=1, timeout=TIMEOUT, frames=framed)
    rx = LINKS[receiver](b, peer=0, timeout=TIMEOUT, frames=framed)
    p = _payloads(1)
    try:
        def send():
            tx.sendall(p[0])
            tx.sendv([p[1], p[2], memoryview(p[3])])
            tx.sendall(np.frombuffer(p[4], dtype=np.uint8))
        join = _run(send)
        first = rx.recv_exact(len(p[0]))
        into = memoryview(bytearray(sum(map(len, p[1:]))))
        rest = rx.recv_exact(len(into), into=into)
        join()
        assert bytes(first) == p[0]
        assert rest is into and bytes(rest) == b"".join(p[1:])
        assert tx.healthy() and rx.healthy()
    finally:
        tx.close()
        rx.close()


def _wait(link, write):
    r, w = ([], [link]) if write else ([link], [])
    select.select(r, w, [], 1.0)


@pytest.mark.parametrize("framed", [False, True], ids=["plain", "framed"])
@pytest.mark.parametrize("sender,receiver", PAIRS,
                         ids=[f"{s}-to-{r}" for s, r in PAIRS])
def test_pump_poll_sendv_poll_recv(sender, receiver, framed):
    a, b = tcp_pair()
    tx = LINKS[sender](a, peer=1, timeout=TIMEOUT, frames=framed)
    rx = LINKS[receiver](b, peer=0, timeout=TIMEOUT, frames=framed)
    p = _payloads(2)
    want = b"".join(p)
    try:
        def send():
            tx.pump_begin()
            bufs = [memoryview(x) for x in p if x]
            while bufs or tx.tx_pending():
                if not tx.poll_sendv(bufs):
                    _wait(tx, write=True)
            tx.pump_end()
        join = _run(send)
        rx.pump_begin()
        got = bytearray(len(want))
        mv = memoryview(got)
        n = 0
        while n < len(want):
            k = rx.poll_recv(mv[n:])
            n += k
            if not k and not rx.rx_pending():
                _wait(rx, write=False)
        rx.pump_end()
        join()
        assert bytes(got) == want
        assert not rx.rx_pending() and not tx.tx_pending()
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("framed", [False, True], ids=["plain", "framed"])
def test_wire_bytes_match(framed):
    """The same calls put the same bytes on the wire in both packages."""
    p = _payloads(3)
    wires = {}
    for name, cls in LINKS.items():
        a, b = tcp_pair()
        link = cls(a, peer=1, timeout=TIMEOUT, frames=framed)
        chunks = []

        def drain(b=b, chunks=chunks):
            while True:
                chunk = b.recv(1 << 16)
                if not chunk:
                    return
                chunks.append(chunk)
        join = _run(drain)
        link.sendall(p[0])
        link.sendv(p[1:4])
        link.sendall(p[4])
        link.close()
        join()
        b.close()
        wires[name] = b"".join(chunks)
    assert wires["jax"] == wires["torch"]
    if framed:
        # 8 bytes a frame; a write call frames its bytes alone
        writes = (len(p[0]), sum(map(len, p[1:4])), len(p[4]))
        nframes = sum(-(-n // tbase.FRAME_MAX) for n in writes)
        assert len(wires["torch"]) == sum(map(len, p)) + 8 * nframes
    else:
        assert wires["torch"] == b"".join(p)


@pytest.mark.parametrize("framed", [False, True], ids=["plain", "framed"])
@pytest.mark.parametrize("mode", ["blocking", "pump"])
def test_closed_peer_raises_link_error(mode, framed):
    """A peer that closes mid-stream: the read raises the package's
    LinkError, attributed to the link, with the same words in both."""
    messages = {}
    for pkg, cls in LINKS.items():
        a, b = tcp_pair()
        link = cls(b, peer=5, timeout=TIMEOUT, frames=framed)
        peer = cls(a, peer=6, timeout=TIMEOUT, frames=framed)
        peer.sendall(b"abc")
        peer.close()
        with pytest.raises(ERRORS[pkg]) as info:
            if mode == "blocking":
                link.recv_exact(8)
            else:
                link.pump_begin()
                buf = memoryview(bytearray(8))
                for _ in range(100):
                    if not link.poll_recv(buf) and not link.rx_pending():
                        _wait(link, write=False)
        assert info.value.link is link and not link.healthy()
        assert isinstance(info.value, ConnectionError)
        messages[pkg] = str(info.value)
        link.close()
    assert messages["jax"] == messages["torch"]
    assert messages["torch"].endswith("rank 5 closed the link")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_send_to_closed_peer_raises_link_error(pkg):
    a, b = tcp_pair()
    b.close()
    link = LINKS[pkg](a, peer=2, timeout=TIMEOUT)
    with pytest.raises(ERRORS[pkg]) as info:
        for _ in range(64):
            link.sendall(bytes(1 << 16))
    assert info.value.link is link and not link.healthy()
    assert str(info.value).startswith("send to rank 2 failed")
    link.close()
