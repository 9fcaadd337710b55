"""Network helpers for the engine.

PyTorch-port counterpart of :mod:`rabit_tpu.utils.net`, so far only
:func:`routable_ip`, which the pysocket engine calls to advertise its
link listener.  ``free_port`` comes with the launcher that needs it
(ROADMAP A8).
"""
from __future__ import annotations

import socket


def routable_ip(target: tuple[str, int]) -> str:
    """The local interface address peers can reach this process on.

    Loopback targets stay loopback; otherwise the UDP-connect trick picks
    the interface that routes toward ``target`` (no packet is sent).
    ``gethostbyname(gethostname())`` is the last resort — it returns
    127.0.1.1 on stock Debian hosts, which peers cannot reach.  The
    reference also accepts no target (then it probes a public address);
    the engine always passes its tracker's, so the port requires one.
    """
    if target[0] in ("127.0.0.1", "localhost"):
        return "127.0.0.1"
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        probe.connect(target)
        return probe.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        probe.close()
