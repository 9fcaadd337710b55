"""rabit_tpu_torch.transport — worker-worker link transports.

PyTorch-port counterpart of :mod:`rabit_tpu.transport`: the
:class:`Link` interface, the classic TCP link (``tcp.py``,
byte-identical wire), same-host shared-memory rings (``shm.py``, the
reference's ring layout byte for byte), link-level integrity framing
(``framing.py``), the negotiating link factory with its shm→tcp
failover bookkeeping (``factory.py``) and the multi-link progress pumps
the engine's schedules run on (``pump.py``: ``exchange``, ``recv_all``,
``HopPipeline``).

Engine knobs (doc/parameters.md "Transports"): ``rabit_transport``
(tcp/shm/auto), ``rabit_wire_integrity`` (off/crc32/crc32c),
``rabit_shm_ring_bytes``, ``rabit_transport_failover``,
``rabit_shm_retries`` and ``rabit_shm_dir``.  Off by default: the
default-config wire is byte-identical to pre-transport releases, and
every feature is negotiated per link so mixed-config worlds degrade to
the common subset instead of diverging.
"""
from __future__ import annotations

from rabit_tpu_torch.transport.base import (FRAME_MAX, INTEGRITY_MODES,
                                            SHM_RING_MIN, TRANSPORT_MODES,
                                            CountingEvents, Events,
                                            IntegrityError, Link, LinkError,
                                            NULL_EVENTS, TransportConfig,
                                            setup_stream_socket)
from rabit_tpu_torch.transport.factory import XMAGIC, LinkFactory
from rabit_tpu_torch.transport.framing import FrameDecoder, encode_frames
from rabit_tpu_torch.transport.pump import HopPipeline, exchange, recv_all
from rabit_tpu_torch.transport.shm import ShmLink, ShmRing
from rabit_tpu_torch.transport.tcp import TcpLink

__all__ = [
    "Link", "LinkError", "IntegrityError", "TransportConfig", "Events",
    "CountingEvents", "NULL_EVENTS", "LinkFactory", "TcpLink", "ShmLink",
    "ShmRing", "FrameDecoder", "encode_frames", "setup_stream_socket",
    "XMAGIC", "FRAME_MAX", "INTEGRITY_MODES", "TRANSPORT_MODES",
    "SHM_RING_MIN", "HopPipeline", "exchange", "recv_all",
]
