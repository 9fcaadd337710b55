"""rabit_tpu_torch.transport — worker-worker link transports.

PyTorch-port counterpart of :mod:`rabit_tpu.transport`, exporting only
what is ported: the :class:`Link` interface, the classic TCP link
(``tcp.py``, byte-identical wire), link-level integrity framing
(``framing.py``) and the negotiating link factory (``factory.py``, TCP
path).  The reference's shared-memory rings (``shm.py``) and progress
pumps (``pump.py``) wait for ROADMAP A8 and A2/A3.

Engine knobs (doc/parameters.md "Transports"): ``rabit_transport``
(tcp; shm/auto raise here), ``rabit_wire_integrity``
(off/crc32/crc32c).  Off by default: the default-config wire is
byte-identical to pre-transport releases, and every feature is
negotiated per link so mixed-config worlds degrade to the common
subset instead of diverging.
"""
from __future__ import annotations

from rabit_tpu_torch.transport.base import (FRAME_MAX, INTEGRITY_MODES,
                                            TRANSPORT_MODES, Events,
                                            IntegrityError, Link, LinkError,
                                            NULL_EVENTS, TransportConfig,
                                            setup_stream_socket)
from rabit_tpu_torch.transport.factory import XMAGIC, LinkFactory
from rabit_tpu_torch.transport.framing import FrameDecoder, encode_frames
from rabit_tpu_torch.transport.tcp import TcpLink

__all__ = [
    "Link", "LinkError", "IntegrityError", "TransportConfig", "Events",
    "NULL_EVENTS", "LinkFactory", "TcpLink", "FrameDecoder",
    "encode_frames", "setup_stream_socket", "XMAGIC", "FRAME_MAX",
    "INTEGRITY_MODES", "TRANSPORT_MODES",
]
