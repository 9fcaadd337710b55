"""The port's integrity framing against rabit_tpu's: ``encode_frames``,
``frame_crc`` and ``FrameDecoder`` give the same bytes and the same
errors, and each package's decoder reads the other's frames."""
import struct

import numpy as np
import pytest

from rabit_tpu.transport import base as jbase
from rabit_tpu.transport import framing as jframing
from rabit_tpu_torch.transport import base as tbase
from rabit_tpu_torch.transport import framing as tframing

FRAME_MAX = tbase.FRAME_MAX
PACKAGES = {"jax": jframing, "torch": tframing}
ERRORS = {"jax": jbase.IntegrityError, "torch": tbase.IntegrityError}


class _Counters:
    def __init__(self):
        self.counts = {}
        self.events = []

    def counter(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def event(self, name, **fields):
        self.events.append((name, fields))


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _encode(F, bufs, **kw):
    parts = F.encode_frames([memoryview(b) for b in bufs], **kw)
    return [bytes(p) for p in parts]


def _decode(F, raw, step=None, **kw):
    dec = F.FrameDecoder(peer=1, **kw)
    out = bytearray()
    buf = bytearray(1 << 16)
    step = step or max(len(raw), 1)
    for i in range(0, len(raw), step):
        dec.feed(raw[i:i + step])
        while True:
            n = dec.take(memoryview(buf))
            if not n:
                break
            out += buf[:n]
    assert not dec.pending()
    return bytes(out)


def test_constants_match():
    assert tbase.FRAME_MAX == jbase.FRAME_MAX
    assert tbase.SENDMSG_MAX_PARTS == jbase.SENDMSG_MAX_PARTS
    assert tbase.INTEGRITY_MODES == jbase.INTEGRITY_MODES
    for name in ("HDR_FMT", "HDR_BYTES", "CRC_BYTES"):
        assert getattr(tframing, name) == getattr(jframing, name)


@pytest.mark.parametrize("size", [0, 1, 4095, 4096, 4097, FRAME_MAX - 1,
                                  FRAME_MAX, FRAME_MAX + 1,
                                  3 * FRAME_MAX + 5])
def test_frames_match_at_size(size):
    data = _payload(size, size)
    parts = {name: _encode(F, [data]) for name, F in PACKAGES.items()}
    assert parts["jax"] == parts["torch"]
    raw = b"".join(parts["torch"])
    nframes = -(-size // FRAME_MAX)
    assert len(raw) == size + 8 * nframes
    assert tframing.frame_crc(data) == jframing.frame_crc(data)
    for F in PACKAGES.values():
        assert _decode(F, raw) == data
        assert _decode(F, raw, step=65536) == data


@pytest.mark.parametrize("sizes,frame_max", [
    ((1, 0, 4096, 7), FRAME_MAX),
    ((FRAME_MAX - 3, 10, FRAME_MAX + 2), FRAME_MAX),
    ((999, 1, 1000, 2500, 0, 3), 1000),
    ((5,) * 40, 16),
])
def test_frames_match_over_several_buffers(sizes, frame_max):
    bufs = [_payload(n, i) for i, n in enumerate(sizes)]
    parts = {name: _encode(F, bufs, frame_max=frame_max)
             for name, F in PACKAGES.items()}
    assert parts["jax"] == parts["torch"]
    raw = b"".join(parts["torch"])
    for F in PACKAGES.values():
        assert _decode(F, raw, frame_max=frame_max) == b"".join(bufs)
    # a frame's crc covers its payload views in order, as one buffer
    views = [memoryview(b) for b in bufs]
    assert tframing.frame_crc(*views) == jframing.frame_crc(*views) \
        == jframing.frame_crc(b"".join(bufs))


def test_split_feed_at_every_byte():
    """Three short frames, fed in two pieces split at every byte, then a
    byte at a time: both decoders give the plaintext."""
    data = _payload(45, 3)
    raw = b"".join(_encode(jframing, [data], frame_max=16))
    assert raw == b"".join(_encode(tframing, [data], frame_max=16))
    for F in PACKAGES.values():
        for cut in range(len(raw) + 1):
            dec = F.FrameDecoder(peer=2, frame_max=16)
            out = bytearray()
            for piece in (raw[:cut], raw[cut:]):
                dec.feed(piece)
                buf = bytearray(64)
                n = dec.take(memoryview(buf))
                out += buf[:n]
            assert bytes(out) == data, cut
        assert _decode(F, raw, step=1, frame_max=16) == data


def _damaged(kind):
    payload = b"the wire is not to be trusted" * 20
    wire = bytearray(b"".join(_encode(jframing, [payload])))
    if kind == "length_huge":
        struct.pack_into("<I", wire, 0, 0xFFFFFF00)
    elif kind == "length_zero":
        struct.pack_into("<I", wire, 0, 0)
    else:
        pos = {"body": 4, "mid": len(wire) // 2,
               "trailer": len(wire) - 1}[kind]
        wire[pos] ^= 0x10
    return bytes(wire)


@pytest.mark.parametrize("kind", ["body", "mid", "trailer", "length_huge",
                                  "length_zero"])
def test_each_corruption_raises_the_same_error(kind):
    raw = _damaged(kind)
    messages = {}
    for name, F in PACKAGES.items():
        ev = _Counters()
        dec = F.FrameDecoder(peer=3, events=ev)
        with pytest.raises(ERRORS[name]) as info:
            dec.feed(raw)
        assert isinstance(info.value, ConnectionError)
        assert ev.counts == {"integrity.detected": 1}
        assert ev.events[0][1]["peer"] == 3
        messages[name] = (str(info.value), ev.events)
        assert not dec.pending()
    assert messages["jax"] == messages["torch"]
