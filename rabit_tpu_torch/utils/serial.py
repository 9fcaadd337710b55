"""Checkpoint serialization contract.

PyTorch-port counterpart of :mod:`rabit_tpu.utils.serial`: the same
one-byte format tags, so a payload's kind (custom :class:`Serializable`,
raw bytes, or pickle) is read back the same way in both packages.
"""
from __future__ import annotations

import io
import pickle
import struct
from abc import ABC, abstractmethod
from typing import Any

from rabit_tpu_torch.utils.checks import check, error


class Stream(ABC):
    """Minimal byte stream with length-prefixed little-endian helpers."""

    @abstractmethod
    def read(self, nbytes: int) -> bytes:
        """Read up to ``nbytes``; returns b'' at end of stream."""

    @abstractmethod
    def write(self, data: bytes) -> None:
        """Write all of ``data``."""

    def write_u64(self, value: int) -> None:
        self.write(struct.pack("<Q", value))

    def read_u64(self) -> int:
        raw = self.read(8)
        check(len(raw) == 8, "stream: truncated u64")
        return struct.unpack("<Q", raw)[0]

    def write_bytes(self, data: bytes) -> None:
        self.write_u64(len(data))
        if data:
            self.write(data)

    def read_bytes(self) -> bytes:
        n = self.read_u64()
        data = self.read(n) if n else b""
        check(len(data) == n, "stream: truncated payload (%d != %d)",
              len(data), n)
        return data


class MemoryBufferStream(Stream):
    """Growable in-memory stream."""

    def __init__(self, init: bytes = b""):
        self._buf = io.BytesIO(init)

    def read(self, nbytes: int) -> bytes:
        return self._buf.read(nbytes)

    def write(self, data: bytes) -> None:
        self._buf.write(data)

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


class Serializable(ABC):
    """Checkpointable object contract."""

    @abstractmethod
    def save(self, stream: Stream) -> None: ...

    @abstractmethod
    def load(self, stream: Stream) -> None: ...

    def to_bytes(self) -> bytes:
        s = MemoryBufferStream()
        self.save(s)
        return s.getvalue()

    def from_bytes(self, data: bytes) -> None:
        self.load(MemoryBufferStream(data))


_TAG_PICKLE = b"P"
_TAG_SERIALIZABLE = b"S"
_TAG_BYTES = b"B"


def serialize_model(model: Any) -> bytes:
    """Serialize a checkpoint payload: Serializable, bytes, or picklable."""
    if isinstance(model, Serializable):
        return _TAG_SERIALIZABLE + model.to_bytes()
    if isinstance(model, (bytes, bytearray, memoryview)):
        return _TAG_BYTES + bytes(model)
    return _TAG_PICKLE + pickle.dumps(model)


def deserialize_model(data: bytes, into: Any = None) -> Any:
    """Inverse of :func:`serialize_model`.  A Serializable payload needs
    ``into`` (its byte format belongs to the model class), which is
    restored in place and returned."""
    tag, body = data[:1], data[1:]
    if isinstance(into, Serializable):
        check(tag == _TAG_SERIALIZABLE,
              "load_checkpoint: checkpoint was not saved from a Serializable")
        into.from_bytes(body)
        return into
    if tag == _TAG_BYTES:
        return body
    if tag == _TAG_SERIALIZABLE:
        error("load_checkpoint: model was checkpointed via Serializable; "
              "pass the model instance to restore into")
    return pickle.loads(body)
