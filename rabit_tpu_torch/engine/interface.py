"""Abstract engine interface.

PyTorch-port counterpart of :class:`rabit_tpu.engine.interface.Engine`,
carried as far as the empty engine and :mod:`rabit_tpu_torch.api` use
it.  Buffers are numpy arrays or ``torch.Tensor``; checkpoint payloads
are ``bytes`` ((de)serialization happens in the API layer).
"""
from __future__ import annotations

import socket
from abc import ABC, abstractmethod
from typing import Callable, Optional

from rabit_tpu_torch.ops import ReduceOp


class CollectiveHandle:
    """Waitable result of an async collective (``allreduce_async``).

    ``wait()`` returns the op's result, the same object the blocking call
    would return; it is idempotent.  Only engines without a real async
    path are ported, and they run the op at issue time, so every handle
    is born resolved and callers use the handle API unconditionally.
    """

    def __init__(self, result) -> None:
        self._result = result

    @classmethod
    def resolved(cls, result) -> "CollectiveHandle":
        """A handle born complete (synchronous engines)."""
        return cls(result)

    def done(self) -> bool:
        """True once the op has completed: always, for a resolved handle."""
        return True

    def wait(self, timeout: Optional[float] = None):
        """The op's result (``timeout`` is for engines that overlap)."""
        return self._result


class Engine(ABC):
    """One collective-communication backend."""

    @abstractmethod
    def init(self, params: dict) -> None:
        """Connect/rendezvous with untyped name→value settings."""

    @abstractmethod
    def shutdown(self) -> None:
        """Leave the job cleanly."""

    @property
    @abstractmethod
    def rank(self) -> int: ...

    @property
    @abstractmethod
    def world_size(self) -> int: ...

    @property
    def host(self) -> str:
        return socket.gethostname()

    def is_distributed(self) -> bool:
        return self.world_size > 1

    @abstractmethod
    def allreduce(self, buf, op: ReduceOp,
                  prepare_fun: Optional[Callable[[], None]] = None):
        """In-place allreduce of ``buf``; ``prepare_fun`` fills it first
        unless a cached result is replayed during recovery."""

    def allreduce_async(self, buf, op: ReduceOp,
                        prepare_fun: Optional[Callable[[], None]] = None,
                        fuse: bool = True) -> CollectiveHandle:
        """Issue an in-place allreduce and return a waitable
        :class:`CollectiveHandle`.  The default runs the op synchronously
        and returns a resolved handle; ``fuse`` is for engines that
        coalesce small ops into buckets.  ``buf`` must not be touched
        between issue and ``wait()``."""
        return CollectiveHandle.resolved(self.allreduce(buf, op, prepare_fun))

    @abstractmethod
    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        """Any-root broadcast of a byte payload."""

    @abstractmethod
    def allgather(self, buf):
        """Gather each rank's ``buf`` into shape (world, *buf.shape)."""

    @abstractmethod
    def load_checkpoint(self) -> tuple[int, Optional[bytes], Optional[bytes]]:
        """(version, global_model_bytes, local_model_bytes); version 0
        means a fresh start."""

    @abstractmethod
    def checkpoint(self, global_model: bytes,
                   local_model: Optional[bytes] = None) -> None:
        """Commit a checkpoint and bump the version."""

    @property
    @abstractmethod
    def version_number(self) -> int:
        """Checkpoint version counter."""

    def tracker_print(self, msg: str) -> None:
        """Print a log line, rank-tagged when distributed."""
        if self.is_distributed():
            print(f"@tracker[{self.rank}] {msg}", flush=True)
        else:
            print(msg, flush=True)
