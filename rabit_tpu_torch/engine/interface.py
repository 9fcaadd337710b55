"""Abstract engine interface.

PyTorch-port counterpart of :class:`rabit_tpu.engine.interface.Engine`,
carried as far as the empty and pysocket engines and
:mod:`rabit_tpu_torch.api` use it.  Buffers are numpy arrays or ``torch.Tensor``; checkpoint payloads
are ``bytes`` ((de)serialization happens in the API layer).
"""
from __future__ import annotations

import socket
import threading
from abc import ABC, abstractmethod
from typing import Callable, Optional

import numpy as np

from rabit_tpu_torch.ops import ReduceOp


class AsyncOrderError(RuntimeError):
    """An async handle was waited out of issue order.

    Async collectives resolve strictly in issue order (the wire stream
    is one ordered sequence on every engine); waiting handle N before
    every handle issued earlier has been waited would deadlock or
    reorder the stream, so it fails loudly instead.
    """


class CollectiveHandle:
    """Waitable result of an async collective (``allreduce_async`` /
    ``allgather_async``).

    ``wait()`` blocks until the op completes and returns its result —
    the same object the blocking call would return (the caller's array
    for in-place allreduce, a new array for allgather).  A failure
    inside the engine's progress machinery (e.g. a peer death) re-raises
    at ``wait()``.  ``wait()`` is idempotent; handles from an
    async-capable engine must be waited in issue order (see
    :class:`AsyncOrderError`).

    Engines without a real async path return handles that are born
    resolved (the op ran synchronously at issue time), so callers can
    use the handle API unconditionally.
    """

    def __init__(self, on_wait: Optional[Callable[["CollectiveHandle"],
                                                  None]] = None) -> None:
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._on_wait = on_wait
        self._waited = False

    @classmethod
    def resolved(cls, result) -> "CollectiveHandle":
        """A handle born complete (synchronous engines)."""
        h = cls()
        h._resolve(result)
        return h

    def _resolve(self, result) -> None:
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        """True once the op has completed (successfully or not)."""
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the op completes; return its result or re-raise
        the failure that stopped it."""
        if self._on_wait is not None and not self._waited:
            # Engine hook: issue-order enforcement and the pending-bucket
            # flush happen before we block.
            self._on_wait(self)
        self._waited = True
        if not self._event.wait(timeout):
            raise TimeoutError("CollectiveHandle.wait timed out")
        if self._error is not None:
            raise self._error
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

    @property
    def last_op_replayed(self) -> bool:
        """True iff the LAST collective's result was served from the
        fault-tolerance replay cache (the op completed before this
        relaunched rank joined).  Always False for engines without
        replay; the robust engine overrides this."""
        return False

    @abstractmethod
    def allreduce(self, buf, op: ReduceOp,
                  prepare_fun: Optional[Callable[[], None]] = None):
        """In-place allreduce of ``buf``; ``prepare_fun`` fills it first
        unless a cached result is replayed during recovery."""

    def allreduce_async(self, buf, op: ReduceOp,
                        prepare_fun: Optional[Callable[[], None]] = None,
                        fuse: bool = True,
                        codec: bool = True) -> CollectiveHandle:
        """Issue an in-place allreduce and return a waitable
        :class:`CollectiveHandle`.  The default runs the op synchronously
        and returns a resolved handle; engines with a progress thread
        (pysocket) override this to overlap the wire with the caller's
        compute and to coalesce streams of small same-op/same-dtype
        payloads into fused wire ops (``rabit_bucket_bytes``; pass
        ``fuse=False`` for a lone latency-sensitive op).  ``codec`` is
        the reference's per-op wire-codec opt-out: no codec is ported
        (ROADMAP A8), so every op rides the full-width wire, but the
        flag still keys the buckets as the reference's does.  ``buf``
        must not be touched between issue and ``wait()``."""
        return CollectiveHandle.resolved(self.allreduce(buf, op, prepare_fun))

    def allgather_async(self, buf: np.ndarray) -> CollectiveHandle:
        """Issue an allgather; ``wait()`` returns the (world, *shape)
        result.  Default is synchronous (see :meth:`allreduce_async`)."""
        return CollectiveHandle.resolved(self.allgather(buf))

    def allreduce_custom(
        self,
        buf: np.ndarray,
        reducer: Callable[[np.ndarray, np.ndarray], None],
        prepare_fun: Optional[Callable[[], None]] = None,
    ) -> np.ndarray:
        """In-place allreduce with a user-defined reducer.

        ``reducer(dst, src)`` must fold ``src`` into ``dst`` in place and
        be **associative and commutative** — merge order is unspecified
        and engine-dependent (this default gathers every rank's rows and
        folds them in rank order; the pysocket engine folds in tree
        order).  Engines with a custom path override this.
        """
        if prepare_fun is not None:
            prepare_fun()
        if self.world_size == 1:
            return buf
        parts = self.allgather(buf)
        acc = np.array(parts[0], copy=True)
        for r in range(1, self.world_size):
            reducer(acc, parts[r])
        buf[...] = acc
        return buf

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
    def checkpoint(self, global_model: Optional[bytes],
                   local_model: Optional[bytes] = None,
                   lazy_global: Optional[Callable[[], bytes]] = None
                   ) -> None:
        """Commit a checkpoint and bump the version.  ``lazy_global``
        (with ``global_model`` None) defers the serialization until a
        peer needs the payload; engines without recovery call it at
        commit."""

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
