"""The ring kernel B4 across rank processes: each rank folds its peers'
inboxes after a start barrier on the host.

Counterpart of the reference's ``rabit_device_impl=pallas_ring``
(``rabit_tpu/engine/xla.py`` ``_use_pallas_ring`` and
``_collective_fn``), where ``ring_allreduce_pallas`` moves chunks
between chips by remote DMA, with send and receive semaphores.  Here the
ranks are processes on one card (or on cards with peer access), and a
table of pointers takes the DMAs' place: each rank reads every peer's
input in place and folds it in the ring's order
(:func:`rabit_tpu_torch.ops.ring_allreduce.ring_allreduce_peer`).  The
order depends only on the chunk an element falls in
(:func:`~rabit_tpu_torch.ops.ring_allreduce.pallas_chunk`), never on the
rank, so every rank holds the ring's bits and no end barrier is needed.
The cost is that each rank reads ``world x size`` elements; a
reduce-scatter split would read ``size`` but need an end barrier.

One :class:`PeerRing` a rank and a device epoch holds:

* **Two inboxes a rank, indexed by the op's parity.**  At op ``seq``
  rank r copies its input into ``inbox[r][seq % 2]``, waits until the
  copy is done, and posts ``seq`` at the start barrier.  When every peer
  has posted ``seq`` it launches the fold over every
  ``inbox[.][seq % 2]`` into a new tensor of its own.  Why one start
  barrier an op is enough: a peer that posts ``seq + 1`` has finished
  its fold for ``seq``, because it waits for its device work, that fold
  included, before it posts.  So once rank r has passed the barrier of
  ``seq + 1``, no peer reads ``inbox[.][seq % 2]`` any more, and r's
  copy at ``seq + 2`` may overwrite it.  With one inbox a rank, a fast
  rank's copy of ``seq + 1`` could overwrite what a slow peer is still
  folding for ``seq``.
* **Inboxes from ``cudaMalloc``** (in the kernel's library, not
  PyTorch's caching allocator: an IPC handle of a pointer inside a
  cached block names the block's base, and under expandable segments
  it is refused), shared by their CUDA IPC handles.  Capacity grows by
  powers of two.  Every rank issues the same collective with the same
  shape, so every rank grows at the same op, and the new handles are
  exchanged at that op.
* **The exchange**: at formation and at each growth, one call of the
  ``exchange`` function the owner gives (the engine: one allgather over
  its own group, as a ``uint8`` tensor) of a fixed-size record a rank:
  the start barrier's page name, then the two inboxes' handles.  Peers
  open the handles with lazy peer access; a rank never opens its own.
* **The start barrier, on the host, over a page of shared memory**
  (:class:`StartBarrier`).  Each rank writes only its own slot, a rising
  ``seq``, and waits, spinning briefly and then sleeping, until every
  slot has reached its own.  Not a flag spun on by a kernel: three
  processes on one card without MPS do not run their kernels at the
  same time, so a spinning kernel would see its peer's flag only after
  the card switched contexts, and a flag in a dead peer's memory can
  fault the survivor's context, which then cannot degrade.  Not the
  store: that costs a round trip an op.  The barrier gives up when its
  deadline (the engine's device timeout) passes, or at once when a
  peer's process is gone or the peer left the table (closed it, or
  failed before its post), with a :class:`PeerError` whose message
  carries "timed out" or "connection closed", so that the engine
  degrades.  Giving up is a decision every rank follows: the first rank
  to see every slot posted, or to give up, writes the op's verdict
  under a file lock, and a late rank reads it, so no rank folds an op
  that another has abandoned.

**What fails how.**  Only what a peer causes is a :class:`PeerError`,
on which the engine degrades: the barrier given up, a peer's inbox that
cannot be opened or closed.  A library that does not load and an
allocation or an IPC handle that CUDA refuses on this rank raise as they
are; the engine calls :func:`probe` before its first formation, so that
they stop the job at its start rather than leave it on the host plane.

**What a killed job leaves behind.**  Rank 0 creates the page, named
after the job, the device epoch, its pid and a random token; every rank
unlinks it after its first passed barrier (all peers have mapped it by
then) and again at close.  So a page outlives a job only if every rank
died between the table's formation and its first op, in
``/dev/shm/rabit_ring.*``.  Inboxes on the card die with their process.

**The CPU mode**, for the tests only: with a CPU device the inboxes are
shared-memory CPU tensors (files beside the page, the handle being the
file's name, unlinked like the page), the copy is a tensor copy and the
fold is :func:`~rabit_tpu_torch.ops.ring_allreduce.ring_fold_one`, the
kernel's order in plain PyTorch.  The tensors' device chooses the mode,
as in every kernel wrapper of the port; the engine never builds a table
on the CPU.
"""
from __future__ import annotations

import fcntl
import mmap
import os
import re
import secrets
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from rabit_tpu_torch.ops import ring_allreduce as rg
from rabit_tpu_torch.ops.reduce_ops import ReduceOp
from rabit_tpu_torch.ops.ring_allreduce import PeerError

#: the dtypes the ring kernel takes; any other stays on the group
RING_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
#: ranks the kernel's pointer table holds (``kMaxRanks`` in its source)
MAX_PEERS = 64
#: bytes of one name or handle in the exchanged record
SLOT_BYTES = 64
#: the smallest inbox
MIN_CAPACITY = 4096
#: how often a waiting rank checks that its late peers' processes live
LIVENESS_SEC = 0.05
_SPINS = 200                 # barrier polls before the first sleep
_NAP_MAX = 1e-3              # longest sleep between polls


def shm_dir() -> str:
    d = "/dev/shm"
    if os.path.isdir(d) and os.access(d, os.W_OK):
        return d
    return tempfile.gettempdir()


def _capacity(nbytes: int) -> int:
    return max(MIN_CAPACITY, 1 << max(nbytes - 1, 0).bit_length())


def _slot(text: str) -> bytes:
    raw = text.encode()
    if len(raw) > SLOT_BYTES:
        raise ValueError(f"peer ring: name {text!r} over {SLOT_BYTES} bytes")
    return raw.ljust(SLOT_BYTES, b"\0")


def _unslot(raw: bytes) -> str:
    return raw.rstrip(b"\0").decode()


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _process_gone(pid: int) -> bool:
    """True when ``pid`` no longer runs (exited, or a zombie not yet
    reaped)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return False


def probe() -> None:
    """Fail now, and not as a peer's failure, where this process cannot
    hold a table on its current CUDA device: the ring's library does not
    build or load, or CUDA refuses an inbox or its IPC handle (no IPC on
    this host, no memory).  Loads the library, allocates one inbox, takes
    its handle and frees it; raises what failed, an ``OSError`` or a
    ``RuntimeError`` naming the call."""
    rg._lib()
    ptr = rg.inbox_alloc(MIN_CAPACITY)
    try:
        rg.ipc_get(ptr)
    finally:
        rg.inbox_free(ptr)


def free_inboxes(orphans: list) -> None:
    """Free the inboxes that :meth:`PeerRing.close` left allocated, as
    (CUDA device index, pointer), emptying the list.  Call where every
    peer has closed its handles: past the first barrier of an ordered
    teardown."""
    while orphans:
        device, ptr = orphans.pop()
        with torch.cuda.device(device):
            rg.inbox_free(ptr)


class StartBarrier:
    """The start barrier over one page of shared memory: int64 words,
    word 0 the last verdict (``2 * seq + abandoned``), then each rank's
    posted ``seq``, then each rank's pid.  ``create`` makes the page (rank
    0); the others map it by path."""

    def __init__(self, path: str, rank: int, world: int,
                 create: bool) -> None:
        self.path, self._rank, self._world = path, rank, world
        size = -(-8 * (1 + 2 * world) // mmap.PAGESIZE) * mmap.PAGESIZE
        self._fd = os.open(path, os.O_RDWR | (
            os.O_CREAT | os.O_EXCL if create else 0), 0o600)
        try:
            if create:
                os.ftruncate(self._fd, size)
            self._map = mmap.mmap(self._fd, size)
        except BaseException:
            os.close(self._fd)
            raise
        self._words = np.frombuffer(self._map, np.int64)
        self._posted = self._words[1:1 + world]
        self._pids = self._words[1 + world:1 + 2 * world]
        self._pids[rank] = os.getpid()

    def post(self, seq: int) -> None:
        self._posted[self._rank] = seq

    def _verdict(self, seq: int) -> int | None:
        """0 (go) or 1 (abandoned) once ``seq`` is decided, else None.  A
        verdict on a later op means every rank passed this one."""
        word = int(self._words[0])
        if word >> 1 > seq:
            return 0
        return word & 1 if word >> 1 == seq else None

    def _decide(self, seq: int, give_up: bool = False) -> int:
        """Write the verdict of ``seq`` unless a rank already has: go if
        every rank has posted it and this rank does not ``give_up``, else
        abandoned.  Returns the verdict that stands."""
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        try:
            verdict = self._verdict(seq)
            if verdict is None:
                verdict = int(give_up or not (self._posted >= seq).all())
                self._words[0] = 2 * seq + verdict
            return verdict
        finally:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    def _gone(self, seq: int) -> list[tuple[int, int]]:
        """The late ranks that left the table or whose process is gone,
        as (rank, pid); a pid of -1 marks a rank that left."""
        me = os.getpid()
        return [(q, int(pid)) for q, pid in enumerate(self._pids)
                if self._posted[q] < seq and pid and pid != me
                and (pid < 0 or _process_gone(int(pid)))]

    def abandon(self, seq: int) -> None:
        """Give up ``seq`` for every rank unless it is decided: this rank
        failed before its post and will not fold it."""
        self._decide(seq, give_up=True)

    def leave(self) -> None:
        """Mark this rank gone from the table, so that a peer waiting for
        it gives up at its next check rather than at its deadline."""
        self._pids[self._rank] = -1

    def wait(self, seq: int, timeout: float) -> float:
        """Wait until the verdict of ``seq`` is go; returns the seconds
        waited.  Raises :class:`PeerError` when it is abandoned: by this
        rank, past ``timeout`` or on a peer whose process is gone, or by
        another."""
        t0 = time.monotonic()
        deadline, check_at = t0 + timeout, t0 + LIVENESS_SEC
        polls, nap, why = 0, 0.0, ""
        while True:
            verdict = self._verdict(seq)
            if verdict is None and (self._posted >= seq).all():
                verdict = self._decide(seq)
            if verdict is not None:
                break
            now = time.monotonic()
            if now >= check_at:
                gone = self._gone(seq)
                if gone:
                    why = (f"rank(s) {gone} (rank, pid; -1: left the "
                           "table) gone: connection closed")
                    verdict = self._decide(seq)
                    break
                check_at = now + LIVENESS_SEC
            if now >= deadline:
                why = f"timed out after {timeout:g} s"
                verdict = self._decide(seq)
                break
            polls += 1
            if polls > _SPINS:
                time.sleep(nap)
                nap = min(2 * nap or 2e-5, _NAP_MAX)
        if verdict:
            late = [q for q in range(self._world) if self._posted[q] < seq]
            raise PeerError(
                f"peer ring: start barrier of op {seq} abandoned on rank "
                f"{self._rank} ({why or 'by a peer: timed out or a peer gone'}"
                f"; ranks not posted: {late})")
        return time.monotonic() - t0

    def close(self) -> None:
        if self._fd < 0:
            return
        self.leave()
        del self._words, self._posted, self._pids
        self._map.close()
        os.close(self._fd)
        self._fd = -1


class PeerRing:
    """One rank's table of the ring across processes (see the module
    docstring).  ``exchange(record) -> [record of each rank]`` is a
    collective of the ranks' group; ``device`` is this rank's device
    (CUDA, or the CPU for the tests); ``timeout`` the start barrier's
    deadline in seconds; ``tag`` names the page (job and device epoch);
    ``capacity`` the inboxes' first size in bytes."""

    def __init__(self, rank: int, world: int,
                 exchange: Callable[[bytes], list], device, timeout: float,
                 tag: str = "default", capacity: int = MIN_CAPACITY) -> None:
        if not 1 < world <= MAX_PEERS:
            raise ValueError(f"peer ring: world {world}, the kernel takes 2 "
                             f"to {MAX_PEERS} ranks")
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            rg._lib()                   # built at first use, or raises
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"peer ring: no route for device {self.device}")
        self.timeout = float(timeout)
        self._exchange = exchange
        self.seq = 0                    # ops started
        self.capacity = 0
        self.grown = 0                  # growths after formation
        self.last_wait_s = 0.0          # the last op's barrier wait
        self._own: list = []            # this rank's two inboxes
        self._peers: list = []          # [rank][parity]: what the fold reads
        self._opened: list = []         # peers' inboxes this rank opened
        self._files: list[str] = []     # this rank's files, until unlinked
        self._retired: list = []        # own inboxes before a growth
        self._barrier: StartBarrier | None = None
        self._broken = False
        token = re.sub(r"[^A-Za-z0-9_.-]", "_", tag)[:20]
        self._prefix = (f"rabit_ring.{token}.{os.getpid()}."
                        f"{secrets.token_hex(4)}")
        try:
            page = ""
            if rank == 0:
                page = os.path.join(shm_dir(), self._prefix)
                self._barrier = StartBarrier(page, rank, world, create=True)
                self._files.append(page)
            records = self._swap(_capacity(capacity), _slot(page))
            if rank != 0:
                self._barrier = StartBarrier(
                    _unslot(records[0][:SLOT_BYTES]), rank, world,
                    create=False)
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------------
    # inboxes
    # ------------------------------------------------------------------
    def _alloc(self, nbytes: int, name: str):
        """A new inbox of ``nbytes``: (what the fold reads, its handle)."""
        if self.cuda:
            with torch.cuda.device(self.device):
                ptr = rg.inbox_alloc(nbytes)
                try:
                    return ptr, rg.ipc_get(ptr)
                except BaseException:
                    rg.inbox_free(ptr)
                    raise
        path = os.path.join(shm_dir(), name)
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, nbytes)
        finally:
            os.close(fd)
        self._files.append(path)
        return (torch.from_file(path, shared=True, size=nbytes,
                                dtype=torch.uint8), _slot(name))

    def _open(self, handle: bytes, nbytes: int):
        """A peer's inbox in this process, from its handle."""
        if self.cuda:
            with torch.cuda.device(self.device):
                ptr = rg.ipc_open(handle)
            self._opened.append(ptr)
            return ptr
        path = os.path.join(shm_dir(), _unslot(handle))
        if not os.path.exists(path):
            raise PeerError(f"peer ring: inbox {path} is gone: connection "
                            "closed")
        view = torch.from_file(path, shared=True, size=nbytes,
                               dtype=torch.uint8)
        self._opened.append(view)
        return view

    def _swap(self, capacity: int, page: bytes) -> list:
        """Allocate this rank's two inboxes at ``capacity``, exchange the
        records and open the peers'.  The inboxes before, if any, are
        retired: peers may still fold them until the next barrier
        passes."""
        gen = self.grown
        old_own, old_opened = self._own, self._opened
        self._own, self._opened = [], []
        try:
            for parity in (0, 1):
                self._own.append(self._alloc(
                    capacity, f"{self._prefix}.r{self.rank}g{gen}p{parity}"))
            record = page + b"".join(h for _, h in self._own)
            records = [bytes(r) for r in self._exchange(record)]
            if len(records) != self.world or any(
                    len(r) != 3 * SLOT_BYTES for r in records):
                raise RuntimeError(f"peer ring: exchange gave "
                                   f"{[len(r) for r in records]} bytes by "
                                   "rank")
            peers = []
            for q, rec in enumerate(records):
                if q == self.rank:
                    peers.append([t for t, _ in self._own])
                    continue
                peers.append([self._open(rec[SLOT_BYTES * (1 + p):
                                             SLOT_BYTES * (2 + p)], capacity)
                              for p in (0, 1)])
        except BaseException:
            fresh, self._own = self._own, old_own
            opened, self._opened = self._opened, old_opened
            self._release(opened, fresh)
            raise
        self._peers, self.capacity = peers, capacity
        # this rank's own fold has finished (it waited before this op's
        # exchange), so the old handles close now; its own old inboxes
        # wait until every peer has passed this op's barrier
        self._release(old_opened, [])
        self._retired += old_own
        return records

    def _release(self, opened: list, own: list) -> None:
        """Close the peers' inboxes ``opened``; free this rank's ``own``."""
        if self.cuda:
            with torch.cuda.device(self.device):
                for ptr in opened:
                    rg.ipc_close(ptr)
                for ptr, _ in own:
                    rg.inbox_free(ptr)
        else:
            opened.clear()
            own.clear()

    def _unlink_files(self) -> None:
        for path in self._files:
            _unlink(path)
        self._files = []

    # ------------------------------------------------------------------
    # the op
    # ------------------------------------------------------------------
    def _check(self, x: torch.Tensor, op: ReduceOp) -> None:
        if op not in rg.supported_ops():
            raise ValueError(f"peer ring: unsupported op {op}")
        if x.dtype not in RING_DTYPES:
            raise TypeError(f"peer ring takes float32, bfloat16 or int32, "
                            f"got {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"peer ring: the table lives on {self.device}, "
                             f"got a tensor on {x.device}")
        if x.numel() == 0:
            raise ValueError("peer ring: empty tensor")

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def allreduce(self, x: torch.Tensor, op=ReduceOp.SUM) -> torch.Tensor:
        """Every rank's ``x`` (same shape and dtype on every rank) folded
        in the ring's order; a new tensor on ``x``'s device, ``x`` left
        as it was.  Every rank of the table must call it, in the same
        order.  Raises before any byte moves for what the kernel cannot
        take; :class:`PeerError` when the barrier is abandoned or a
        peer's inbox cannot be opened, a plain ``RuntimeError`` naming the
        call for any other CUDA failure; after either the table is
        broken."""
        op = ReduceOp(op)
        self._check(x, op)
        if self._broken:
            raise PeerError("peer ring: the table is broken by an earlier "
                            "failure: connection closed")
        src = x.detach().reshape(-1).contiguous()
        nbytes = src.numel() * src.element_size()
        seq = self.seq + 1
        self._broken = True             # until this op's fold is launched
        self.seq = seq
        parity = seq % 2
        try:
            if nbytes > self.capacity:
                self._sync()            # this rank's last fold is done
                self.grown += 1
                self._swap(_capacity(nbytes), _slot(""))
            mine = self._own[parity][0]
            if self.cuda:
                with torch.cuda.device(self.device):
                    rg.inbox_copy(mine, src)
            else:
                mine[:nbytes].copy_(src.view(torch.uint8))
            self._sync()                # the copy and the last fold
            self._barrier.post(seq)
            self.last_wait_s = self._barrier.wait(seq, self.timeout)
        except BaseException:
            self._barrier.abandon(seq)  # the peers need not wait it out
            raise
        # every peer has opened this rank's files and finished the op
        # before: unlink the files, free the inboxes a growth retired
        if self._files:
            self._unlink_files()
        if self._retired:
            retired, self._retired = self._retired, []
            self._release([], retired)
        inboxes = [self._peers[q][parity] for q in range(self.world)]
        if self.cuda:
            out = torch.empty(src.numel(), dtype=src.dtype,
                              device=self.device)
            with torch.cuda.device(self.device):
                rg.ring_allreduce_peer(inboxes, src.numel(), op, out)
        else:
            out = rg.ring_fold_one(
                [t[:nbytes].view(src.dtype) for t in inboxes], op)
        self._broken = False
        return out.view(x.shape)

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def release_peers(self) -> None:
        """Wait for this rank's folds, then close its peers' handles: the
        first half of an ordered teardown, before its first barrier."""
        self._sync()
        opened, self._opened, self._peers = self._opened, [], []
        self._release(opened, [])

    def close(self, quiet: bool = False) -> list:
        """Close the peers' handles, free this rank's inboxes and unlink
        the files; idempotent.  ``quiet``: every peer has closed its
        handles (an ordered teardown past its first barrier).  Otherwise
        a late peer may still fold this rank's inboxes on the card, so
        they stay allocated and are returned, as (device index,
        pointer), for :func:`free_inboxes` at the next quiet point."""
        orphans = []
        try:
            if self._opened:
                self.release_peers()
        finally:
            own = self._own + self._retired
            self._own, self._retired, self._peers = [], [], []
            if self.cuda and not quiet:
                orphans = [(self.device.index, ptr) for ptr, _ in own]
                own = []
            try:
                self._release([], own)
            finally:
                self._unlink_files()
                if self._barrier is not None:
                    _unlink(self._barrier.path)
                    self._barrier.close()
                    self._barrier = None
                self._broken = True
        return orphans

    def open_handles(self) -> int:
        """Peers' inboxes this rank holds open."""
        return len(self._opened)

    def files(self) -> list[str]:
        """This rank's files not yet unlinked (the page, CPU inboxes)."""
        return list(self._files)
