"""Durable checkpoint tier: versioned on-disk model blobs.

PyTorch-port counterpart of :mod:`rabit_tpu.ckpt.store` (its own copy:
the port imports nothing of the JAX package), with the reference's file
names, blob layout and manifest bytes, so port ranks and reference ranks
share one checkpoint directory and one cold restart.

The in-memory recovery protocol (:mod:`rabit_tpu_torch.engine.robust`)
survives any failure that leaves at least one live rank holding the
committed checkpoint.  A *correlated* loss — full-pod preemption,
"every replica of version N died", a supervisor restarting the whole
world — would restart the job at version 0.  This module is the tier
below the RAM replicas: elected writer ranks persist each committed
``(version, global, local)`` state to ``rabit_ckpt_dir``, and the
engine's checkpoint-load path falls back to the newest *valid* on-disk
version when no live rank has one.

Durability discipline (writer side):

* Every file lands via **tmp-file + fsync + rename** — a writer killed
  at any instruction leaves either the old file or the new file, never
  a torn one.  The blob is renamed before the manifest referencing it,
  so a manifest entry always names a fully-written blob.
* Blobs are **CRC32-stamped** end to end; the loader verifies before
  serving and silently falls back to the next-older version on a
  corrupt or truncated blob.
* Each writer owns its own manifest (``manifest.json`` for rank 0,
  ``manifest.r<N>.json`` otherwise): there is no cross-process
  read-modify-write anywhere, so concurrent writers on a shared
  filesystem never race.
* Bounded retention: ``rabit_ckpt_keep`` newest versions per writer;
  pruning rewrites the manifest first, then deletes the blobs it no
  longer references.

Loader side: candidates are collected from every manifest **plus** a
direct scan for orphan blobs (a writer that died between the blob
rename and the manifest rename leaves a valid, unreferenced blob — it
still counts), then validated newest-first.
"""
from __future__ import annotations

import glob
import json
import os
import struct
import zlib
from dataclasses import dataclass, field

from rabit_tpu_torch.utils.checks import RabitError, log

_BLOB_MAGIC = 0x7AB1C902
_FORMAT = 1
_HEADER = struct.Struct("<IIIIII")  # magic, format, version, world, writer, nlocals
_U64 = struct.Struct("<Q")
_LOCAL_HDR = struct.Struct("<IQ")   # origin rank, blob length
_CRC = struct.Struct("<I")


class CheckpointSkewError(RabitError):
    """A rank's durable checkpoint is NEWER than the cluster-agreed one.

    Raised by a (re)joining rank when the version it would be served by
    the live world is older than a valid checkpoint on its own disk —
    the disk belongs to a different (or further-progressed) incarnation
    of the job, and silently accepting the stale cluster state would
    roll committed work backward without anyone noticing.  Carries both
    versions so the supervisor can decide which side is wrong."""

    def __init__(self, disk_version: int, agreed_version: int) -> None:
        super().__init__(
            f"durable checkpoint skew: disk holds committed version "
            f"{disk_version} but the cluster agreed on version "
            f"{agreed_version} — refusing to serve stale state")
        self.disk_version = int(disk_version)
        self.agreed_version = int(agreed_version)


@dataclass
class DiskCheckpoint:
    """One validated on-disk checkpoint (see :func:`unpack_blob`)."""

    version: int
    world: int
    writer: int
    global_blob: bytes
    locals: dict[int, bytes] = field(default_factory=dict)
    raw: bytes = b""  # the full CRC-stamped blob, re-servable as-is


def pack_blob(version: int, world: int, writer: int, global_blob: bytes,
              locals_: dict[int, bytes] | None = None) -> bytes:
    """Serialize one checkpoint into the self-describing CRC-stamped
    wire/disk format (shared by the on-disk files and the cold-restart
    serving broadcast)."""
    locals_ = locals_ or {}
    parts = [_HEADER.pack(_BLOB_MAGIC, _FORMAT, version, world, writer,
                          len(locals_)),
             _U64.pack(len(global_blob))]
    origins = sorted(locals_)
    for origin in origins:
        parts.append(_LOCAL_HDR.pack(origin, len(locals_[origin])))
    parts.append(global_blob)
    for origin in origins:
        parts.append(locals_[origin])
    body = b"".join(parts)
    return body + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF)


def unpack_blob(raw: bytes) -> DiskCheckpoint:
    """Parse + CRC-verify a blob produced by :func:`pack_blob`.
    Raises ``ValueError`` on any corruption (bad magic, truncation,
    CRC mismatch) — the loader turns that into fallback, the engine's
    install path into a loud error."""
    if len(raw) < _HEADER.size + _U64.size + _CRC.size:
        raise ValueError("checkpoint blob truncated")
    (crc,) = _CRC.unpack_from(raw, len(raw) - _CRC.size)
    body = raw[:-_CRC.size]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ValueError("checkpoint blob CRC mismatch")
    magic, fmt, version, world, writer, nlocals = _HEADER.unpack_from(body)
    if magic != _BLOB_MAGIC or fmt != _FORMAT:
        raise ValueError(f"bad checkpoint blob magic/format "
                         f"({magic:#x}/{fmt})")
    pos = _HEADER.size
    (glen,) = _U64.unpack_from(body, pos)
    pos += _U64.size
    local_hdrs = []
    for _ in range(nlocals):
        origin, llen = _LOCAL_HDR.unpack_from(body, pos)
        pos += _LOCAL_HDR.size
        local_hdrs.append((int(origin), int(llen)))
    if pos + glen + sum(l for _, l in local_hdrs) != len(body):
        raise ValueError("checkpoint blob length mismatch")
    global_blob = body[pos:pos + glen]
    pos += glen
    locals_: dict[int, bytes] = {}
    for origin, llen in local_hdrs:
        locals_[origin] = body[pos:pos + llen]
        pos += llen
    return DiskCheckpoint(int(version), int(world), int(writer),
                          global_blob, locals_, raw=bytes(raw))


def expand_dir(path: str, rank: int) -> str:
    """Expand the ``{rank}`` token so local multi-process jobs can
    emulate per-host disks with one ``rabit_ckpt_dir`` setting."""
    return path.replace("{rank}", str(rank))


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(dirname: str) -> None:
    """Make the renames themselves durable (best effort: some
    filesystems refuse O_RDONLY directory fsync)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointStore:
    """One rank's view of a durable checkpoint directory.

    ``rank`` names this process for writer-side file ownership; any
    rank (writer or not) can load.  All writes are atomic-rename
    transactions, so killing a writer at ANY point leaves the store
    readable (possibly one version behind)."""

    def __init__(self, root: str, rank: int = 0, keep: int = 3) -> None:
        self.root = str(root)
        self.rank = int(rank)
        self.keep = max(int(keep), 1)
        os.makedirs(self.root, exist_ok=True)
        self._sweep_stale_tmps()

    def _sweep_stale_tmps(self) -> None:
        """Reap tmp files a killed predecessor of THIS rank left behind
        (crash between open and rename) so they cannot accumulate
        model-sized junk across preemptions.  Scoped to this rank's own
        file names and foreign pids — a concurrent writer of another
        rank mid-persist is never touched."""
        own = (f".v*.r{self.rank}.ckpt.tmp.*",
               f".{self.manifest_name}.tmp.*")
        pid_suffix = f".tmp.{os.getpid()}"
        for pattern in own:
            for path in glob.glob(os.path.join(self.root, pattern)):
                if path.endswith(pid_suffix):
                    continue  # this process's own in-flight write
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- naming --------------------------------------------------------
    def _blob_name(self, version: int) -> str:
        return f"v{version:08d}.r{self.rank}.ckpt"

    @property
    def manifest_name(self) -> str:
        return "manifest.json" if self.rank == 0 else \
            f"manifest.r{self.rank}.json"

    def _write_atomic(self, name: str, data: bytes) -> str:
        """tmp + fsync + rename; the only way bytes reach the store."""
        final = os.path.join(self.root, name)
        tmp = os.path.join(self.root, f".{name}.tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final

    # -- writer side ---------------------------------------------------
    def persist(self, version: int, world: int, global_blob: bytes,
                locals_: dict[int, bytes] | None = None) -> str:
        """Durably persist one committed version; returns the blob path.

        Order matters for crash-safety: blob rename, (test crash seam),
        manifest rename, then pruning of blobs the new manifest no
        longer references."""
        raw = pack_blob(version, world, self.rank, global_blob, locals_)
        name = self._blob_name(version)
        path = self._write_atomic(name, raw)
        _fsync_dir(self.root)
        self._maybe_crash(version)
        entries = [e for e in self._read_manifest_entries(self.manifest_name)
                   if e.get("version") != version]
        entries.append({
            "version": int(version),
            "file": name,
            "size": len(raw),
            "crc": zlib.crc32(raw) & 0xFFFFFFFF,
            "fingerprint": zlib.crc32(global_blob) & 0xFFFFFFFF,
        })
        entries.sort(key=lambda e: e["version"], reverse=True)
        keep, drop = entries[:self.keep], entries[self.keep:]
        manifest = {"format": _FORMAT, "writer": self.rank,
                    "world": int(world), "entries": keep}
        self._write_atomic(self.manifest_name,
                           json.dumps(manifest, indent=1).encode())
        _fsync_dir(self.root)
        for e in drop:  # only after the manifest stopped naming them
            try:
                os.remove(os.path.join(self.root, e["file"]))
            except OSError:
                pass
        return path

    def _maybe_crash(self, version: int) -> None:
        """Deterministic torn-persist injection (tests): with
        ``RABIT_CKPT_CRASH="rank,version"`` the writer dies with the
        restart exit code after the blob rename but before the manifest
        rename — first life only, like a mock kill-point."""
        spec = os.environ.get("RABIT_CKPT_CRASH", "")
        if not spec or os.environ.get("RABIT_NUM_TRIAL", "0") != "0":
            return
        try:
            crash_rank, crash_version = (int(x) for x in spec.split(","))
        except ValueError:
            return
        if crash_rank == self.rank and crash_version == version:
            log("ckpt: injected writer death after blob rename "
                "(rank %d, v%d)", self.rank, version)
            os._exit(254)

    # -- loader side ---------------------------------------------------
    def _read_manifest_entries(self, name: str) -> list[dict]:
        try:
            with open(os.path.join(self.root, name)) as f:
                doc = json.load(f)
            entries = doc.get("entries", [])
            return [e for e in entries
                    if isinstance(e.get("version"), int) and e.get("file")]
        except (OSError, ValueError):
            return []

    def _candidates(self) -> list[tuple[int, str]]:
        """(version, filename) pairs from every manifest plus orphan
        blobs no manifest names, deduped, newest version first."""
        seen: dict[str, int] = {}
        for mpath in glob.glob(os.path.join(self.root, "manifest*.json")):
            for e in self._read_manifest_entries(os.path.basename(mpath)):
                seen.setdefault(e["file"], int(e["version"]))
        for bpath in glob.glob(os.path.join(self.root, "v*.ckpt")):
            name = os.path.basename(bpath)
            try:
                version = int(name[1:].split(".", 1)[0])
            except ValueError:
                continue
            seen.setdefault(name, version)
        return sorted(((v, f) for f, v in seen.items()),
                      key=lambda t: (-t[0], t[1]))

    def _load_file(self, name: str) -> DiskCheckpoint | None:
        try:
            with open(os.path.join(self.root, name), "rb") as f:
                raw = f.read()
            return unpack_blob(raw)
        except (OSError, ValueError) as e:
            log("ckpt: skipping invalid checkpoint blob %s (%s)", name, e)
            return None

    def load_latest(self) -> DiskCheckpoint | None:
        """Newest CRC-valid checkpoint, falling back to older versions
        past corrupt/truncated blobs; None when the store is empty or
        nothing validates."""
        for _version, name in self._candidates():
            dc = self._load_file(name)
            if dc is not None:
                return dc
        return None

    def load_version(self, version: int) -> DiskCheckpoint | None:
        """The newest *valid* blob of exactly ``version``, from any
        writer's manifest (or an orphan).  The elastic soak gate reads
        rescale-boundary versions with this for its segmented
        bit-identical reference comparison; ``None`` when that version
        is absent or nothing validates."""
        for v, name in self._candidates():
            if v != version:
                continue
            dc = self._load_file(name)
            if dc is not None:
                return dc
        return None

    def newest_version(self, min_version: int | None = None) -> int | None:
        """Version of the newest *valid* checkpoint (the skew-guard
        input); invalid blobs do not count.  ``min_version`` considers
        only candidates strictly above it — the skew guard passes the
        cluster-agreed version, so the common no-skew case touches no
        blob at all instead of CRC-scanning the full newest model on
        every recovery."""
        for version, name in self._candidates():
            if min_version is not None and version <= min_version:
                return None  # candidates are newest-first: all done
            dc = self._load_file(name)
            if dc is not None:
                return dc.version
        return None

    def versions(self) -> list[int]:
        """Distinct candidate versions, newest first (validity NOT
        checked — pair with :meth:`load_version`).  The serving plane's
        refresh poll walks this to find versions newer than the one it
        serves without CRC-scanning any blob."""
        out: list[int] = []
        for v, _name in self._candidates():
            if not out or out[-1] != v:
                out.append(v)
        return out

    def scan(self) -> list[dict]:
        """Inventory for tooling/tests: every candidate with its
        validity verdict."""
        out = []
        for version, name in self._candidates():
            dc = self._load_file(name)
            out.append({"version": version, "file": name,
                        "valid": dc is not None,
                        "writer": dc.writer if dc else None})
        return out
