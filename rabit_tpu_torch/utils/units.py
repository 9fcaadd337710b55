"""Byte-size parsing for configuration values.

PyTorch-port counterpart of :mod:`rabit_tpu.utils.units` (its own copy:
the port imports nothing of the JAX package).  The reference accepts
suffixed sizes for its collective buffer budget (reference:
rabit_reduce_buffer parse, src/allreduce_base.cc:117-132); the engine
reads ``rabit_reduce_buffer``, ``rabit_sock_buf``,
``rabit_ring_threshold_bytes`` and ``rabit_pipeline_chunk`` through it.
"""
from __future__ import annotations

import math

_SUFFIXES = {
    "": 1,
    "B": 1,
    "K": 1 << 10,
    "KB": 1 << 10,
    "M": 1 << 20,
    "MB": 1 << 20,
    "G": 1 << 30,
    "GB": 1 << 30,
}


def parse_byte_size(value) -> int:
    """``"256MB"`` / ``"64KB"`` / ``1048576`` -> bytes (int)."""
    if isinstance(value, (int, float)):
        if not math.isfinite(value):
            raise ValueError(f"byte size must be finite: {value!r}")
        nbytes = int(value)
    else:
        s = str(value).strip().upper()
        idx = len(s)
        while idx > 0 and not (s[idx - 1].isdigit() or s[idx - 1] == "."):
            idx -= 1
        num, suffix = s[:idx], s[idx:].strip()
        if not num or suffix not in _SUFFIXES:
            raise ValueError(
                f"bad byte size {value!r} (want e.g. 256MB, 64KB, 1048576)")
        raw = float(num) * _SUFFIXES[suffix]
        # finite check BEFORE int(): int(inf) raises OverflowError, and
        # callers catch ValueError for bad configuration (the magnitude
        # bound is enforced once below, on nbytes)
        if not math.isfinite(raw):
            raise ValueError(f"byte size out of range: {value!r}")
        nbytes = int(raw)
    if nbytes < 1:
        raise ValueError(f"byte size must be >= 1 byte: {value!r}")
    if nbytes > 9_000_000_000_000_000:  # < 2^53, same bound as the C++ twin
        raise ValueError(f"byte size out of range: {value!r}")
    return nbytes
