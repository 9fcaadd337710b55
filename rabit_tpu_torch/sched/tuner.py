"""The schedule directive's wire encoding.

PyTorch-port counterpart of the directive helpers of
:mod:`rabit_tpu.sched.tuner` (``:244-263``), copied alone: the tracker
ships a (possibly empty) directive string in every topology reply.  The
tuning cache and the directive lookups wait for ROADMAP A8.

A directive maps payload buckets to schedule names,
``"bytes:name,..."``, so it rides the topology reply as one trailing
field and tolerates version skew (an unknown entry is simply skipped).
"""
from __future__ import annotations


def encode_directive(table: dict[int, str]) -> str:
    return ",".join(f"{int(b)}:{n}" for b, n in sorted(table.items()))


def decode_directive(raw: str) -> dict[int, str]:
    """Parse a directive string; malformed entries are skipped, never
    raised — the string arrives from the network."""
    out: dict[int, str] = {}
    for part in str(raw or "").split(","):
        if ":" not in part:
            continue
        b, name = part.split(":", 1)
        name = name.strip()
        try:
            bucket = int(b)
        except ValueError:
            continue
        if bucket > 0 and name:
            out[bucket] = name
    return out
