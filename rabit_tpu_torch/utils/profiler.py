"""Timing and tracing helpers (counterpart of
:mod:`rabit_tpu.utils.profiler`).

``get_time`` and ``Timer`` are the reference's: a monotonic clock, and
an accumulator of repeated sections with mean, std and max, a thin face
over the log2-bucket :class:`~rabit_tpu_torch.obs.metrics.Histogram`
(exact Welford moments, percentile estimates, snapshots).  ``trace``
captures a device trace where the reference captures a JAX one: it
wraps :class:`torch.profiler.profile`, recording the card's kernels and
copies (CUPTI) whenever CUDA is present and host operations when
``host_profiling`` is set, and writes a Chrome/Perfetto trace JSON
under ``logdir``.  :func:`device_busy` reads such a file back: the
device's busy share of the traced window and the time by kernel.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import socket
import time
from typing import Optional

from rabit_tpu_torch.obs.metrics import Histogram

#: the user annotation that spans ``trace``'s window (host activity)
WINDOW = "rabit_tpu_torch.trace"
#: trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_COUNT = itertools.count()


def get_time() -> float:
    """Seconds on a monotonic clock (reference: utils::GetTime)."""
    return time.perf_counter()


class Timer:
    """Accumulate wall-time over repeated sections.

    ``with timer: ...`` records one section; ``mean``/``std``/``max``
    aggregate over sections (Welford, exact).  The underlying
    :class:`~rabit_tpu_torch.obs.metrics.Histogram` is exposed for
    percentile estimates and snapshots.
    """

    def __init__(self) -> None:
        self.histogram = Histogram()
        self._t0: float | None = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        assert self._t0 is not None
        self.histogram.observe(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def total(self) -> float:
        return self.histogram.sum

    @property
    def count(self) -> int:
        return self.histogram.count

    @property
    def mean(self) -> float:
        return self.histogram.mean

    @property
    def std(self) -> float:
        return self.histogram.std

    @property
    def max(self) -> float:
        return self.histogram.max if self.histogram.count else 0.0


@dataclasses.dataclass
class Trace:
    """What ``trace`` yields: the profiler while the window is open, the
    trace file's path once it has closed."""

    profile: object
    path: Optional[str] = None


@contextlib.contextmanager
def trace(logdir: str, host_profiling: bool = True):
    """Trace the block under ``logdir``: the card's kernels and copies
    when CUDA is present, host operations (and the window's own span,
    :data:`WINDOW`) when ``host_profiling`` is set.  On exit the trace
    is written as Chrome/Perfetto JSON to
    ``logdir/trace.<host>.<pid>.<n>.json``, which the yielded
    :class:`Trace` names.  Raises where there is nothing to record (no
    CUDA and ``host_profiling`` off)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if host_profiling:
        activities.append(ProfilerActivity.CPU)
    if not activities:
        raise ValueError("trace: nothing to record (no CUDA device and "
                         "host_profiling off)")
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        handle = Trace(prof)
        with record_function(WINDOW):
            yield handle
    handle.path = os.path.join(
        logdir, f"trace.{socket.gethostname()}.{os.getpid()}."
                f"{next(_COUNT)}.json")
    prof.export_chrome_trace(handle.path)


def _union(spans: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_busy(path: str) -> dict:
    """The device's busy share of a trace file's window.  The window is
    :data:`WINDOW`'s span where the host was traced, else the span from
    the first to the last device event.  Busy time is the union of the
    kernel, copy and memset intervals (:data:`DEVICE_CATEGORIES`)
    clipped to the window, in µs; ``by_name`` sums each kernel's or
    copy's durations, in µs, with its count."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == WINDOW]
    if window:
        lo = float(window[0]["ts"])
        hi = lo + float(window[0]["dur"])
    elif device:
        lo = min(float(e["ts"]) for e in device)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in device)
    else:
        raise ValueError(f"{path}: no window and no device event")
    spans = [(max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]),
                                           hi)) for e in device]
    busy = _union([(a, b) for a, b in spans if b > a])
    by_name: dict = {}
    for e in device:
        us, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + float(e["dur"]), n + 1)
    by_cat = {c: sum(float(e["dur"]) for e in device if e["cat"] == c)
              for c in DEVICE_CATEGORIES}
    return {"window_us": hi - lo, "busy_us": busy,
            "share": busy / (hi - lo) if hi > lo else 0.0,
            "by_category_us": by_cat, "by_name": by_name}
