"""Log2-bucket latency histograms (counterpart of
:mod:`rabit_tpu.obs.metrics`, its ``Histogram`` only; the port's own
copy, since the port imports nothing of the JAX package).

A value lands in the bucket of its binary exponent (``math.frexp``), so
bucket boundaries are powers of two and a percentile estimate is
accurate within one octave.  On top of the buckets a Welford
accumulator keeps exact count, sum, mean and standard deviation, and
min and max.  Thread-safe, standard library only.
"""
from __future__ import annotations

import math
import threading

# Bucket i spans [2**(i + _EXP0), 2**(i + _EXP0 + 1)); _EXP0 puts the
# bottom bucket at ~1 ns so latencies and byte sizes both fit.
_EXP0 = -40
_NBUCKET = 64


class Histogram:
    """Log2-bucketed distribution with exact Welford mean/std and min/max."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buckets = [0] * _NBUCKET
        self.count = 0
        self.sum = 0.0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            delta = v - self._mean
            self._mean += delta / self.count
            self._m2 += delta * (v - self._mean)
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._buckets[self._index(v)] += 1

    @staticmethod
    def _index(v: float) -> int:
        if v <= 0.0:
            return 0
        e = math.frexp(v)[1] - 1  # v in [2**e, 2**(e+1))
        return min(max(e - _EXP0, 0), _NBUCKET - 1)

    @staticmethod
    def bucket_bound(i: int) -> float:
        """Lower bound of bucket ``i``."""
        return 2.0 ** (i + _EXP0)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        return math.sqrt(self._m2 / self.count)

    def _percentile_locked(self, q: float) -> float:
        if not self.count:
            return 0.0
        target = self.count * q / 100.0
        acc = 0
        for i, n in enumerate(self._buckets):
            acc += n
            if acc >= target:
                hi = self.bucket_bound(i + 1)
                return min(max(hi, self.min), self.max)
        return self.max

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile from the log2 buckets (upper
        bucket bound, clamped to the exact observed min/max — accurate
        within one octave)."""
        with self._lock:
            return self._percentile_locked(q)

    def snapshot(self) -> dict:
        # One locked section so count/min/max/percentiles are mutually
        # consistent even against concurrent observe().
        with self._lock:
            return {
                "count": self.count, "sum": self.sum,
                "mean": self.mean, "std": self.std,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self._percentile_locked(50),
                "p90": self._percentile_locked(90),
                "p99": self._percentile_locked(99),
                "buckets": {str(i + _EXP0): n
                            for i, n in enumerate(self._buckets) if n},
            }
