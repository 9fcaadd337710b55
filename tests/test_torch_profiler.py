"""The port's measuring tools on the CPU: ``obs/metrics.py``'s
``Histogram`` and ``utils/profiler.py``'s ``Timer``, ``trace`` and
``device_busy``.

``Histogram`` and ``Timer`` are held against the JAX package's
(``rabit_tpu.obs.metrics.Histogram``, ``rabit_tpu.utils.profiler.Timer``)
on the same seeded observations: every statistic and the snapshot must
be equal, float for float, since both run the same arithmetic.
``trace`` runs on the CPU (host activity only here); ``device_busy`` is
held to hand-computed shares on synthetic trace files.
"""
import json
import math
import time

import numpy as np
import pytest
import torch

from rabit_tpu.obs.metrics import Histogram as JHistogram
from rabit_tpu.utils import profiler as jprofiler
from rabit_tpu_torch.obs.metrics import Histogram
from rabit_tpu_torch.utils import profiler

QUANTILES = (0, 1, 10, 25, 50, 75, 90, 99, 100)


def _observations(kind, seed, n):
    rng = np.random.default_rng(seed)
    if kind == "latency":          # seconds, lognormal around 1 ms
        return list(rng.lognormal(np.log(1e-3), 1.5, n))
    if kind == "bytes":            # payload sizes over many octaves
        return [float(v) for v in rng.integers(1, 1 << 30, n)]
    return list(rng.standard_normal(n) * 10.0)   # signed


EDGES = {
    "one": [0.25],
    "zero": [0.0],
    "zeros": [0.0, 0.0, 0.0],
    "negatives": [-1.5, -0.25, -8.0],
    "mixed signs": [-2.0, 0.0, 3.5, 1e-3],
    "tiny": [1e-20, 3e-19],                # under the bottom bucket
    "huge": [1e30, 2.5e25],                # over the top bucket
    "powers of two": [2.0 ** e for e in range(-12, 12)],
    "repeated": [7.0] * 33,
}


def _same(port, ref):
    assert port.count == ref.count
    for attr in ("sum", "mean", "std", "min", "max"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for q in QUANTILES:
        assert port.percentile(q) == ref.percentile(q), q
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("n", [1, 2, 17, 1000])
@pytest.mark.parametrize("kind,seed", [("latency", 0), ("latency", 1),
                                       ("bytes", 2), ("signed", 3)])
def test_histogram_matches_the_reference(kind, seed, n):
    port, ref = Histogram(), JHistogram()
    for v in _observations(kind, seed, n):
        port.observe(v)
        ref.observe(v)
    _same(port, ref)
    assert port.count == n


@pytest.mark.parametrize("name", sorted(EDGES))
def test_histogram_edge_values_match_the_reference(name):
    port, ref = Histogram(), JHistogram()
    for v in EDGES[name]:
        port.observe(v)
        ref.observe(v)
    _same(port, ref)


def test_empty_histogram_matches_the_reference():
    _same(Histogram(), JHistogram())
    assert Histogram().snapshot()["min"] == 0.0


@pytest.mark.parametrize("i", [0, 1, 39, 40, 63])
def test_bucket_bounds_match_the_reference(i):
    assert Histogram.bucket_bound(i) == JHistogram.bucket_bound(i)
    v = Histogram.bucket_bound(i) * 1.5
    assert Histogram._index(v) == JHistogram._index(v)


def test_histogram_moments_are_exact():
    """Welford's mean and (population) std against numpy's, and a
    percentile within one octave of numpy's."""
    vals = _observations("latency", 9, 5000)
    h = Histogram()
    for v in vals:
        h.observe(v)
    assert math.isclose(h.mean, float(np.mean(vals)), rel_tol=1e-12)
    assert math.isclose(h.std, float(np.std(vals)), rel_tol=1e-9)
    p90 = float(np.percentile(vals, 90))
    assert p90 / 2 <= h.percentile(90) <= 2 * p90


class FakeClock:
    """``time.perf_counter`` advancing by seeded durations at each
    section's end."""

    def __init__(self, durations):
        self.now, self.durations, self.calls = 100.0, list(durations), 0

    def __call__(self):
        self.calls += 1
        if self.calls % 2 == 0:              # a section's end
            self.now += self.durations[self.calls // 2 - 1]
        return self.now


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 50), (3, 400)])
def test_timer_matches_the_reference(monkeypatch, seed, n):
    durations = _observations("latency", seed, n)
    timers = []
    for cls in (profiler.Timer, jprofiler.Timer):
        monkeypatch.setattr(time, "perf_counter", FakeClock(durations))
        timer = cls()
        for _ in range(n):
            with timer:
                pass
        timers.append(timer)
    port, ref = timers
    for attr in ("total", "count", "mean", "std", "max"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    _same(port.histogram, ref.histogram)
    assert port.count == n


def test_empty_timer_matches_the_reference():
    port, ref = profiler.Timer(), jprofiler.Timer()
    for attr in ("total", "count", "mean", "std", "max"):
        assert getattr(port, attr) == getattr(ref, attr) == 0


def test_get_time_is_monotonic():
    a = profiler.get_time()
    b = profiler.get_time()
    assert b >= a and abs(a - jprofiler.get_time()) < 60.0


# ------------------------------------------------------------------ trace
def test_trace_on_the_cpu_writes_a_recorded_op(tmp_path):
    """Host profiling on the CPU: the trace file holds the block's
    window and the matmul run in it; with no device event the busy share
    is 0."""
    with profiler.trace(str(tmp_path / "logs")) as tr:
        x = torch.randn(64, 64)
        y = x @ x
    assert y.shape == (64, 64)
    assert tr.path and tr.path.startswith(str(tmp_path / "logs"))
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert profiler.WINDOW in names
    assert "aten::mm" in names or "aten::matmul" in names
    busy = profiler.device_busy(tr.path)
    assert busy["window_us"] > 0 and busy["busy_us"] == 0
    assert busy["share"] == 0.0 and busy["by_name"] == {}


def test_two_traces_write_two_files(tmp_path):
    paths = []
    for _ in range(2):
        with profiler.trace(str(tmp_path)) as tr:
            torch.ones(3).sum()
        paths.append(tr.path)
    assert paths[0] != paths[1]


def test_trace_refuses_to_record_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="nothing to record"):
        with profiler.trace(str(tmp_path), host_profiling=False):
            pass


def _trace_file(tmp_path, events):
    path = tmp_path / "synthetic.json"
    path.write_text(json.dumps({"traceEvents": [
        dict(ph="X", pid=1, tid=1, **e) for e in events]}))
    return str(path)


def _ev(cat, name, ts, dur):
    return dict(cat=cat, name=name, ts=ts, dur=dur)


@pytest.mark.parametrize("events,window,busy", [
    # two kernels apart in a 100 us window
    ([_ev("kernel", "k", 10, 10), _ev("kernel", "k", 50, 20)], 100, 30),
    # overlapping kernel and copy count once
    ([_ev("kernel", "k", 10, 30), _ev("gpu_memcpy", "Memcpy DtoD", 20, 30)],
     100, 40),
    # work outside the window is clipped
    ([_ev("kernel", "k", -20, 30), _ev("gpu_memset", "Memset", 95, 20)],
     100, 15),
    # host events are not device work
    ([_ev("cpu_op", "aten::mm", 0, 100), _ev("cuda_runtime",
                                             "cudaLaunchKernel", 5, 5)],
     100, 0),
])
def test_device_busy_is_the_union_over_the_window(tmp_path, events, window,
                                                  busy):
    path = _trace_file(tmp_path, [_ev("user_annotation", profiler.WINDOW, 0,
                                      window)] + events)
    got = profiler.device_busy(path)
    assert got["window_us"] == window and got["busy_us"] == busy
    assert got["share"] == busy / window


def test_device_busy_by_name_and_without_a_window(tmp_path):
    """Without the window's span (host profiling off) the window runs
    from the first to the last device event; times sum by name."""
    path = _trace_file(tmp_path, [
        _ev("kernel", "void fold_kernel<float, 0>", 0, 4),
        _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 6, 2),
        _ev("kernel", "void fold_kernel<float, 0>", 10, 6)])
    got = profiler.device_busy(path)
    assert got["window_us"] == 16 and got["busy_us"] == 12
    assert got["by_name"]["void fold_kernel<float, 0>"] == (10.0, 2)
    assert got["by_category_us"] == {"kernel": 10.0, "gpu_memcpy": 2.0,
                                     "gpu_memset": 0.0}
    with pytest.raises(ValueError, match="no window"):
        profiler.device_busy(_trace_file(tmp_path, []))
