"""The port's async pump and bucket fusion against rabit_tpu's, on threads
in one process.

A port world and a reference world (``rabit_tpu``'s ``PySocketEngine``)
run the same seeded stream of async allreduces — sizes on both sides of
the 64 KiB tree/ring crossover and of the bucket limit, SUM/MAX/MIN/PROD
over int64/float32/float64, ``fuse`` on and off, blocking ops and
``allgather_async`` in between — and every result must carry the same
bits.  Under the static schedule the fused results must also equal the
blocking results op by op; under a forced schedule the bucket rides the
concatenate path.  Mixed worlds put port and reference ranks in one job
with ``fuse=True`` streams, the case that did not meet on the wire while
the port ran each async op at issue time.  The engines run as in
``tests/test_torch_pysocket.py``, whose world runner this file uses.
"""
import threading

import numpy as np
import pytest

import rabit_tpu
import rabit_tpu_torch
from rabit_tpu import engine as jengine_mod
from rabit_tpu.engine.interface import CollectiveHandle as JHandle
from rabit_tpu.engine.pysocket import AsyncPumpError as JAsyncPumpError
from rabit_tpu.engine.pysocket import PySocketEngine as JEngine
from rabit_tpu_torch import engine as engine_mod
from rabit_tpu_torch.engine.interface import AsyncOrderError, CollectiveHandle
from rabit_tpu_torch.engine.pysocket import (DEFAULT_BUCKET_BYTES,
                                             AsyncPumpError, PySocketEngine)
from test_torch_pysocket import (CONFIGS, OPCODES, OVER, _env,  # noqa: F401
                                 _inputs, _run_world)

BIG = 140_000           # float64 elements: 1.12 MB, over the 1 MiB bucket
DTYPES = [np.int64, np.float32, np.float64]
OPS = ["SUM", "MAX", "MIN", "PROD"]


def _stream_spec():
    """The op stream every rank issues: (size, dtype, op, fuse) in issue
    order, with a blocking allreduce after every 7th op and an
    ``allgather_async`` after every 5th."""
    rng = np.random.default_rng(13)
    sizes = [1, 3, 7, 100, 513, 1001, 4097, 9000, OVER, BIG]
    spec = []
    for i in range(40):
        dtype = DTYPES[(i // 4) % 3]
        size = sizes[int(rng.integers(len(sizes)))]
        if size == BIG and dtype != np.float64:
            size = OVER
        spec.append((size, dtype, OPS[i % 4], bool(i % 6 != 5)))
    # a run of same-op float32 ops that fill the default bucket
    spec += [(30_000, np.float32, "SUM", True)] * 9
    return spec


STREAM = _stream_spec()


def _stream(eng, kind):
    """Issue the stream, then wait for every handle in issue order."""
    codes = OPCODES[kind]
    pending, blocking = [], []
    for i, (size, dtype, op, fuse) in enumerate(STREAM):
        a = _inputs(eng.rank, size, dtype, op)
        pending.append(("ar", eng.allreduce_async(a, getattr(codes, op),
                                                  fuse=fuse)))
        if i % 5 == 4:
            mine = np.full((2, 3), eng.rank * 10 + i, np.int32)
            pending.append(("ag", eng.allgather_async(mine)))
        if i % 7 == 6:
            b = _inputs(eng.rank, 257, np.float64, "SUM")
            blocking.append(eng.allreduce(b, codes.SUM).copy())
    out = [(tag, h.wait().copy()) for tag, h in pending]
    return out, blocking


def _blocking_stream(eng, kind):
    """The same allreduces, each on its own and blocking."""
    codes = OPCODES[kind]
    out = []
    for size, dtype, op, _fuse in STREAM:
        a = _inputs(eng.rank, size, dtype, op)
        out.append(eng.allreduce(a, getattr(codes, op)).copy())
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gt, g), (wt, w) in zip(got, want):
        assert gt == wt
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _int_sums_exact(res, world):
    ars = [a for tag, a in res if tag == "ar"]
    for (size, dtype, op, _f), a in zip(STREAM, ars):
        if dtype == np.int64 and op == "SUM":
            exact = sum(_inputs(r, size, dtype, op) for r in range(world))
            np.testing.assert_array_equal(a, exact)


def _params(world, bucket, **kw):
    extra = {} if bucket is None else {"rabit_bucket_bytes": bucket}
    return [dict(CONFIGS[r % len(CONFIGS)], **extra, **kw)
            for r in range(world)]


@pytest.mark.parametrize("bucket", [None, 0, 4096],
                         ids=["default", "off", "4096"])
@pytest.mark.parametrize("world", [2, 3, 4, 5])
def test_stream_bit_parity(world, bucket):
    """The port's async stream gives the reference's bits on every rank,
    with mixed pipeline depths and reduce buffers in one world; under the
    static schedule each fused result equals its blocking run (with
    fusion off every op already runs alone); integer sums are exact."""
    params = _params(world, bucket)
    got = _run_world(["torch"] * world, _stream, params)
    want = _run_world(["jax"] * world, _stream, params)
    for rank in range(world):
        _same(got[rank][0], want[rank][0])
        _same(got[rank][0], got[0][0])
        for g, w in zip(got[rank][1], want[rank][1]):
            assert g.tobytes() == w.tobytes()
    _int_sums_exact(got[0][0], world)
    if bucket == 0:
        return
    solo = _run_world(["torch"] * world, _blocking_stream, params)
    for rank in range(world):
        ars = [a for tag, a in got[rank][0] if tag == "ar"]
        assert len(ars) == len(solo[rank])
        for a, b in zip(ars, solo[rank]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("world", [3, 4, 5])
@pytest.mark.parametrize("sched", ["ring", "halving"])
def test_stream_forced_schedule_parity(sched, world):
    """Under a forced schedule a bucket concatenates and rides that
    schedule for its whole size: the reference's bits, integer sums
    exact."""
    params = _params(world, None, rabit_sched=sched)
    got = _run_world(["torch"] * world, _stream, params)
    want = _run_world(["jax"] * world, _stream, params)
    for rank in range(world):
        _same(got[rank][0], want[rank][0])
        _same(got[rank][0], got[0][0])
    _int_sums_exact(got[0][0], world)


@pytest.mark.parametrize("bucket", [None, 4096], ids=["default", "4096"])
@pytest.mark.parametrize("tracker", ["torch", "jax"])
def test_mixed_world_fused_stream(tracker, bucket):
    """Port ranks 1 and 3 with reference ranks 0 and 2 run ``fuse=True``
    streams in one world of 4 under either tracker, with the bits of an
    all-reference world."""
    params = _params(4, bucket)
    mixed = _run_world(["jax", "torch", "jax", "torch"], _stream, params,
                       tracker=tracker)
    ref = _run_world(["jax"] * 4, _stream, params, tracker="jax")
    for rank in range(4):
        _same(mixed[rank][0], ref[rank][0])
        for g, w in zip(mixed[rank][1], ref[rank][1]):
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kinds", [["torch", "jax", "torch"],
                                   ["jax", "torch", "torch", "jax", "torch"]],
                         ids=["world3", "world5"])
def test_mixed_world_fused_stream_odd_worlds(kinds):
    """Odd mixed worlds, where the ring carries the fused segmented
    walk across port and reference ranks."""
    params = _params(len(kinds), None)
    mixed = _run_world(kinds, _stream, params)
    ref = _run_world(["jax"] * len(kinds), _stream, params, tracker="jax")
    for rank in range(len(kinds)):
        _same(mixed[rank][0], ref[rank][0])


# ------------------------------------------------------ wire ops a bucket
def _count_fused(eng, kind):
    """Wire ops of a stream of 32 histograms of 131,584 B (GBDT's
    per-node (64, 257, 2) float32 level), as the engine's fused body
    sees them."""
    real = eng._fused_allreduce_exec
    buckets = []

    def counted(items, *a, **kw):
        buckets.append(len(items))
        return real(items, *a, **kw)
    eng._fused_allreduce_exec = counted
    codes = OPCODES[kind]
    rng = np.random.default_rng(eng.rank)
    hs = [eng.allreduce_async(rng.standard_normal(64 * 257 * 2).astype(
        np.float32), codes.SUM) for _ in range(32)]
    out = [h.wait().copy() for h in hs]
    return buckets, out


@pytest.mark.parametrize("kinds", [["torch"] * 3, ["jax"] * 3,
                                   ["torch", "jax", "torch"]],
                         ids=["port", "reference", "mixed"])
def test_per_node_histograms_fuse_seven_a_bucket(kinds):
    """32 per-node histograms of 131,584 B fill ceil(32 / 7) = 5 buckets
    of the default 1 MiB on every rank, port and reference alike."""
    assert DEFAULT_BUCKET_BYTES == 1 << 20
    got = _run_world(kinds, _count_fused)
    for rank in range(3):
        assert got[rank][0] == [7, 7, 7, 7, 4]
        for a, b in zip(got[rank][1], got[0][1]):
            assert a.tobytes() == b.tobytes()


# -------------------------------------------------------- handle contract
def _order(eng, kind):
    codes = OPCODES[kind]
    a, b = np.ones(4), np.ones(4)
    h1 = eng.allreduce_async(a, codes.SUM)
    h2 = eng.allreduce_async(b, codes.SUM)
    try:
        h2.wait()
    except Exception as e:  # noqa: BLE001 — returned for the assertion
        err = type(e).__name__
    else:
        err = None
    first = h1.wait()
    again = h1.wait(timeout=0)
    return err, first is a, again is a, h2.wait().tolist(), \
        h2.wait().tolist()


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_out_of_order_wait_raises_and_waits_are_idempotent(kind):
    got = _run_world([kind] * 2, _order)
    for rank in range(2):
        assert got[rank] == ("AsyncOrderError", True, True, [2.0] * 4,
                             [2.0] * 4)


FENCES = {
    "allreduce": lambda eng, c: eng.allreduce(np.ones(3), c.SUM),
    "allgather": lambda eng, c: eng.allgather(np.ones(3)),
    "broadcast": lambda eng, c: eng.broadcast(
        b"x" if eng.rank == 0 else None, 0),
    "allreduce_custom": lambda eng, c: eng.allreduce_custom(
        np.ones(3), np.add),
    "checkpoint": lambda eng, c: eng.checkpoint(b"g"),
    "load_checkpoint": lambda eng, c: eng.load_checkpoint(),
    "shutdown": lambda eng, c: _shutdown_once(eng),
}


def _shutdown_once(eng):
    """Shut down inside the body; the world runner's own shutdown then
    skips the tracker, which has already seen this rank leave (a second
    goodbye would dial a tracker that may have exited)."""
    eng.shutdown()
    eng._tracker_addr = None


@pytest.mark.parametrize("fence", sorted(FENCES))
def test_blocking_calls_fence_the_stream(fence):
    """A blocking collective, a checkpoint call or shutdown returns only
    once every async op issued before it has run: a pending bucket
    flushes and the queue drains, with nothing waited."""
    def body(eng, kind):
        codes = OPCODES[kind]
        hs = [eng.allreduce_async(np.full(5, eng.rank + i, np.float64),
                                  codes.SUM) for i in range(4)]
        hs.append(eng.allreduce_async(np.ones(20000), codes.SUM,
                                      fuse=False))
        FENCES[fence](eng, codes)
        done = [h.done() for h in hs]
        return done, [h.wait().sum() for h in hs]

    for kind in ("torch", "jax"):
        got = _run_world([kind] * 3, body)
        for rank in range(3):
            done, sums = got[rank]
            assert done == [True] * 5, (kind, rank)
            assert sums == [5 * (3 + 3 * i) for i in range(4)] + [60000.0]


class _PumpDeath(BaseException):
    """Stands in for a pump-killing failure (KeyboardInterrupt-like)."""


@pytest.mark.parametrize("engine", [PySocketEngine, JEngine],
                         ids=["torch", "jax"])
def test_pump_death_poisons_pending_handles(engine):
    """A BaseException killing the progress pump fails every queued and
    later handle, so no wait() hangs, and the fence returns (as the
    reference's own chaos test drives it)."""
    pump_error = AsyncPumpError if engine is PySocketEngine \
        else JAsyncPumpError
    handle = CollectiveHandle if engine is PySocketEngine else JHandle
    eng = engine()
    h1, h2 = handle(), handle()

    def boom():
        raise _PumpDeath("injected pump death")

    started = threading.Event()
    eng._submit(started.wait, (handle(),))
    eng._submit(boom, (h1,))
    eng._submit(lambda: None, (h2,))
    started.set()
    with pytest.raises((_PumpDeath, pump_error)):
        h1.wait(timeout=30)
    with pytest.raises(pump_error) as err:
        h2.wait(timeout=30)
    assert isinstance(err.value.__cause__, _PumpDeath)
    eng._fence()  # returns: the poison zeroed the in-flight count
    h3 = handle()
    eng._submit(lambda: None, (h3,))  # a post-death issue fails at once
    assert h3.done()
    with pytest.raises(pump_error):
        h3.wait(timeout=0)
    eng._stop_pump()


def test_pump_death_in_a_live_world_fails_the_stream():
    """Both ranks' pumps die on their second bucket: the first bucket's
    results stand, the dying bucket's handles raise the failure itself,
    an op issued after the death raises AsyncPumpError at once, and a
    blocking op after the death still runs."""
    def body(eng, kind):
        real = eng._fused_allreduce_exec
        calls = []

        def dying(items, op):
            calls.append(len(items))
            if len(calls) == 2:
                raise _PumpDeath("injected")
            return real(items, op)
        eng._fused_allreduce_exec = dying
        codes = OPCODES[kind]
        first = [eng.allreduce_async(np.ones(3), codes.SUM)
                 for _ in range(3)]
        eng.allreduce(np.zeros(1), codes.SUM)       # fences bucket 1
        later = [eng.allreduce_async(np.ones(3), codes.SUM)
                 for _ in range(3)]
        errs = []
        for h in first + later:
            try:
                errs.append(h.wait(timeout=30).tolist())
            except (AsyncPumpError, _PumpDeath) as e:
                errs.append(type(e).__name__)
        post = eng.allreduce_async(np.ones(2), codes.SUM, fuse=False)
        try:
            post.wait(timeout=30)
        except AsyncPumpError:
            errs.append("poisoned")
        errs.append(eng.allreduce(np.ones(2), codes.SUM).tolist())
        return errs

    got = _run_world(["torch"] * 2, body)
    for rank in range(2):
        assert got[rank] == [[2.0] * 3] * 3 + ["_PumpDeath"] * 3 + [
            "poisoned", [2.0, 2.0]]


def test_world_one_handles_are_born_resolved():
    def body(eng, kind):
        codes = OPCODES[kind]
        a = np.arange(4.0)
        h = eng.allreduce_async(a, codes.SUM)
        g = eng.allgather_async(np.arange(3))
        return (h.done(), g.done(), h.wait() is a, g.wait().shape,
                eng._aq_thread is None)

    for kind in ("torch", "jax"):
        assert _run_world([kind], body)[0] == (True, True, True, (1, 3),
                                               True)


def test_tensor_payloads_are_refused_by_the_async_calls():
    import torch

    eng = PySocketEngine()
    for call in (lambda: eng.allreduce_async(torch.zeros(3), None),
                 lambda: eng.allgather_async(torch.zeros(3)),
                 lambda: eng.allreduce_custom(torch.zeros(3), np.add)):
        with pytest.raises(TypeError, match="torch.Tensor"):
            call()


# ---------------------------------------------------------------- the API
@pytest.fixture
def thread_engines(monkeypatch):
    """Each rank thread's api calls reach its own engine: both packages'
    ``get_engine`` read a thread-local slot set by the body."""
    local = threading.local()
    monkeypatch.setattr(engine_mod, "get_engine", lambda: local.eng)
    monkeypatch.setattr(jengine_mod, "get_engine", lambda: local.eng)
    return local


@pytest.mark.parametrize("world", [2, 3])
def test_allreduce_many_matches_per_array_allreduce(world, thread_engines):
    """``allreduce_many`` over arrays on both sides of the crossover and
    of a 4096-byte bucket equals per-array ``allreduce`` bit for bit, and
    the reference's ``allreduce_many``; ``allgather_async`` through the
    API gives the blocking gather."""
    sizes = [1, 5, 100, 600, 20000, 3, 7]

    def body(eng, kind):
        thread_engines.eng = eng
        pkg = rabit_tpu_torch if kind == "torch" else rabit_tpu
        arrays = [_inputs(eng.rank, s, np.float32, "SUM") for s in sizes]
        many = [a.copy() for a in pkg.allreduce_many(arrays)]
        one = [pkg.allreduce(_inputs(eng.rank, s, np.float32, "SUM"))
               for s in sizes]
        gathered = pkg.allgather_async(np.arange(4) + eng.rank).wait()
        return many, one, gathered

    params = [{"rabit_bucket_bytes": 4096}] * world
    got = _run_world(["torch"] * world, body, params)
    want = _run_world(["jax"] * world, body, params)
    for rank in range(world):
        many, one, gathered = got[rank]
        for a, b, c in zip(many, one, want[rank][0]):
            assert a.tobytes() == b.tobytes() == c.tobytes()
        np.testing.assert_array_equal(
            gathered, np.stack([np.arange(4) + r for r in range(world)]))
