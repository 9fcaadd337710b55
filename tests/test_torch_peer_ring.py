"""The ring across rank processes (``rabit_tpu_torch/parallel/peer_ring.py``)
in its CPU mode, ranks on threads of this process.

Each rank thread has a gloo group of its own (one in-process
``HashStore``, loopback TCP, as the device-plane engine forms them) and a
``PeerRing`` whose exchange is that group's allgather; the inboxes are
shared-memory files and the fold is ``ring_fold_one``, the kernel's
order in plain PyTorch.  Inputs are made from a seed with numpy.  Bar:
every rank's result has the bits of the JAX package's
``ring_allreduce_pallas`` (interpret mode, on the 8-device CPU mesh of
``tests/conftest.py``) where a case runs it, else of the port's plain
ring ``_ring_plain`` (the hops themselves, which
``tests/test_torch_ring_fold.py`` holds against the JAX kernel); NaN
positions equal, NaN payloads free.  Pallas runs the twelve (op, dtype)
pairs at world 2 and one pair at each of worlds 3 to 5; the plain ring
every pair at every world, since the interpreter takes about half a
second a call at world 2 and over two at world 5.

The host protocol -- the exchange, the parity inboxes, growth, the start
barrier's verdicts and its deadline, cleanup -- is tested here without
the engine.  No test launches a process, and every join, barrier and
exchange has a deadline of at most 10 s.
"""
import datetime
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from rabit_tpu.ops import ReduceOp as JOp
from rabit_tpu.ops.ring_allreduce import ring_allreduce_pallas
from rabit_tpu_torch.engine import xla
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import ring_allreduce as rg
from rabit_tpu_torch.parallel import peer_ring as pr

JOIN_SEC = 10.0                  # every world's threads, all together
GROUP_SEC = 5                    # the gloo groups' timeout
OPS = ("SUM", "MAX", "MIN", "PROD")
DTYPES = ("float32", "bfloat16", "int32")


# ------------------------------------------------------------ the harness
def _close_group(group):
    for name in ("abort", "shutdown"):
        fn = getattr(group, name, None)
        if fn is not None:
            try:
                fn()
                return
            except RuntimeError:
                pass


def run_ranks(world, body, ring_timeout=5.0, capacity=pr.MIN_CAPACITY,
              tag="test"):
    """One thread a rank, each with its own gloo group and ``PeerRing``;
    ``body(rank, ring)`` runs between the table's formation and its
    close.  Returns each rank's result and the rings (closed); raises the
    first rank's error."""
    store = dist.HashStore()
    results, rings, errs = [None] * world, [None] * world, []

    def run(rank):
        group = None
        try:
            group = xla.new_group(dist.PrefixStore("t/", store), rank, world,
                                  "gloo", datetime.timedelta(
                                      seconds=GROUP_SEC), "127.0.0.1")

            def exchange(record):
                t = torch.frombuffer(bytearray(record), dtype=torch.uint8)
                parts = [torch.empty_like(t) for _ in range(world)]
                group.allgather([parts], [t]).wait()
                return [p.numpy().tobytes() for p in parts]

            ring = rings[rank] = pr.PeerRing(rank, world, exchange, "cpu",
                                             ring_timeout, tag=tag,
                                             capacity=capacity)
            try:
                results[rank] = body(rank, ring)
            finally:
                ring.close()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append((rank, e))
        finally:
            if group is not None:
                _close_group(group)

    threads = [threading.Thread(target=run, args=(r,), name=f"rank{r}",
                                daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_SEC
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    assert not any(t.is_alive() for t in threads), "a rank thread hangs"
    if errs:
        raise errs[0][1]
    return results, rings


def _inputs(world, size, dtype, op, seed, nan=False):
    """Each rank's input as a torch tensor; PROD takes factors near 1."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, (world, size)).astype(np.int32)
        return [torch.from_numpy(r.copy()) for r in x]
    x = rng.standard_normal((world, size)).astype(np.float32)
    if nan:
        x[rng.random(x.shape) < 0.01] = np.nan
    t = torch.from_numpy(x)
    if op == "PROD":
        t = 1.0 + 0.1 * t
    return [r.to(getattr(torch, dtype)) for r in t]


def _ring_world(xs, op):
    """Each rank's result of the peer ring on ``xs``."""
    got, _ = run_ranks(len(xs), lambda r, ring: ring.allreduce(
        xs[r], ReduceOp[op]))
    return got


def _pallas(xs, op):
    """Each rank's result of ``ring_allreduce_pallas`` (interpret mode)."""
    ndev, dtype = len(xs), xs[0].dtype
    mesh = JMesh(np.array(jax.devices()[:ndev]), ("x",))
    fn = jax.jit(jax.shard_map(
        lambda s: ring_allreduce_pallas(s[0], "x", op=JOp[op],
                                        interpret=True)[None],
        mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False))
    stacked = torch.stack(xs)
    if dtype == torch.int32:
        out = np.asarray(fn(jnp.asarray(stacked.numpy())))
        return [torch.from_numpy(r.copy()) for r in out]
    jdt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    out = np.asarray(fn(jnp.asarray(stacked.float().numpy()).astype(jdt))
                     .astype(jnp.float32))
    return [torch.from_numpy(r.copy()).to(dtype) for r in out]


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype.is_floating_point:
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(w))
            g, w = g.masked_fill(nan, 0), w.masked_fill(nan, 0)
        width = torch.int16 if g.element_size() == 2 else torch.int32
        assert torch.equal(g.view(width), w.view(width))


def _leftovers():
    """This process's files of tables tagged "test"."""
    prefix = f"rabit_ring.test.{os.getpid()}."
    return [n for n in os.listdir(pr.shm_dir()) if n.startswith(prefix)]


# ------------------------------------------------- the ring's bits
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_bits_match_pallas_at_world_2(op, dtype):
    xs = _inputs(2, 1000, dtype, op, seed=100 + OPS.index(op))
    _same_bits(_ring_world(xs, op), _pallas(xs, op))


@pytest.mark.parametrize("world,op,dtype", [(3, "SUM", "float32"),
                                            (4, "MAX", "bfloat16"),
                                            (5, "PROD", "int32")])
def test_bits_match_pallas_at_larger_worlds(world, op, dtype):
    xs = _inputs(world, 3 * 128 + 5, dtype, op, seed=world)
    _same_bits(_ring_world(xs, op), _pallas(xs, op))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", [2, 3, 4, 5])
def test_bits_match_the_plain_ring(world, dtype):
    """Every op in turn on one table, each against the port's plain
    ring; the inputs are left as they were."""
    xs = {op: _inputs(world, 1000, dtype, op, seed=7 * world + len(op))
          for op in OPS}
    before = {op: [x.clone() for x in v] for op, v in xs.items()}

    def body(rank, ring):
        return {op: ring.allreduce(xs[op][rank], ReduceOp[op]) for op in OPS}

    got, _ = run_ranks(world, body)
    for op in OPS:
        _same_bits([g[op] for g in got], rg._ring_plain(xs[op], ReduceOp[op]))
        _same_bits(xs[op], before[op])


@pytest.mark.parametrize("size", [1, 127, 128, 129, 3 * 128 + 5])
def test_chunk_edges_match_pallas(size):
    xs = _inputs(2, size, "float32", "SUM", seed=size)
    _same_bits(_ring_world(xs, "SUM"), _pallas(xs, "SUM"))


def test_segmented_payload_matches_the_plain_ring():
    """Over 2^20 float32 elements the ring's 8 MB segmenting makes more
    than one segment, which moves the chunk boundaries."""
    size = 3 * 2733 * 128 - 5         # 2^20 + 1,691 elements
    unsegmented = -(-(-(-size // 3)) // 128) * 128
    assert rg.pallas_chunk(size, 3, 4) > unsegmented
    xs = _inputs(3, size, "float32", "SUM", seed=3)
    _same_bits(_ring_world(xs, "SUM"), rg._ring_plain(xs, ReduceOp.SUM))


@pytest.mark.parametrize("op", ["MAX", "MIN"])
def test_nan_positions_match_pallas(op):
    xs = _inputs(2, 3 * 128 + 5, "float32", op, seed=41, nan=True)
    got = _ring_world(xs, op)
    _same_bits(got, _pallas(xs, op))
    anynan = torch.isnan(torch.stack(xs)).any(0)
    assert anynan.any() and all(torch.equal(torch.isnan(g), anynan)
                                for g in got)


# ------------------------------------------------- parity and reuse
def test_parity_inboxes_alternate_and_are_reused():
    """Op ``seq`` copies into inbox ``seq % 2``: ops 1 and 3 use one
    inbox, op 2 the other, and each op's result is its own."""
    xs = [[torch.full((300,), float(10 * s + r)) for r in range(3)]
          for s in range(3)]

    def body(rank, ring):
        used, outs = [], []
        for s in range(3):
            outs.append(ring.allreduce(xs[s][rank]))
            own = ring._own[ring.seq % 2][0]
            used.append(own.data_ptr())
            assert float(own[:4].view(torch.float32)[0]) == 10 * s + rank
        return used, outs

    got, _ = run_ranks(3, body)
    for used, outs in got:
        assert used[0] == used[2] != used[1]
        for s in range(3):
            assert torch.equal(outs[s], torch.full((300,), 30.0 * s + 3))


@pytest.mark.parametrize("slow", ["fold", "copy"])
def test_a_slow_rank_never_sees_a_later_op(slow, monkeypatch):
    """Rank 1 is held 0.2 s inside its fold of op 1 (or before its copy
    of op 3) while the others race on with other inputs: every rank's
    result of every op is still that op's."""
    real = rg.ring_fold_one
    held = []

    def fold(xs, op=ReduceOp.SUM):
        if (slow == "fold" and threading.current_thread().name == "rank1"
                and not held):
            held.append(1)
            time.sleep(0.2)
        return real(xs, op)

    monkeypatch.setattr(rg, "ring_fold_one", fold)
    xs = [[torch.full((500,), float(100 * s + r)) for r in range(3)]
          for s in range(4)]

    def body(rank, ring):
        outs = []
        for s in range(4):
            if slow == "copy" and rank == 1 and s == 2:
                time.sleep(0.2)
            outs.append(ring.allreduce(xs[s][rank]))
        return outs

    got, _ = run_ranks(3, body)
    for outs in got:
        for s in range(4):
            assert torch.equal(outs[s], torch.full((500,), 300.0 * s + 3))


# ------------------------------------------------------------- growth
@pytest.mark.parametrize("world", [2, 4])
def test_growth_is_in_step_and_closes_old_handles(world):
    """Rising sizes regrow every rank at the same op, by powers of two;
    a rank holds open only the current inboxes of its peers, and every
    file a growth made is gone once its op's barrier has passed."""
    sizes = [10, 1000, 1024, 5000, 100_000, 7]

    def body(rank, ring):
        seen = []
        for n in sizes:
            x = torch.arange(n, dtype=torch.float32) + rank
            out = ring.allreduce(x)
            assert torch.equal(out, world * torch.arange(
                n, dtype=torch.float32) + world * (world - 1) / 2)
            seen.append((ring.capacity, ring.grown, ring.open_handles(),
                         ring.files()))
        return seen

    got, _ = run_ranks(world, body)
    assert all(g == got[0] for g in got)
    assert [c for c, *_ in got[0]] == [4096, 4096, 4096, 32768, 524288,
                                       524288]
    assert [g for _, g, *_ in got[0]] == [0, 0, 0, 1, 2, 2]
    assert all(h == 2 * (world - 1) and f == [] for *_, h, f in got[0])
    assert _leftovers() == []


# ---------------------------------------------------- the start barrier
def _page(tmp_path, world):
    path = str(tmp_path / "page")
    return [pr.StartBarrier(path, r, world, create=(r == 0))
            for r in range(world)]


def test_barrier_goes_when_every_rank_posted(tmp_path):
    bars = _page(tmp_path, 3)
    for b in bars:
        b.post(1)
    assert all(b.wait(1, 1.0) < 0.5 for b in bars)
    for b in bars:
        b.close()


def test_a_go_verdict_stands_past_the_deadline(tmp_path):
    """Once one rank has seen every slot posted, a rank whose own
    deadline has passed follows the go verdict and does not give up."""
    bars = _page(tmp_path, 2)
    bars[0].post(1)
    bars[1].post(1)
    bars[1].wait(1, 1.0)
    bars[1].post(2)                        # rank 1 already on the next op
    assert bars[0].wait(1, 0.0) >= 0.0
    for b in bars:
        b.close()


def test_barrier_gives_up_at_once_on_a_gone_process(tmp_path):
    bars = _page(tmp_path, 2)
    dead = next(p for p in range(4_000_000, 3_000_000, -1)
                if pr._process_gone(p))
    bars[0]._pids[1] = dead
    bars[0].post(1)
    t = time.monotonic()
    with pytest.raises(rg.PeerError, match="connection closed") as err:
        bars[0].wait(1, 8.0)
    assert time.monotonic() - t < 0.5
    assert xla._is_runtime_failure(err.value)
    for b in bars:
        b.close()


@pytest.mark.parametrize("silent", [0, 2])
def test_a_peer_that_never_posts_times_out_the_others(silent):
    """The silent rank (0 holds the page) joins the table and never
    calls the op: the others raise within the deadline plus 0.5 s with
    a transport marker, and the engine counts it a runtime failure."""
    deadline = 0.5
    release = threading.Event()
    raised = threading.Barrier(2, action=release.set)

    def body(rank, ring):
        if rank == silent:
            release.wait(JOIN_SEC / 2)        # the others have raised
            return None
        t = time.monotonic()
        try:
            ring.allreduce(torch.ones(256))
        except rg.PeerError as e:
            return time.monotonic() - t, e
        finally:
            raised.wait(JOIN_SEC / 2)
        return None

    got, _ = run_ranks(3, body, ring_timeout=deadline)
    tooks = [got[r][0] for r in range(3) if r != silent]
    # the first to time out decides for both: the other may read the
    # verdict a little before its own deadline
    assert max(tooks) >= deadline and all(t < deadline + 0.5 for t in tooks)
    for rank, res in enumerate(got):
        if rank != silent:
            err = res[1]
            assert "timed out" in str(err) and xla._is_runtime_failure(err)


def test_a_rank_that_leaves_the_table_frees_its_waiting_peers():
    """Rank 2 closes its table instead of joining the op (as a rank that
    degraded for another reason does): the others give up at their next
    check, long before their 8 s deadline."""
    formed = threading.Barrier(3)

    def body(rank, ring):
        formed.wait(JOIN_SEC / 2)        # every rank has opened the files
        if rank == 2:
            ring.close()
            return None
        t = time.monotonic()
        with pytest.raises(rg.PeerError) as err:
            ring.allreduce(torch.ones(256))
        return time.monotonic() - t, str(err.value)

    got, _ = run_ranks(3, body, ring_timeout=8.0)
    assert all(took < 0.5 for took, _ in got[:2])
    assert any("(2, -1)" in msg and "left the table" in msg
               for _, msg in got[:2])


def test_a_rank_that_fails_before_its_post_abandons_the_op(tmp_path):
    """A rank whose copy or growth fails gives up the op for everyone:
    a peer already waiting reads the verdict and raises at once."""
    bars = _page(tmp_path, 2)
    bars[1].post(1)
    bars[0].abandon(1)
    t = time.monotonic()
    with pytest.raises(rg.PeerError, match="by a peer"):
        bars[1].wait(1, 8.0)
    assert time.monotonic() - t < 0.5
    for b in bars:
        b.close()


def test_a_late_rank_follows_the_abandoned_verdict():
    """Rank 2 posts after the others gave up on the op: it reads their
    verdict and raises too, never folding an op they abandoned."""
    def body(rank, ring):
        if rank == 2:
            time.sleep(0.6)
        try:
            ring.allreduce(torch.ones(256))
        except rg.PeerError as e:
            return str(e)
        return "folded"

    got, _ = run_ranks(3, body, ring_timeout=0.3)
    assert all(g != "folded" for g in got)
    assert "timed out" in got[0] and "by a peer" in got[2]


# ------------------------------------------------ refusals and cleanup
def test_close_leaves_no_file_and_no_handle():
    def body(rank, ring):
        before = ring.files()
        ring.allreduce(torch.ones(2000))
        after_op = ring.files()
        ring.close()
        ring.close()                       # idempotent
        return before, after_op, ring.open_handles(), ring.files()

    got, _ = run_ranks(3, body)
    assert len(got[0][0]) == 3 and len(got[1][0]) == 2   # page + inboxes
    assert all(a == [] and h == 0 and f == [] for _, a, h, f in got)
    assert _leftovers() == []


def test_the_caller_errors_raise_before_any_byte_moves():
    def body(rank, ring):
        with pytest.raises(ValueError, match="unsupported op"):
            ring.allreduce(torch.ones(4, dtype=torch.int32), ReduceOp.BITOR)
        with pytest.raises(TypeError, match="float32, bfloat16 or int32"):
            ring.allreduce(torch.ones(4, dtype=torch.float64))
        with pytest.raises(ValueError, match="empty"):
            ring.allreduce(torch.ones(0))
        with pytest.raises(ValueError, match="lives on cpu"):
            ring.allreduce(torch.ones(4, device="meta"))
        assert ring.seq == 0
        return ring.allreduce(torch.ones(4)).tolist()

    got, _ = run_ranks(2, body)
    assert got == [[2.0] * 4] * 2
    for world in (1, pr.MAX_PEERS + 1):
        with pytest.raises(ValueError, match="world"):
            pr.PeerRing(0, world, None, "cpu", 1.0)


def test_cuda_route_raises_without_the_toolkit(monkeypatch, tmp_path):
    """On a CUDA device the table's inboxes come from the kernel's
    library, built at first use; without nvcc it raises, leaves no file
    and counts no launch."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(rg, "_LIB", None)
    monkeypatch.setattr("shutil.which", lambda _name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    launches = rg.LAUNCHES["ring_allreduce"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pr.PeerRing(0, 2, lambda rec: [rec, rec], "cuda", 1.0, tag="test")
    with pytest.raises(TypeError, match="float32, bfloat16 or int32"):
        rg.ring_allreduce_peer([0, 0], 3, ReduceOp.SUM,
                               torch.ones(3, dtype=torch.float64))
    assert rg.LAUNCHES["ring_allreduce"] == launches
    assert _leftovers() == []
