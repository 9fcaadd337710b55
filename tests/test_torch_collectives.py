"""The port's in-process data plane against the JAX package's.

On the 8-device CPU mesh that ``tests/conftest.py`` sets up, the same
seeded numpy inputs go through the JAX collectives (inside
``shard_map``, the Pallas ring in interpret mode) and through the
port's, which take one CPU tensor per logical rank (the plain versions).
The ring kernel itself (B4) is held against its plain version on the
card by ``chip_smoke.py``.

Bars: the plain ring is bit-equal to ``ring_allreduce_pallas``, and the
port's explicit ring to the JAX lax ring; the named collectives are
allclose at ``rtol=1e-5, atol=1e-5`` and exact on integer-valued and
bitwise inputs; the data-parallel steps of ``dryrun_multichip`` match
with counts exact and sums within ``rtol=1e-4, atol=1e-3``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from rabit_tpu.learn import histogram as jhg
from rabit_tpu.learn import kmeans as jkm
from rabit_tpu.ops import ReduceOp as JOp
from rabit_tpu.ops.histogram_kernel import hist_fused_multi as j_hist
from rabit_tpu.ops.kmeans_kernel import (kmeans_ell_stats_fused as j_ell,
                                         kmeans_stats_fused as j_dense)
from rabit_tpu.ops.ring_allreduce import ring_allreduce_pallas
from rabit_tpu.parallel import collectives as JC
from rabit_tpu.parallel import mesh as jmesh
from rabit_tpu_torch.learn import histogram as thg
from rabit_tpu_torch.learn import kmeans as tkm
from rabit_tpu_torch.ops import ReduceOp, _build
from rabit_tpu_torch.ops import histogram_kernel as thk
from rabit_tpu_torch.ops import kmeans_kernel as tkk
from rabit_tpu_torch.ops import ring_allreduce as tring
from rabit_tpu_torch.parallel import collectives as TC
from rabit_tpu_torch.parallel import mesh as tmesh
from rabit_tpu_torch.tools import ici_bench

NAMED_TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-4, atol=1e-3)


def _jmesh(ndev):
    return JMesh(np.array(jax.devices()[:ndev]), ("x",))


def _on_jax_mesh(fn, x, in_spec=P("x"), out_spec=P("x")):
    """Run ``fn`` on each row of ``x`` (one per device), shard_map'd."""
    f = jax.jit(jax.shard_map(lambda s: fn(s[0])[None], mesh=_jmesh(len(x)),
                              in_specs=in_spec, out_specs=out_spec,
                              check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


def _ranks(x):
    return [torch.from_numpy(np.ascontiguousarray(r)) for r in x]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


# ------------------------------------------------------------ the rings
_PALLAS_CASES = [
    (4, (1000,), "SUM", "float32"),
    (3, (1000,), "SUM", "float32"),
    (8, (2048,), "MAX", "float32"),
    (2, (257,), "MIN", "float32"),
    (4, (17, 9), "SUM", "float32"),
    (8, (1000,), "PROD", "float32"),
    (4, (1000,), "SUM", "bfloat16"),
]


@pytest.mark.parametrize("ndev,shape,op,dtype", _PALLAS_CASES)
def test_plain_ring_is_bit_equal_to_pallas(ndev, shape, op, dtype):
    rng = np.random.default_rng(ndev * 7 + len(shape))
    x = rng.standard_normal((ndev,) + shape).astype(np.float32)
    if op == "PROD":
        x = rng.choice(np.array([0.5, 1.0, 2.0], np.float32),
                       size=(ndev,) + shape)
    xj = jnp.asarray(x).astype(dtype)
    want = _on_jax_mesh(
        lambda s: ring_allreduce_pallas(s, "x", op=JOp[op], interpret=True),
        xj)
    got = tring._ring_plain(
        [t.to(getattr(torch, dtype)) for t in _ranks(x)], ReduceOp[op])
    got = np.stack([g.float().numpy() for g in got])
    if dtype == "bfloat16":
        want = want.astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ndev", [3, 4])
def test_explicit_ring_is_bit_equal_to_lax_ring(ndev):
    """At 1000 floats the lax ring's ceil(size/n) chunks differ from the
    kernel's 128-aligned ones, and so do the bits of the two rings; each
    port ring matches its JAX twin."""
    rng = np.random.default_rng(ndev)
    x = rng.standard_normal((ndev, 1000)).astype(np.float32)
    want = _on_jax_mesh(lambda s: JC.ring_allreduce(s, "x"), x)
    for unroll in (False, True):
        got = np.stack([g.numpy() for g in
                        TC.ring_allreduce(_ranks(x), unroll=unroll)])
        np.testing.assert_array_equal(_bits(got), _bits(want))
    kernel_layout = np.stack([g.numpy() for g in tring._ring_plain(_ranks(x))])
    assert not np.array_equal(kernel_layout, want)


def test_ring_p2p_on_the_cpu_and_one_rank():
    rng = np.random.default_rng(9)
    x = rng.integers(-50, 50, (4, 300)).astype(np.int32)
    for op, red in ((ReduceOp.SUM, np.sum), (ReduceOp.MAX, np.max),
                    (ReduceOp.MIN, np.min)):
        got = tring.ring_allreduce_p2p(_ranks(x), op)
        for g in got:
            np.testing.assert_array_equal(g.numpy(), red(x, axis=0))
    one = [torch.arange(5.0)]
    assert tring.ring_allreduce_p2p(one)[0] is one[0]
    assert tring.supported_ops() == {ReduceOp.SUM, ReduceOp.MAX,
                                     ReduceOp.MIN, ReduceOp.PROD}


def test_ring_p2p_refuses_what_it_cannot_do():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tring.ring_allreduce_p2p([torch.zeros(4),
                                  torch.zeros(4, device="meta")])
    with pytest.raises(ValueError, match="unsupported op"):
        tring.ring_allreduce_p2p([torch.zeros(4)] * 2, ReduceOp.BITOR)
    with pytest.raises(ValueError, match="rank tensors differ"):
        tring.ring_allreduce_p2p([torch.zeros(4), torch.zeros(5)])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tring.ring_allreduce_p2p([torch.zeros(4, device="meta")] * 2)


def test_ring_on_integer_values_matches_psum_and_jax():
    """``dryrun_multichip`` section 2b: the ring over the full mesh on
    integer-valued floats equals the exact sum, as JAX's ring does."""
    x = np.random.default_rng(5).integers(-8, 9, (NDEV, 512)).astype(
        np.float32)
    want = _on_jax_mesh(
        lambda s: ring_allreduce_pallas(s, "x", JOp.SUM, interpret=True), x)
    got = np.stack([g.numpy() for g in tring.ring_allreduce_p2p(_ranks(x))])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], x.sum(axis=0))


def test_cuda_route_raises_without_the_toolkit(monkeypatch, tmp_path):
    """The CUDA route builds and launches the ring kernel or raises;
    without nvcc it raises and counts no launch."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tring, "_LIB", None)
    monkeypatch.setattr("shutil.which", lambda _name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    launches = tring.LAUNCHES["ring_allreduce"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tring._ring_cuda([torch.ones(300)] * 2, ReduceOp.SUM)
    assert tring.LAUNCHES["ring_allreduce"] == launches
    with pytest.raises(TypeError, match="float32, bfloat16 or int32"):
        tring._ring_cuda([torch.ones(3, dtype=torch.float64)] * 2,
                         ReduceOp.SUM)


def test_pallas_chunk_follows_the_segmenting():
    """The chunk grows past ceil(size/ndev), 1,250,000 floats here, where
    the 8 MB segmenting rounds it: 10 segments of 125,056 floats."""
    assert tring.pallas_chunk(1000, 4, 4) == 256
    assert tring.pallas_chunk(257, 2, 4) == 256
    assert tring.pallas_chunk(10 ** 7, 8, 4) == 10 * 125056
    assert tring.pallas_chunk(10 ** 7, 8, 2) == 5 * 250112


# ------------------------------------------------- named collectives
_OPS = ["SUM", "MAX", "MIN", "PROD"]


@pytest.mark.parametrize("op", _OPS)
def test_allreduce_matches_jax(op):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 40)).astype(np.float32)
    want = _on_jax_mesh(lambda s: JC.allreduce(s, "x", JOp[op]), x)
    got = TC.allreduce(_ranks(x), ReduceOp[op])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **NAMED_TOL)
    ints = rng.integers(-20, 20, (8, 40)).astype(np.float32)
    want = _on_jax_mesh(lambda s: JC.allreduce(s, "x", JOp[op]), ints)
    got = TC.allreduce(_ranks(ints), ReduceOp[op])
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("op", ["BITOR", "BITAND", "BITXOR"])
def test_bitwise_allreduce_matches_jax(op):
    x = np.random.default_rng(2).integers(0, 1 << 30, (8, 33)).astype(np.int32)
    want = _on_jax_mesh(lambda s: JC.allreduce(s, "x", JOp[op]), x)
    got = TC.allreduce(_ranks(x), ReduceOp[op])
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def test_broadcast_allgather_reduce_scatter_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16, 3)).astype(np.float32)
    want = _on_jax_mesh(lambda s: JC.broadcast(s, "x", root=3), x)
    got = np.stack([g.numpy() for g in TC.broadcast(_ranks(x), root=3)])
    np.testing.assert_allclose(got, want, **NAMED_TOL)
    with pytest.raises(ValueError, match="out of range"):
        TC.broadcast(_ranks(x), root=8)
    for axis, tiled in ((0, False), (1, False), (0, True)):
        want = _on_jax_mesh(
            lambda s: JC.allgather(s, "x", axis=axis, tiled=tiled), x)
        got = np.stack([g.numpy() for g in
                        TC.allgather(_ranks(x), axis=axis, tiled=tiled)])
        np.testing.assert_array_equal(got, want)
    want = _on_jax_mesh(lambda s: JC.reduce_scatter(s, "x", axis=0), x)
    got = np.stack([g.numpy() for g in TC.reduce_scatter(_ranks(x), axis=0)])
    np.testing.assert_allclose(got, want, **NAMED_TOL)
    ints = rng.integers(-9, 9, (8, 16)).astype(np.float32)
    want = _on_jax_mesh(lambda s: JC.reduce_scatter(s, "x"), ints)
    got = np.stack([g.numpy() for g in TC.reduce_scatter(_ranks(ints))])
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- meshes
def test_mesh_validation_and_slices_match_jax():
    devs = ["cpu"] * 8
    m = tmesh.make_mesh(devices=devs)
    assert m.shape == {"dp": 8} and m.size == 8
    assert all(d == torch.device("cpu") for d in m.rank_devices())
    m2 = tmesh.make_mesh((4, 2), ("dp", "sp"), devices=devs)
    assert m2.shape == {"dp": 4, "sp": 2}
    with pytest.raises(ValueError) as port_err:
        tmesh.make_mesh((3, 2), ("dp", "sp"), devices=devs)
    with pytest.raises(ValueError) as jax_err:
        jmesh.make_mesh((3, 2), ("dp", "sp"), devices=jax.devices()[:8])
    assert str(port_err.value) == str(jax_err.value)
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS
    for n in (0, 7, 100, 4194304):
        for world in (1, 3, 4, 8):
            for rank in range(world):
                assert (tmesh.local_data_slice(rank, world, n)
                        == jmesh.local_data_slice(rank, world, n))


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


# -------------------------------------- dryrun_multichip's steps
NDEV = 8


def _jax_step(body, args, in_specs):
    mesh = jmesh.make_mesh(devices=jax.devices()[:NDEV])
    f = JC.shard_collective(mesh, body, in_specs=in_specs, out_specs=P(),
                            check_vma=False)
    return f(*args)


def _rank_rows(a, rank):
    return a[tmesh.local_data_slice(rank, NDEV, a.shape[0])]


def _port_reduce(per_rank):
    """The per-rank stats through B4's plain version, held bit for bit
    against the named allreduce through the same ring."""
    ring = tring.ring_allreduce_p2p(per_rank)
    named = TC.allreduce(per_rank)
    for r in ring:
        assert torch.equal(r, ring[0])
    torch.testing.assert_close(ring[0], named[0], rtol=1e-6, atol=1e-5)
    return ring[0]


def _assert_stats(got, want):
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want, **SUM_TOL)


def test_data_parallel_dense_kmeans_step_matches_jax():
    rng = np.random.default_rng(0)
    k, d, n_per = 8, 64, 32
    x = rng.standard_normal((n_per * NDEV, d)).astype(np.float32)
    valid = np.ones(n_per * NDEV, np.float32)
    cent = rng.standard_normal((k, d)).astype(np.float32)

    def body(c, xs, v):
        return JC.allreduce(j_dense(c, xs, v), jmesh.DATA_AXIS, JOp.SUM)

    want = np.asarray(_jax_step(body, (jnp.asarray(cent), jnp.asarray(x),
                                       jnp.asarray(valid)),
                                (P(), P(jmesh.DATA_AXIS, None),
                                 P(jmesh.DATA_AXIS))))
    tc = torch.from_numpy(cent)
    stats = _port_reduce([
        tkk.kmeans_stats_fused(tc, torch.from_numpy(_rank_rows(x, r)),
                               torch.from_numpy(_rank_rows(valid, r)))
        for r in range(NDEV)])
    _assert_stats(stats.numpy(), want)
    new = tkm.centroid_update(tc, stats).numpy()
    np.testing.assert_allclose(
        new, np.asarray(jkm.centroid_update(jnp.asarray(cent),
                                            jnp.asarray(want))),
        rtol=1e-4, atol=1e-5)


def test_data_parallel_ell_kmeans_step_matches_jax():
    rng = np.random.default_rng(1)
    k, d, nnz, hi, group, n_per = 8, 128, 8, 128, 4, 32
    n = n_per * NDEV
    cent = rng.standard_normal((k, d)).astype(np.float32)
    idx = rng.integers(0, d, (n, nnz)).astype(np.int32)
    val = rng.standard_normal((n, nnz)).astype(np.float32)
    valid = np.ones(n, np.float32)
    kw = dict(group=group, hi=hi, block=n_per)

    def body(c, bi, bv, v):
        s = j_ell(c, bi, bv, v, d, compute_dtype=jnp.float32, **kw)
        return JC.allreduce(s, jmesh.DATA_AXIS, JOp.SUM)

    want = np.asarray(_jax_step(
        body, tuple(map(jnp.asarray, (cent, idx, val, valid))),
        (P(), P(jmesh.DATA_AXIS, None), P(jmesh.DATA_AXIS, None),
         P(jmesh.DATA_AXIS))))
    tc = torch.from_numpy(cent)
    stats = _port_reduce([
        tkk.kmeans_ell_stats_fused(
            tc, torch.from_numpy(_rank_rows(idx, r)),
            torch.from_numpy(_rank_rows(val, r)),
            torch.from_numpy(_rank_rows(valid, r)), d,
            compute_dtype=torch.float32, **kw)
        for r in range(NDEV)])
    _assert_stats(stats.numpy(), want)


def test_data_parallel_gbdt_level_matches_jax():
    rng = np.random.default_rng(2)
    f, nbin, nodes = 4, 16, 2
    n = 64 * NDEV
    bins_t = rng.integers(0, nbin, (f, n)).astype(np.int32)
    w = rng.standard_normal((2 * nodes, n)).astype(np.float32)

    def body(bt, ww):
        return JC.allreduce(j_hist(bt, ww, nbin), jmesh.DATA_AXIS, JOp.SUM)

    want = np.asarray(_jax_step(body, (jnp.asarray(bins_t), jnp.asarray(w)),
                                (P(None, jmesh.DATA_AXIS),
                                 P(None, jmesh.DATA_AXIS))))
    cols = [tmesh.local_data_slice(r, NDEV, n) for r in range(NDEV)]
    hist = _port_reduce([
        thk.hist_fused_multi(torch.from_numpy(bins_t[:, c]),
                             torch.from_numpy(w[:, c]), nbin)
        for c in cols]).numpy()
    np.testing.assert_allclose(hist, want, **SUM_TOL)
    gain_t = thg.split_gain(np.stack([hist[0], hist[nodes]], axis=-1))
    gain_j = jhg.split_gain(np.stack([want[0], want[nodes]], axis=-1))
    assert np.isfinite(gain_t).all()
    np.testing.assert_array_equal(gain_t.argmax(axis=1),
                                  gain_j.argmax(axis=1))


# ----------------------------------------------------------- ici_bench
def test_ici_bench_sweeps_every_impl_on_the_cpu(capsys):
    rows = ici_bench.main(["--ndev", "4", "--reps", "2", "--sizes",
                           "1000,4096", "--impls",
                           "psum,ring,ringunroll,pallas", "--device", "cpu"])
    assert [(r["impl"], r["size"]) for r in rows] == [
        (i, s) for i in ("psum", "ring", "ringunroll", "pallas")
        for s in (1000, 4096)]
    assert all(r["seconds"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert "not NVLink" in out and "FAILED" not in out


def test_ici_bench_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ici_bench.bench_impl("pallas", 2, 256, 1)
