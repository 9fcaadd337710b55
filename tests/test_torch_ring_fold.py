"""The ring allreduce kernel's one-pass fold order against the ring.

On one card the kernel (``csrc/ring_allreduce.cu``) computes element
``p`` of chunk ``c = p // chunk`` as ``x_c``, then ``combine(x_{c+j},
acc)`` for ``j = 1 .. n-1``; ``_ring_fold_plain`` is that order in plain
PyTorch.  Here it is held, on the CPU, against the port's plain ring
(``_ring_plain``, the hops themselves) in every case the card checks,
and against the JAX package's ``ring_allreduce_pallas`` (Pallas in
interpret mode on the 8-device CPU mesh of ``tests/conftest.py``, as
``tests/test_torch_collectives.py`` runs it) in a sample of them.  The
kernel itself is held against ``_ring_plain`` on the card by
``chip_smoke.py`` phase 12.

Bar: every bit equal, for every rank; where a float input holds NaN, the
NaN positions equal and every other bit equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from rabit_tpu.ops import ReduceOp as JOp
from rabit_tpu.ops.ring_allreduce import ring_allreduce_pallas
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.ops import ring_allreduce as tring

NDEVS = (2, 3, 4, 8)
SHAPES = ((1000,), (257,), (17, 9), (3 * 128 + 5,))
OPS = ("SUM", "MAX", "MIN", "PROD")
DTYPES = ("float32", "bfloat16", "int32")


def _inputs(ndev, shape, dtype, seed, nan=False):
    """(ndev,) + shape numpy inputs; PROD takes factors near 1 so that
    products stay finite and informative."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (ndev,) + shape).astype(np.int32)
    x = rng.standard_normal((ndev,) + shape).astype(np.float32)
    if nan:
        x[rng.random(x.shape) < 0.01] = np.nan
    return x


def _ranks(x, dtype, op):
    t = torch.from_numpy(np.ascontiguousarray(x))
    if op == "PROD" and dtype != "int32":
        t = 1.0 + 0.1 * t
    return [r.to(getattr(torch, dtype)) for r in t]


def _assert_same_bits(got, want):
    """Every rank's bits equal; NaN positions equal, NaN payloads free."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype.is_floating_point:
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(w))
            g, w = g.masked_fill(nan, 0), w.masked_fill(nan, 0)
        width = torch.int16 if g.element_size() == 2 else torch.int32
        assert torch.equal(g.view(width), w.view(width))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ndev", NDEVS)
def test_fold_order_is_the_ring_order(ndev, shape, dtype):
    x = _inputs(ndev, shape, dtype, seed=ndev * 100 + len(shape))
    for op in OPS:
        xs = _ranks(x, dtype, op)
        _assert_same_bits(tring._ring_fold_plain(xs, ReduceOp[op]),
                          tring._ring_plain(xs, ReduceOp[op]))


@pytest.mark.parametrize("op", ["MAX", "MIN"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndev", NDEVS)
def test_fold_propagates_nan_as_the_ring_does(ndev, dtype, op):
    x = _inputs(ndev, (1000,), dtype, seed=7 + ndev, nan=True)
    xs = _ranks(x, dtype, op)
    got = tring._ring_fold_plain(xs, ReduceOp[op])
    _assert_same_bits(got, tring._ring_plain(xs, ReduceOp[op]))
    anynan = torch.from_numpy(np.isnan(x).any(axis=0))
    assert anynan.any()
    for g in got:
        assert torch.equal(torch.isnan(g), anynan)


def _pallas(x, dtype, op):
    """Each rank's result of ``ring_allreduce_pallas`` (interpret mode),
    as a list of torch tensors."""
    ndev = x.shape[0]
    mesh = JMesh(np.array(jax.devices()[:ndev]), ("x",))
    fn = jax.jit(jax.shard_map(
        lambda s: ring_allreduce_pallas(s[0], "x", op=JOp[op],
                                        interpret=True)[None],
        mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False))
    xs = _ranks(x, dtype, op)
    xj = jnp.asarray(torch.stack(xs).float().numpy()
                     if dtype != "int32" else torch.stack(xs).numpy())
    out = np.asarray(fn(xj.astype(dtype)).astype(
        jnp.float32 if dtype != "int32" else jnp.int32))
    return [torch.from_numpy(r.copy()).to(getattr(torch, dtype))
            for r in out], xs


# every (op, dtype) once, over ranks and shapes in turn; ranks 2-4 keep the
# interpreter's time in seconds
_PALLAS_CASES = [
    (2 + i % 3, SHAPES[i % len(SHAPES)], op, dtype)
    for i, (op, dtype) in enumerate((o, t) for o in OPS for t in DTYPES)
]


@pytest.mark.parametrize("ndev,shape,op,dtype", _PALLAS_CASES)
def test_fold_is_bit_equal_to_pallas(ndev, shape, op, dtype):
    x = _inputs(ndev, shape, dtype, seed=31 + ndev)
    want, xs = _pallas(x, dtype, op)
    _assert_same_bits(tring._ring_fold_plain(xs, ReduceOp[op]), want)


@pytest.mark.parametrize("op", ["MAX", "MIN"])
def test_fold_nan_matches_pallas(op):
    x = _inputs(4, (3 * 128 + 5,), "float32", seed=41, nan=True)
    want, xs = _pallas(x, "float32", op)
    _assert_same_bits(tring._ring_fold_plain(xs, ReduceOp[op]), want)


def test_fold_gives_each_rank_its_own_result():
    """One result per rank, in the input's shape, each in memory of its
    own (as the kernel's rows of one new buffer); the inputs unchanged."""
    xs = [torch.full((17, 9), float(r + 1)) for r in range(3)]
    before = [x.clone() for x in xs]
    got = tring._ring_fold_plain(xs, ReduceOp.SUM)
    assert len(got) == 3 and all(g.shape == (17, 9) for g in got)
    assert len({g.data_ptr() for g in got}) == 3
    assert all(torch.equal(g, torch.full((17, 9), 6.0)) for g in got)
    assert all(torch.equal(x, b) for x, b in zip(xs, before))
