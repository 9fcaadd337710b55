"""In-program collectives over logical ranks.

Counterpart of :mod:`rabit_tpu.parallel.collectives`.  There, each
collective runs inside ``shard_map`` on one shard per chip.  Here it
takes a list of per-rank tensors (one per rank of a mesh, see
:mod:`rabit_tpu_torch.parallel.mesh`) and returns a list with each
rank's result on that rank's device.  ``shard_collective`` has no
counterpart: a list of ranks needs no ``shard_map``, and the caller runs
each rank's step itself, then calls the collective on the per-rank
results.

* ``allreduce``, ``broadcast``, ``allgather`` and ``reduce_scatter`` are
  the named-axis collectives (XLA's ``psum``/``pmax``/``pmin``,
  ``all_gather``, ``psum_scatter``), computed in one PyTorch reduction
  over the stacked ranks;
* :func:`ring_allreduce` is the explicit ring of ``ppermute`` hops with
  ``ceil(size / n)`` chunks, the order-defined oracle.  Its chunking
  differs from the ring kernel's (:mod:`rabit_tpu_torch.ops.ring_allreduce`,
  128-aligned and segment-rounded), so the two give different float bits
  where the chunk boundaries differ, as the JAX package's two rings do.
"""
from __future__ import annotations

import functools

import torch

from rabit_tpu_torch.ops.reduce_ops import ReduceOp, apply_op_pairwise
from rabit_tpu_torch.ops.ring_allreduce import ring_hops


def _per_rank(out: torch.Tensor, xs) -> list:
    return [out.to(x.device, copy=True) for x in xs]


def _stacked(xs) -> torch.Tensor:
    return torch.stack([x.to(xs[0].device) for x in xs])


def allreduce(xs, op: ReduceOp = ReduceOp.SUM) -> list:
    """Allreduce the per-rank tensors: MAX/MIN/SUM in one reduction over
    the stacked ranks; PROD and the bitwise ops fold the ranks in rank
    order with :func:`apply_op_pairwise`, as the JAX package's gather
    and reduce does."""
    op = ReduceOp(op)
    if op == ReduceOp.SUM:
        out = _stacked(xs).sum(dim=0, dtype=xs[0].dtype)
    elif op == ReduceOp.MAX:
        out = _stacked(xs).amax(dim=0)
    elif op == ReduceOp.MIN:
        out = _stacked(xs).amin(dim=0)
    else:
        first = xs[0].device
        out = functools.reduce(functools.partial(apply_op_pairwise, op),
                               [x.to(first) for x in xs])
    return _per_rank(out, xs)


def broadcast(xs, root: int = 0) -> list:
    """Rank ``root``'s tensor on every rank."""
    if not 0 <= root < len(xs):
        raise ValueError(f"broadcast: root {root} out of range for "
                         f"{len(xs)} ranks")
    return _per_rank(xs[root], xs)


def allgather(xs, axis: int = 0, tiled: bool = False) -> list:
    """Every rank's tensor, stacked along a new ``axis`` (or concatenated
    along ``axis`` when ``tiled``), on every rank."""
    parts = [x.to(xs[0].device) for x in xs]
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    return _per_rank(out, xs)


def reduce_scatter(xs, axis: int = 0) -> list:
    """Sum the ranks, then give rank ``r`` the ``r``-th of ``n`` equal
    pieces along ``axis`` (``psum_scatter`` with ``tiled=True``)."""
    n = len(xs)
    total = _stacked(xs).sum(dim=0, dtype=xs[0].dtype)
    if total.shape[axis] % n:
        raise ValueError(f"reduce_scatter: axis {axis} of size "
                         f"{total.shape[axis]} does not split over {n} ranks")
    pieces = total.chunk(n, dim=axis)
    return [p.to(x.device, copy=True) for p, x in zip(pieces, xs)]


def ring_allreduce(xs, op: ReduceOp = ReduceOp.SUM,
                   unroll: bool = False) -> list:
    """Explicit ring allreduce: ``n - 1`` reduce-scatter hops, each rank
    folding what its left neighbour holds into its own chunk with
    ``combine(mine, recvd)``, then ``n - 1`` all-gather hops.

    The flat payload is zero-padded to ``n`` chunks of ``ceil(size/n)``.
    ``unroll`` keeps the JAX package's signature: the hops are a Python
    loop either way, and the result is the same.
    """
    n = len(xs)
    if n == 1:
        return list(xs)
    shape, size = xs[0].shape, xs[0].numel()
    chunk = -(-size // n)
    device = xs[0].device
    chunks = torch.zeros((n, n * chunk), dtype=xs[0].dtype, device=device)
    for r, x in enumerate(xs):
        chunks[r, :size] = x.reshape(-1).to(device)
    ring_hops(chunks.view(n, n, chunk), ReduceOp(op))
    return [chunks[r, :size].reshape(shape).to(x.device, copy=True)
            for r, x in enumerate(xs)]
