"""Split a LibSVM file into k per-rank row shards — and the shard math
the elastic layer reuses in memory.

PyTorch-port counterpart of :mod:`rabit_tpu.learn.splitrows` (its own
copy: the port imports nothing of the JAX package): rows are assigned
to shards pseudo-randomly with a fixed seed so runs are reproducible.
Output files are ``<out>.row0 .. <out>.row{k-1}``, the per-rank
``%d``-substitution naming the data loader understands
(:mod:`rabit_tpu_torch.learn.data`).

The assignment stream is the module's contract, not an implementation
detail: :func:`shard_indices` / :func:`rows_for_rank` replay the exact
``random.Random(seed).randint`` sequence :func:`split` consumes, so
in-memory shards and on-disk shard files always agree row for row, and
with the reference's.  Elastic rescale leans on this — after the world
changes from ``k`` to ``k'`` ranks, every rank recomputes
``rows_for_rank(n, rank, k', seed)`` and the new shards are again an
exact partition of the dataset: every row assigned to exactly one
rank, no row dropped or duplicated, deterministically for any world
size.

Usage: python -m rabit_tpu_torch.learn.splitrows <fin> <out> <k>
"""
from __future__ import annotations

import random
import sys


def assignment_stream(k: int, seed: int = 10):
    """The canonical row→shard stream: yields the shard of row 0, row 1,
    ... for a world of ``k``.  Single source of truth for file splitting
    and in-memory (re)sharding."""
    rng = random.Random(seed)
    while True:
        yield rng.randint(0, k - 1)


def shard_indices(n_rows: int, k: int, seed: int = 10) -> list[list[int]]:
    """Row-index shards for an ``n_rows`` dataset across ``k`` ranks.

    By construction the shards are an exact partition of
    ``range(n_rows)`` for every ``k`` — the property elastic reshard
    correctness rests on."""
    stream = assignment_stream(k, seed)
    shards: list[list[int]] = [[] for _ in range(k)]
    for i in range(n_rows):
        shards[next(stream)].append(i)
    return shards


def rows_for_rank(n_rows: int, rank: int, k: int, seed: int = 10
                  ) -> list[int]:
    """One rank's row indices under the ``k``-way assignment — what an
    elastic worker calls after every rescale to re-shard its data."""
    stream = assignment_stream(k, seed)
    return [i for i in range(n_rows) if next(stream) == rank]


def split(fin: str, fout: str, k: int, seed: int = 10) -> list[str]:
    names = [f"{fout}.row{i}" for i in range(k)]
    stream = assignment_stream(k, seed)
    outs = [open(n, "w") for n in names]
    try:
        with open(fin) as f:
            for line in f:
                outs[next(stream)].write(line)
    finally:
        for f in outs:
            f.close()
    return names


def main(argv: list[str]) -> int:
    if len(argv) < 4:
        print("Usage: <fin> <fout> k")
        return 0
    split(argv[1], argv[2], int(argv[3]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
