"""In-program allreduce sweep over logical ranks on one card.

Counterpart of :mod:`rabit_tpu.tools.ici_bench`, which times chained
allreduces inside one compiled ``shard_map`` program over a mesh of
chips.  Here the ranks are ``--ndev`` tensors on one card, so what the
sweep measures is the card's device-memory bandwidth as the ring uses
it, not NVLink: every line says so.

Implementations, under the JAX tool's names so that the same command
lines run: ``psum`` (one PyTorch reduction over the stacked ranks),
``ring`` and ``ringunroll`` (the explicit ring of
:func:`rabit_tpu_torch.parallel.collectives.ring_allreduce`, plain
PyTorch), ``pallas`` (the ring kernel B4,
:func:`rabit_tpu_torch.ops.ring_allreduce.ring_allreduce_p2p`).

Each impl runs ``reps`` allreduces chained on one input, each result
scaled by ``1/ndev`` to keep its magnitude, as the JAX tool does; the
time per allreduce is the host clock over the chain, which ends in a
synchronize, divided by ``reps``.  Bus bandwidth uses the standard
``2(n-1)/n`` normalisation.

Usage:
    python -m rabit_tpu_torch.tools.ici_bench [--ndev 8] [--reps 20]
        [--impls psum,ring,ringunroll,pallas] [--sizes 4096,1048576]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from rabit_tpu_torch.ops.ring_allreduce import ring_allreduce_p2p
from rabit_tpu_torch.parallel.collectives import ring_allreduce
from rabit_tpu_torch.utils.device import resolve_device

IMPLS = ("psum", "ring", "ringunroll", "pallas")


def _allreduce(impl: str, xs) -> torch.Tensor:
    """Every rank's result, stacked (ndev, size)."""
    if impl == "psum":
        return torch.stack(xs).sum(dim=0).expand(len(xs), -1)
    if impl in ("ring", "ringunroll"):
        return torch.stack(ring_allreduce(xs, unroll=impl == "ringunroll"))
    if impl == "pallas":
        return torch.stack(ring_allreduce_p2p(xs))
    raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")


def bench_impl(impl: str, ndev: int, size: int, reps: int,
               device=None) -> float:
    """Seconds per allreduce of ``size`` float32s over ``ndev`` logical
    ranks, chained ``reps`` times."""
    dev = resolve_device(device, "ici_bench")
    x0 = torch.ones((ndev, size), dtype=torch.float32, device=dev)
    inv = 1.0 / ndev

    def chain(n: int) -> torch.Tensor:
        xs = list(x0.unbind(0))
        for _ in range(n):
            xs = list((_allreduce(impl, xs) * inv).unbind(0))
        return xs[0]

    out = chain(1)                    # build, warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = chain(reps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / reps
    if not bool((out == 1.0).all()):  # ones stay ones under sum * 1/ndev
        raise RuntimeError(f"{impl}: chained result drifted from 1")
    return dt


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the sweep, print one line per (impl, size), and return the
    lines as dicts (``seconds`` is None where the impl failed)."""
    ap = argparse.ArgumentParser(prog="rabit_tpu_torch.tools.ici_bench")
    ap.add_argument("--ndev", type=int, default=8,
                    help="logical ranks (default 8, the JAX tests' mesh)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--impls", default="psum,ring")
    ap.add_argument("--sizes", default="4096,65536,1048576")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "ici_bench")
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"ici_bench: {args.ndev} logical ranks on {where}; bus bandwidth "
          "is device-memory bandwidth over ranks on one device, not NVLink",
          flush=True)
    ndev, rows = args.ndev, []
    for impl in args.impls.split(","):
        for size in map(int, args.sizes.split(",")):
            nbytes = size * 4
            try:
                dt = bench_impl(impl, ndev, size, args.reps, dev)
            except (RuntimeError, ValueError) as e:
                print(f"{impl:10s} n={size:>9d}: FAILED {str(e)[:80]}",
                      flush=True)
                rows.append(dict(impl=impl, ndev=ndev, size=size,
                                 seconds=None, error=str(e)))
                continue
            bus = ((2.0 * (ndev - 1) / ndev) * nbytes / dt if ndev > 1
                   else nbytes / dt)
            print(f"{impl:10s} n={size:>9d} ({nbytes / 1e6:8.2f} MB): "
                  f"{dt * 1e6:10.1f} us/op, bus {bus / 1e9:8.3f} GB/s "
                  f"(device memory, {ndev} ranks on one device)", flush=True)
            rows.append(dict(impl=impl, ndev=ndev, size=size, seconds=dt,
                             bus_gb_s=bus / 1e9))
    return rows


def cli(argv: list[str] | None = None) -> int:
    """Command-line entry point: non-zero if any impl failed."""
    return int(any(r["seconds"] is None for r in main(argv)))


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
