"""Sweep runner for the collective micro-benchmark (counterpart of
:mod:`rabit_tpu.tools.speed_runner`).

Runs :mod:`rabit_tpu_torch.tools.speed_test` over a payload x repeat
grid for each engine, under the port's local launcher, one job a cell
(reference: test/speed_runner.py:1-30).  Engines are named as
``RABIT_ENGINE`` takes them: ``pysocket``, ``pyrobust`` and ``xla``
(the device plane; add ``device`` legs by running ``speed_test``
itself).  The reference's ``native``, ``mpi`` and ``mpi_allreduce``
legs need the native C++ and MPI engines, which are not ported (ROADMAP
A8k): naming one raises before any job is launched, the default
``--engines native,pysocket`` included.

Usage:  python -m rabit_tpu_torch.tools.speed_runner --engines pysocket
        python -m rabit_tpu_torch.tools.speed_runner --workers 3 \\
            --engines pysocket,pyrobust,xla
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

# (ndata floats, nrepeat) pairs, scaled down from the reference grid
# (reference: test/speed_runner.py:13-18 uses 10^4..10^7 x 10^4..10)
GRID = [(10_000, 100), (100_000, 30), (1_000_000, 10)]

#: legs of the reference that need an unported engine
UNPORTED = {"native": "A8k", "mpi": "A8k", "mpi_allreduce": "A8k"}


def refuse_unported(engines: list[str]) -> None:
    """Raise :class:`NotImplementedError` for the first leg that needs an
    unported engine, naming its ROADMAP item."""
    for engine in engines:
        if engine in UNPORTED:
            raise NotImplementedError(
                f"speed_runner engine {engine!r} needs the native C++ and "
                f"MPI engines, not ported to rabit_tpu_torch yet (ROADMAP "
                f"{UNPORTED[engine]})")


def command(workers: int, ndata: int, nrep: int) -> list[str]:
    """One cell's command line: the port's launcher over speed_test."""
    return [sys.executable, "-m", "rabit_tpu_torch.tracker.launch_local",
            "-n", str(workers), "--",
            sys.executable, "-m", "rabit_tpu_torch.tools.speed_test",
            str(ndata), str(nrep)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--engines", default="native,pysocket")
    ap.add_argument("--replica", default=None,
                    help="rabit_global_replica override (1 = striped "
                         "regime: results recycled, steady-state memory)")
    args = ap.parse_args(argv)
    engines = args.engines.split(",")
    refuse_unported(engines)
    if args.replica is not None:
        os.environ["RABIT_GLOBAL_REPLICA"] = str(args.replica)

    for engine in engines:
        for ndata, nrep in GRID:
            print(f"=== engine={engine} n={ndata} rep={nrep} ===",
                  flush=True)
            proc = subprocess.run(
                command(args.workers, ndata, nrep),
                env={**os.environ, "RABIT_ENGINE": engine})
            if proc.returncode != 0:
                print(f"engine={engine} failed ({proc.returncode})")
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
