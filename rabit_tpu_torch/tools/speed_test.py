"""Collective micro-benchmark worker (counterpart of
:mod:`rabit_tpu.tools.speed_test`).

Times Allreduce(max), Allreduce(sum) and Broadcast over a payload of n
floats for nrep repetitions, allreduces the per-rank timing mean/std
(reference: test/speed_test.cc:53-70), and prints MB/s and the bus
bandwidth.  Works against whichever engine ``RABIT_ENGINE`` selects
(``pysocket``, ``pyrobust``, ``xla``), so it compares the host wire
with the device plane and, under ``rabit_device_impl=pallas_ring``, the
ring kernel B4 across the rank processes.

Usage (as a launched worker)::

    python -m rabit_tpu_torch.tracker.launch_local -n 4 -- \\
        python -m rabit_tpu_torch.tools.speed_test <ndata> <nrepeat> [device]

With ``device`` the buffers are CUDA tensors riding the device data
plane, and each timed loop ends in ``torch.cuda.synchronize()``;
``RABIT_TORCH_CPU=1`` puts them on the CPU instead (the tests' way to
ask for the CPU).  Without a card and without ``RABIT_TORCH_CPU`` the
device leg raises.  Otherwise the buffers are numpy host arrays.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import rabit_tpu_torch
from rabit_tpu_torch.ops import MAX, SUM


def _stats(dt: float):
    """Allreduce (sum, sum^2) of the per-rank time, like the reference's
    mean/std aggregation (reference: test/speed_test.cc:53-70)."""
    world = rabit_tpu_torch.get_world_size()
    agg = rabit_tpu_torch.allreduce(np.array([dt, dt * dt], np.float64), SUM)
    mean = agg[0] / world
    var = max(agg[1] / world - mean * mean, 0.0)
    return mean, float(np.sqrt(var))


def leg_device():
    """The device leg's device: the current card, or the CPU under
    ``RABIT_TORCH_CPU``; raises where neither is asked for and no card
    is present."""
    import torch

    if os.environ.get("RABIT_TORCH_CPU", "") not in ("", "0"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("speed_test device leg: no CUDA device (set "
                           "RABIT_TORCH_CPU=1 to run it on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def run(ndata: int, nrep: int, device: bool = False,
        checkpoint_every: int = 0) -> dict:
    """``checkpoint_every > 0`` commits an in-memory checkpoint every
    that many ops — the reference apps' usage pattern (kmeans checkpoints
    per iteration), so the robust engine's result cache is cleared as a
    real application's is.  ``device``: the payloads are tensors on
    :func:`leg_device`."""
    rank = rabit_tpu_torch.get_rank()
    sync = None
    if device:
        import torch

        dev = leg_device()
        make = lambda: torch.full((ndata,), float(rank + 1),  # noqa: E731
                                  dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            sync = torch.cuda.synchronize
    else:
        make = lambda: np.full(ndata, float(rank + 1), np.float32)  # noqa: E731

    nbytes = ndata * 4
    results = {}
    for name, op in (("allreduce_max", MAX), ("allreduce_sum", SUM)):
        buf = make()
        rabit_tpu_torch.allreduce(buf, op)  # warmup
        if sync is not None:
            sync()
        t0 = time.perf_counter()
        for i in range(nrep):
            buf = make()
            rabit_tpu_torch.allreduce(buf, op)
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                rabit_tpu_torch.checkpoint({"op": name, "i": i})
        if sync is not None:
            sync()                     # the reference's block_until_ready
        dt = (time.perf_counter() - t0) / nrep
        mean, std = _stats(dt)
        world = rabit_tpu_torch.get_world_size()
        # bus bandwidth: the standard 2(n-1)/n normalisation that makes
        # allreduce numbers comparable across world sizes (each byte must
        # cross the bus twice, minus the local share)
        bus = (2.0 * (world - 1) / world) * nbytes / mean if world > 1 \
            else nbytes / mean
        results[name] = {"sec_mean": mean, "sec_std": std,
                         "mbps": nbytes / mean / 1e6,
                         "bus_gbps": bus / 1e9}

    payload = np.full(ndata, 7.0, np.float32).tobytes()
    rabit_tpu_torch.broadcast(payload if rank == 0 else None, 0)
    t0 = time.perf_counter()
    for _ in range(nrep):
        rabit_tpu_torch.broadcast(payload if rank == 0 else None, 0)
    dt = (time.perf_counter() - t0) / nrep
    mean, std = _stats(dt)
    results["broadcast"] = {"sec_mean": mean, "sec_std": std,
                            "mbps": nbytes / mean / 1e6}
    return results


def main(argv: list[str]) -> int:
    ndata = int(argv[1]) if len(argv) > 1 else 100000
    nrep = int(argv[2]) if len(argv) > 2 else 100
    device = len(argv) > 3 and argv[3] == "device"
    checkpoint_every = int(os.environ.get("RABIT_SPEED_CHECKPOINT", "0"))
    obs_dir = os.environ.get("RABIT_OBS_DIR")
    if obs_dir:
        # the engines' own telemetry there is not ported (ROADMAP A8):
        # they are told nothing of it, and only the results go there
        print("speed_test: RABIT_OBS_DIR holds speed_results.json only; "
              "the engines' metric summaries are not ported (ROADMAP A8)",
              file=sys.stderr, flush=True)
        rabit_tpu_torch.init(rabit_obs_dir="")
    else:
        rabit_tpu_torch.init()
    results = run(ndata, nrep, device, checkpoint_every)
    if rabit_tpu_torch.get_rank() == 0:
        for name, r in results.items():
            line = ("%s: %.6f +/- %.6f sec, %.2f MB/s"
                    % (name, r["sec_mean"], r["sec_std"], r["mbps"]))
            if "bus_gbps" in r:
                line += ", bus %.3f GB/s" % r["bus_gbps"]
            rabit_tpu_torch.tracker_print(line)
    # with RABIT_OBS_DIR set, rank 0 writes the results there
    if obs_dir and rabit_tpu_torch.get_rank() == 0:
        import json

        os.makedirs(obs_dir, exist_ok=True)
        with open(os.path.join(obs_dir, "speed_results.json"), "w") as f:
            json.dump({"ndata": ndata, "nrep": nrep, "device": device,
                       "world": rabit_tpu_torch.get_world_size(),
                       "results": results}, f, indent=2, sort_keys=True)
    rabit_tpu_torch.finalize()
    return 0


def cli() -> int:
    """Console-script entry point."""
    return main(sys.argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
