"""Variant study of the dense k-means stats kernel (B1) on the card.

Counterpart of ``tools/kernel_experiments.py``.  Each spec
``mode:block:dtype:vmem`` names a classify stage of
:func:`rabit_tpu_torch.ops.kmeans_kernel.kmeans_stats_variant` (one of
its ``VARIANTS``: ``argmax`` is the production stage), the row block
that ``cheapassignT`` assigns over, and the input dtype.  On the card
every stage runs in the one-pass kernel of
``rabit_tpu_torch/ops/csrc/kmeans_stats_variant.cu``: each row tile read
once, the similarity and the sums product on it (bf16 on the tensor
cores), only the classify stage between them differing.  The ``vmem``
field is a TPU scoped-memory limit with no Hopper counterpart: it is
parsed and ignored, and the tool says so.

For every spec the tool first checks the variant's kernel against its
plain version on the same inputs (counts exact where they count rows,
everything within ``rtol=1e-4, atol=1e-3``), then times ``ITERS``
chained stats passes with centroid feedback at N=2^19, D=256, K=64
(normalise, stats, divide by counts: the JAX tool's loop), in
``TRIALS`` trials interleaved across the specs, with CUDA events, and
prints the median per iteration.  The JAX tool timed long-minus-short
chains to cancel a fixed round trip to its TPU; CUDA events bracket the
device work alone, so one chain per trial is enough.

Usage:
    python -m rabit_tpu_torch.tools.kernel_experiments [spec ...]
"""
from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from rabit_tpu_torch.ops import kmeans_kernel as kk

N, D, K, ITERS, TRIALS = 1 << 19, 256, 64, 50, 5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
# the JAX tool's default specs, then the modes it leaves off its list
DEFAULT_SPECS = [
    "argmax:2048:bfloat16:16", "maxcmp:2048:bfloat16:16",
    "simonly:2048:bfloat16:16", "argmax:4096:bfloat16:64",
    "argmax:8192:bfloat16:64", "maxcmp:8192:bfloat16:64",
    "argmax:8192:float32:100", "simonly:8192:bfloat16:64",
    "novalid:2048:bfloat16:16", "argmaxT:2048:bfloat16:16",
    "simonlyT:2048:bfloat16:16", "cheapassignT:2048:bfloat16:16",
]
_ROW_COUNTS = ("argmax", "maxcmp", "novalid", "argmaxT")


def parse_spec(spec: str):
    """``mode:block:dtype:vmem`` -> (mode, block, torch dtype)."""
    parts = spec.split(":")
    if len(parts) != 4:
        raise ValueError(f"spec {spec!r} is not mode:block:dtype:vmem")
    mode, block, dtype, _vmem = parts
    if mode not in kk.VARIANTS:
        raise ValueError(f"spec {spec!r}: unknown mode; one of {kk.VARIANTS}")
    return mode, int(block), getattr(torch, dtype)


def step(mode: str, block: int, c: torch.Tensor, x: torch.Tensor,
         v: torch.Tensor) -> torch.Tensor:
    """One stats pass and the centroid feedback of the JAX tool's loop."""
    stats = kk.kmeans_stats_variant(c, x, v, mode, block)
    sums, counts = stats[:, :-1], stats[:, -1:]
    return torch.where(counts > 0, sums / counts.clamp(min=1.0), c)


def chained(mode: str, block: int, cdt: torch.dtype, c: torch.Tensor,
            x: torch.Tensor, v: torch.Tensor, iters: int = ITERS):
    """``iters`` chained passes from centroids ``c``; the final ones."""
    x = x.to(cdt)
    for _ in range(iters):
        c = step(mode, block, c, x, v)
    return c


def check_variant(mode: str, block: int, cdt: torch.dtype, c: torch.Tensor,
                  x: torch.Tensor, v: torch.Tensor) -> float:
    """The variant on x's device against its plain version on the same
    inputs; raises if they disagree, else returns max |difference|."""
    xc = x.to(cdt)
    got = kk.kmeans_stats_variant(c, xc, v, mode, block)
    want = kk._variant_plain(kk._normalized(c, cdt), xc, v, mode, block)
    if mode in _ROW_COUNTS and not torch.equal(got[:, -1], want[:, -1]):
        raise AssertionError(f"{mode}: counts differ from the plain version")
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL,
                               msg=lambda m: f"{mode} {cdt}: {m}")
    return float((got - want).abs().max())


def _time_chain(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def main(argv: list[str] | None = None) -> dict:
    """Check and time every spec (default :data:`DEFAULT_SPECS`); prints
    one line per spec and returns ``{spec: {...}}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_experiments times the CUDA kernels and "
                           "needs a CUDA device")
    specs = list(argv) if argv else DEFAULT_SPECS
    parsed = {s: parse_spec(s) for s in specs}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)
                         ).cuda()
    c = torch.from_numpy(rng.standard_normal((K, D)).astype(np.float32)
                         ).cuda()
    v = torch.ones(N, device="cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; N={N} D={D} K={K}, "
          f"{ITERS} chained passes a trial, {TRIALS} trials; the vmem "
          "field is a TPU limit and is ignored", flush=True)
    out = {}
    for spec, (mode, block, cdt) in parsed.items():
        err = check_variant(mode, block, cdt, c, x, v)
        chained(mode, block, cdt, c, x, v, 2)            # warm
        out[spec] = dict(mode=mode, block=block, dtype=str(cdt), err=err,
                         samples=[])
        print(f"{spec:32s} checked against its plain version: max |err| "
              f"{err:.3g}", flush=True)
    for _ in range(TRIALS):
        for spec, (mode, block, cdt) in parsed.items():
            dt = _time_chain(lambda: chained(mode, block, cdt, c, x, v))
            out[spec]["samples"].append(dt / ITERS)
    for spec, row in out.items():
        xs = row["samples"]
        med = statistics.median(xs)
        row["ms"] = med * 1e3
        spread = 100.0 * (max(xs) - min(xs)) / med
        print(f"{spec:32s} {med * 1e3:8.3f} ms/iter  {N / med / 1e6:8.1f} "
              f"Mpoints/s  (n={len(xs)} spread {spread:.0f}%)", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
