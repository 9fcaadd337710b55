"""Hold the dense k-means stats kernel (B1) against B1 built from another
source, on the card.

B1 is ``csrc/kmeans_stats_dense.cu``.  The other source is built into a
library of its own; it must export ``kmeans_stats_dense`` with the
arguments of ``csrc/kmeans_stats.cu`` (the previous B1, the default,
which is all that file holds), and the ``kmeans_stats_max_dslice`` and
``kmeans_stats_smem_bytes`` that plan it (``kmeans_kernel._plan``).
A ``kmeans_stats.cu`` that still exports ``kmeans_stats_variant`` (the
file before the variant study moved to ``kmeans_stats_variant.cu``)
takes an extra ``mode`` argument in both planning functions; the tool
refuses such a library rather than plan it wrongly.  Both run on the
same seeded inputs, and the tool prints whether they agree and, at the
dense16 shape (4,194,304 x 256 bfloat16, k=64), the times of the two
interleaved (other, this, this, other, three rounds) with CUDA events.

The two kernels sum in different orders, so their bits differ: the check
is ``chip_smoke.py``'s bar, counts exact and sums within ``rtol=1e-4,
atol=1e-3``.  The rows are clustered, as ``chip_smoke.py``'s are, so that
every row's best centroid wins by a margin far above rounding and the
two kernels assign every row alike.

Usage:
    python -m rabit_tpu_torch.tools.stats_ab [OTHER.cu]
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import kmeans_kernel as kk

DEFAULT_OTHER = _build.CSRC_DIR / "kmeans_stats.cu"
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
# (rows, d, k, dtype); the first is timed
SHAPES = ((1 << 22, 256, 64, torch.bfloat16), (1 << 19, 256, 64, torch.float32),
          (300, 100, 10, torch.float32), (1 << 18, 512, 64, torch.bfloat16),
          (5000, 64, 100, torch.float32))


def load_other(src: str) -> ctypes.CDLL:
    """Build ``src`` with the port's nvcc flags and load it (the default
    source through the port's own build cache)."""
    if Path(src).resolve() == DEFAULT_OTHER:
        return kk._lib()
    out = _build.BUILD_DIR / f"lib{Path(src).stem}-other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, "kmeans_stats_variant"):
        raise ValueError(
            f"{src} exports kmeans_stats_variant: its kmeans_stats_max_dslice"
            " and kmeans_stats_smem_bytes take a mode argument this tool does"
            " not pass; delete the variant study from a copy of it first")
    return kk._bind_previous(lib)


def other_dense(lib, cent, x, valid):
    """B1 of the other library, launched on its own plan."""
    cn = kk._normalized(cent, x.dtype).contiguous()
    n, d = x.shape
    k = cn.shape[0]
    grid_x, ny, dslice = kk._plan(lib, x.device, n, d, k)
    partial = torch.empty((grid_x, k, d + 1), device=x.device)
    out = torch.empty((k, d + 1), device=x.device)
    err = lib.kmeans_stats_dense(
        x.data_ptr(), x.stride(0), int(x.dtype == torch.bfloat16),
        valid.data_ptr(), valid.stride(0), cn.data_ptr(), n, d, k, grid_x,
        ny, dslice, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"other kmeans_stats_dense failed: CUDA error {err}")
    return out


def clustered(n, d, k, dtype, g):
    """Rows near one of k random unit directions, centroids near the same
    directions (``chip_smoke.py``'s ``clustered_dense``)."""
    basis = torch.randn(k, d, generator=g, device="cuda")
    basis /= basis.norm(dim=1, keepdim=True)
    label = torch.randint(0, k, (n,), generator=g, device="cuda")
    x = basis[label] + 0.02 * torch.randn(n, d, generator=g, device="cuda")
    cent = basis + 0.02 * torch.randn(k, d, generator=g, device="cuda")
    valid = (torch.rand(n, generator=g, device="cuda") > 0.1).float()
    return cent, x.to(dtype), valid


def agree(got, want) -> bool:
    """Counts exact, sums within the float32 bar."""
    return bool(torch.equal(got[:, -1], want[:, -1])
                and torch.allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL))


def _ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv: list[str]) -> int:
    """Non-zero if any shape disagrees, 2 on bad arguments or no card."""
    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    src = argv[0] if argv else str(DEFAULT_OTHER)
    if not torch.cuda.is_available():
        print(f"stats_ab: no CUDA device; it runs B1 on the card against "
              f"the B1 of {src}", file=sys.stderr)
        return 2
    lib = load_other(src)
    g = torch.Generator(device="cuda").manual_seed(3)
    same = True
    for n, d, k, dtype in SHAPES:
        cent, x, valid = clustered(n, d, k, dtype, g)
        got = kk.kmeans_stats_fused(cent, x, valid)
        want = other_dense(lib, cent, x, valid)
        ok = agree(got, want)
        same &= ok
        print(f"B1 n={n} d={d} k={k} {dtype}: agrees with {Path(src).name} "
              f"(counts exact, sums within rtol {SUM_RTOL} atol {SUM_ATOL})"
              f": {ok}; max |this - other| "
              f"{float((got - want).abs().max()):.3g}", flush=True)
        if (n, d, k, dtype) == SHAPES[0]:
            ts = {"other": [], "this": []}
            for who in ("other", "this", "this", "other") * 3:
                ts[who].append(_ms(
                    (lambda: other_dense(lib, cent, x, valid)) if who ==
                    "other" else (lambda: kk.kmeans_stats_fused(cent, x,
                                                                valid))))
            print(f"B1 at n={n} d={d} k={k} {dtype} on "
                  f"{torch.cuda.get_device_name(0)}: this tree "
                  f"{statistics.median(ts['this']):.3f} ms, "
                  f"{Path(src).name} {statistics.median(ts['other']):.3f} ms "
                  f"(medians of {len(ts['this'])} interleaved medians of 5)",
                  flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
