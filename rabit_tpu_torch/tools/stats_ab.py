"""Hold the dense k-means stats kernel (B1) against B1 built from another
source, on the card.

A change to ``csrc/kmeans_stats.cu`` that must leave the production
kernel as it was (new instantiations beside it, a refactor) is checked
here: the other source (for example the parent commit's, from
``git show <parent>:rabit_tpu_torch/ops/csrc/kmeans_stats.cu``) is built
into a library of its own, both run on the same seeded inputs, and the
tool prints whether every output bit agrees and, at the dense16 shape
(4,194,304 x 256 bfloat16, k=64), the times of the two interleaved
(other, this, this, other, three rounds) with CUDA events.  The other
source must export ``kmeans_stats_dense`` with this tree's arguments.

Usage:
    python -m rabit_tpu_torch.tools.stats_ab OTHER.cu
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

# (rows, d, k, dtype); the first is timed
SHAPES = ((1 << 22, 256, 64, torch.bfloat16), (1 << 19, 256, 64, torch.float32),
          (300, 100, 10, torch.float32), (1 << 18, 512, 64, torch.bfloat16),
          (5000, 64, 100, torch.float32))


def load_other(src: str) -> ctypes.CDLL:
    """Build ``src`` with the port's nvcc flags and load it."""
    out = _build.BUILD_DIR / f"lib{Path(src).stem}-other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kmeans_stats_dense.argtypes = [p, ll, i, p, ll, p, i, i, i, i, i, i,
                                       p, p, p]
    lib.kmeans_stats_dense.restype = i
    return lib


def other_dense(lib, cent, x, valid):
    """B1 of the other library, launched on this tree's plan."""
    cn = kk._normalized(cent, x.dtype).contiguous()
    n, d = x.shape
    k = cn.shape[0]
    grid_x, ny, dslice = kk._plan(kk._lib(), x.device, n, d, k)
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
    """Non-zero if any shape's bits differ."""
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    lib = load_other(argv[0])
    g = torch.Generator(device="cuda").manual_seed(3)
    same = True
    for n, d, k, dtype in SHAPES:
        x = torch.randn(n, d, generator=g, device="cuda").to(dtype)
        cent = torch.randn(k, d, generator=g, device="cuda")
        valid = (torch.rand(n, generator=g, device="cuda") > 0.1).float()
        ok = torch.equal(kk.kmeans_stats_fused(cent, x, valid),
                         other_dense(lib, cent, x, valid))
        same &= ok
        print(f"B1 n={n} d={d} k={k} {dtype}: same bits as the other "
              f"source: {ok}", flush=True)
        if (n, d, k, dtype) == SHAPES[0]:
            ts = {"other": [], "this": []}
            for who in ("other", "this", "this", "other") * 3:
                ts[who].append(_ms(
                    (lambda: other_dense(lib, cent, x, valid)) if who ==
                    "other" else (lambda: kk.kmeans_stats_fused(cent, x,
                                                                valid))))
            print(f"B1 at n={n} d={d} k={k} {dtype} on "
                  f"{torch.cuda.get_device_name(0)}: this source "
                  f"{statistics.median(ts['this']):.3f} ms, the other "
                  f"{statistics.median(ts['other']):.3f} ms (medians of "
                  f"{len(ts['this'])} interleaved medians of 5)", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
