#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rabit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, each raising on failure (the script then exits non-zero):
 1. report the card (name, power limit) and turn TF32 off;
 2. build the CUDA kernels from ``rabit_tpu_torch/ops/csrc``;
 3. hold the dense stats kernel against its plain version on the card;
 4. hold the ELL stats kernel against its plain version on the card;
 5. the main path, dense16 tier: ``kmeans.run`` chained and per
    iteration on 4,194,304 clustered rows, d=256, bfloat16, checked
    against the plain device loop;
 6. the main path, ell_fused tier: the same at d=512, float32;
 7. the CLI, ``python -m rabit_tpu_torch.learn.kmeans``;
 8. time each kernel at the main path's shapes.

It ends with three lines: the card's name and power limit as
``nvidia-smi`` gives them, a JSON line of kernel numbers
(``{"kernels": [...]}``), and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.  Data is clustered so that every row's best
centroid wins by a wide margin: counts and assignments are then
compared exactly, and summation order alone separates kernel and plain
sums.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 64
MAIN_ROWS = 1 << 22               # 4,194,304: over the 2 GiB dense budget
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor / FMA
# float32 sums against the plain version: the JAX tests' own bar
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
# final centroids (unit rows) of run() against the plain device loop
CENT_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data
def clustered_dense(torch, n, d, k, dtype, seed):
    """Rows near one of k random unit directions, and centroids near
    the same directions: cosine margins of ~0.9 against rounding noise
    of ~1e-3."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    basis = torch.randn(k, d, generator=g, device="cuda")
    basis /= basis.norm(dim=1, keepdim=True)
    label = torch.randint(0, k, (n,), generator=g, device="cuda")
    x = basis[label] + 0.02 * torch.randn(n, d, generator=g, device="cuda")
    cent = basis + 0.02 * torch.randn(k, d, generator=g, device="cuda")
    valid = (torch.rand(n, generator=g, device="cuda") > 0.1).float()
    return cent, x.to(dtype), valid


def clustered_ell(torch, n, d, nnz, k, seed):
    """ELL rows whose slots sit in their cluster's band of d/k features
    (duplicates guaranteed), with pad slots (index d, value 0) and a few
    out-of-range slots carrying values, which the kernel must drop."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    band = d // k
    owner = torch.randint(0, k, (n, 1), generator=g, device="cuda")
    idx = (owner * band + torch.randint(0, band, (n, nnz), generator=g,
                                        device="cuda")).int()
    val = 1.0 + torch.rand(n, nnz, generator=g, device="cuda")
    r = torch.rand(n, nnz, generator=g, device="cuda")
    idx[r < 0.2] = d
    val[r < 0.2] = 0.0
    idx[r > 0.99] = d                       # out of range, nonzero value
    valid = (torch.rand(n, generator=g, device="cuda") > 0.1).float()
    cent = torch.zeros(k, d, device="cuda")
    for c in range(k):
        cent[c, c * band:(c + 1) * band] = 1.0
    cent += 0.05 * torch.rand(k, d, generator=g, device="cuda")
    return cent, idx, val, valid


def sparse_clusters(n, d, nnz, k, seed, init_seed=0):
    """A SparseMat of n clustered rows for kmeans.run: each cluster has
    16 signature features; a row puts 3/4 of its slots there and the
    rest on random features.  The rows run() seeds its centroids from
    (the same numpy draws as init_centroids) are given one cluster each,
    so no cluster starts with two centroids and no row sits on a tie."""
    from rabit_tpu_torch.learn.data import SparseMat

    rng = np.random.default_rng(seed)
    sig = np.stack([rng.choice(d, 16, replace=False) for _ in range(k)])
    label = rng.integers(0, k, n)
    draw = np.random.default_rng(init_seed)
    picks = [int(draw.integers(n)) for _ in range(k)]
    assert len(set(picks)) == k, "init rows collide; pick another seed"
    label[picks] = np.arange(k)
    n_sig = nnz * 3 // 4
    idx = np.empty((n, nnz), np.int32)
    val = np.empty((n, nnz), np.float32)
    block = 1 << 20
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        m = hi - lo
        pos = rng.integers(0, 16, (m, n_sig))
        idx[lo:hi, :n_sig] = sig[label[lo:hi, None], pos]
        idx[lo:hi, n_sig:] = rng.integers(0, d, (m, nnz - n_sig))
        val[lo:hi, :n_sig] = 1.0 + rng.random((m, n_sig), np.float32)
        val[lo:hi, n_sig:] = 0.2 * rng.random((m, nnz - n_sig), np.float32)
    return SparseMat(indptr=np.arange(n + 1, dtype=np.int64) * nnz,
                     findex=idx.reshape(-1), fvalue=val.reshape(-1),
                     labels=np.zeros(n, np.float32), feat_dim=d)


# --------------------------------------------------------------- checks
def compare(torch, name, got, want):
    """Counts exact, sums within the float32 bar; returns max |err|."""
    if not torch.equal(got[:, -1], want[:, -1]):
        bad = (got[:, -1] != want[:, -1]).nonzero().flatten().tolist()
        raise AssertionError(f"{name}: counts differ at clusters {bad[:8]}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite sums")
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL,
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max())


def check_dense(torch, kk, name, cent, x, valid):
    got = kk.kmeans_stats_fused(cent, x, valid)
    again = kk.kmeans_stats_fused(cent, x, valid)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    want = kk._stats_plain(kk._normalized(cent, x.dtype), x, valid)
    err = compare(torch, name, got, want)
    log(f"  {name}: ok (counts exact, sums within rtol {SUM_RTOL} atol "
        f"{SUM_ATOL}), max |kernel - plain| = {err:.3g}")
    return err


def check_ell(torch, kk, name, cent, idx, val, valid, d, cdt):
    n, nnz = idx.shape
    flat = kk.kmeans_ell_stats_fused(cent, idx, val, valid, d,
                                     compute_dtype=cdt)
    grouped = kk.kmeans_ell_stats_fused(
        cent, idx.view(n // 4, 4 * nnz), val.view(n // 4, 4 * nnz), valid,
        d, nnz=nnz, group=4, compute_dtype=cdt)
    torch.cuda.synchronize()
    if not torch.equal(flat, grouped):
        raise AssertionError(f"{name}: flat and grouped layouts differ")
    want = kk._ell_stats_plain(kk._normalized(cent, cdt), idx, val, valid, d)
    err = compare(torch, name, flat, want)
    log(f"  {name}: ok (flat == grouped), max |kernel - plain| = {err:.3g}")
    return err


# -------------------------------------------------------------- timing
def time_ms(torch, fn, warm=2, reps=5):
    for _ in range(warm):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.ops import kmeans_kernel as kk

    t_start = time.perf_counter()
    # 1. the card
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] device: {kind} | nvidia-smi: {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log("    TF32 off for matmul and cuDNN: plain versions run full float32")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[2] built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # 3. dense kernel against its plain version
    t0 = time.perf_counter()
    log("[3] dense stats kernel vs plain")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        cent, x, valid = clustered_dense(torch, 1 << 19, 256, K, dtype, 3)
        errs[f"bench {dtype}"] = check_dense(
            torch, kk, f"n=2^19 d=256 k=64 {dtype}", cent, x, valid)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(300, 100, generator=g, device="cuda")
    cent = torch.randn(10, 100, generator=g, device="cuda")
    valid = (torch.rand(300, generator=g, device="cuda") > 0.1).float()
    for dtype in (torch.float32, torch.bfloat16):
        check_dense(torch, kk, f"ragged n=300 d=100 k=10 {dtype}", cent,
                    x.to(dtype), valid)
    cent = torch.randn(3, 100, generator=g, device="cuda").abs()
    x = -torch.randn(64, 100, generator=g, device="cuda").abs()
    got_neg = kk.kmeans_stats_fused(cent, x, torch.ones(64, device="cuda"))
    check_dense(torch, kk, "all-negative n=64 d=100 k=3", cent, x,
                torch.ones(64, device="cuda"))
    assert float(got_neg[:, -1].sum()) == 64.0
    for dtype in (torch.float32, torch.bfloat16):
        cent, x, valid = clustered_dense(torch, 1 << 18, 512, K, dtype, 5)
        check_dense(torch, kk, f"n=2^18 d=512 k=64 {dtype}", cent, x, valid)
    del cent, x, valid
    log(f"    phase 3 took {time.perf_counter() - t0:.1f} s")

    # 4. ELL kernel against its plain version
    t0 = time.perf_counter()
    log("[4] ELL stats kernel vs plain")
    cent, idx, val, valid = clustered_ell(torch, 1 << 20, 512, 32, K, 6)
    for cdt in (torch.bfloat16, torch.float32):
        check_ell(torch, kk, f"n=2^20 d=512 nnz=32 k=64 {cdt}", cent, idx,
                  val, valid, 512, cdt)
    del cent, idx, val, valid
    log(f"    phase 4 took {time.perf_counter() - t0:.1f} s")

    results = {}
    # 5. main path, dense16 tier
    t0 = time.perf_counter()
    d16, iters = 256, 6
    data = sparse_clusters(MAIN_ROWS, d16, 32, K, seed=7)
    log(f"[5] main path dense16: n={MAIN_ROWS} d={d16} nnz=32 k={K} "
        f"(data {time.perf_counter() - t0:.1f} s)")
    runs = {}
    for label, chain, n_it in (("chained", 3, iters), ("per-iteration", 0, 3)):
        rabit_tpu_torch.init(rabit_engine="empty")
        for key in kk.LAUNCHES:
            kk.LAUNCHES[key] = 0
        t1 = time.perf_counter()
        model = km.run(data, K, n_it, device_chain=chain,
                       compute_dtype="bfloat16")
        torch.cuda.synchronize()
        launches = dict(kk.LAUNCHES)
        rabit_tpu_torch.finalize()
        log(f"    run {label}: {n_it} iters in "
            f"{time.perf_counter() - t1:.2f} s, launches {launches}")
        if launches["kmeans_stats_dense"] < n_it:
            raise AssertionError(f"dense16 {label}: kernel launched "
                                 f"{launches['kmeans_stats_dense']} times "
                                 f"for {n_it} iterations")
        runs[label] = (model, n_it, launches)
    rabit_tpu_torch.init(rabit_engine="empty")
    init = km.init_centroids(data, K, d16, seed=0)
    rabit_tpu_torch.finalize()
    idx, val, _lab, valid = data.to_ell(pad_index=d16, row_block=1024)
    shard = km.prepare_shard(idx, val, valid, d16, 1024,
                             compute_dtype="bfloat16")
    if shard[0] != "dense16":
        raise AssertionError(f"expected the dense16 tier, got {shard[0]}")
    x16, v16 = shard[2]
    for label, (model, n_it, _l) in runs.items():
        ref = km.device_iterations(torch.from_numpy(init.centroids).cuda(),
                                   x16, v16, n_it, use_kernel=False,
                                   compute_dtype="bfloat16").cpu().numpy()
        err = float(np.abs(model.centroids - ref).max())
        if not (np.isfinite(model.centroids).all()
                and model.centroids.shape == (K, d16) and err <= CENT_ATOL):
            raise AssertionError(f"dense16 {label}: centroids off the plain "
                                 f"loop by {err} (bar {CENT_ATOL})")
        log(f"    {label}: centroids within {err:.3g} of the plain loop")
    results["dense"] = dict(x=x16, valid=v16,
                            cent=torch.from_numpy(runs["chained"][0].centroids
                                                  ).cuda(),
                            launches=runs["chained"][2]["kmeans_stats_dense"],
                            iters=runs["chained"][1])
    del data, idx, val, valid, shard
    log(f"    phase 5 took {time.perf_counter() - t0:.1f} s")

    # 6. main path, ell_fused tier
    t0 = time.perf_counter()
    dell = 512
    data = sparse_clusters(MAIN_ROWS, dell, 32, K, seed=8)
    log(f"[6] main path ell_fused: n={MAIN_ROWS} d={dell} nnz=32 k={K} "
        f"float32 (data {time.perf_counter() - t0:.1f} s)")
    runs = {}
    for label, chain, n_it in (("chained", 2, 4), ("per-iteration", 0, 3)):
        rabit_tpu_torch.init(rabit_engine="empty")
        for key in kk.LAUNCHES:
            kk.LAUNCHES[key] = 0
        t1 = time.perf_counter()
        model = km.run(data, K, n_it, device_chain=chain,
                       compute_dtype="float32")
        torch.cuda.synchronize()
        launches = dict(kk.LAUNCHES)
        rabit_tpu_torch.finalize()
        log(f"    run {label}: {n_it} iters in "
            f"{time.perf_counter() - t1:.2f} s, launches {launches}")
        if launches["kmeans_stats_ell"] < n_it:
            raise AssertionError(f"ell_fused {label}: kernel launched "
                                 f"{launches['kmeans_stats_ell']} times "
                                 f"for {n_it} iterations")
        runs[label] = (model, n_it, launches)
    rabit_tpu_torch.init(rabit_engine="empty")
    init = km.init_centroids(data, K, dell, seed=0)
    rabit_tpu_torch.finalize()
    idx, val, _lab, valid = data.to_ell(pad_index=dell, row_block=1024)
    shard = km.prepare_shard(idx, val, valid, dell, 1024,
                             compute_dtype="float32")
    if shard[0] != "ell_fused":
        raise AssertionError(f"expected the ell_fused tier, got {shard[0]}")
    for label, (model, n_it, _l) in runs.items():
        ref = km.ell_chain(torch.from_numpy(init.centroids).cuda(), shard[2],
                           dell, n_it, use_kernel=False).cpu().numpy()
        err = float(np.abs(model.centroids - ref).max())
        if not (np.isfinite(model.centroids).all()
                and model.centroids.shape == (K, dell) and err <= CENT_ATOL):
            raise AssertionError(f"ell_fused {label}: centroids off the "
                                 f"plain loop by {err} (bar {CENT_ATOL})")
        log(f"    {label}: centroids within {err:.3g} of the plain loop")
    results["ell"] = dict(payload=shard[2],
                          cent=torch.from_numpy(runs["chained"][0].centroids
                                                ).cuda(),
                          launches=runs["chained"][2]["kmeans_stats_ell"],
                          iters=runs["chained"][1])
    del data, idx, val, valid
    log(f"    phase 6 took {time.perf_counter() - t0:.1f} s")

    # 7. the CLI
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        small = sparse_clusters(20000, 128, 16, 8, seed=9)
        path = os.path.join(tmp, "train.libsvm")
        with open(path, "w") as f:
            for r in range(small.num_row):
                fi, fv = small.row(r)
                f.write("0 " + " ".join(f"{i}:{v:.4f}" for i, v in
                                        zip(fi, fv)) + "\n")
        out = os.path.join(tmp, "model.txt")
        cmd = [sys.executable, "-m", "rabit_tpu_torch.learn.kmeans", path,
               "8", "5", out, "kmeans_device_chain=2",
               "kmeans_compute_dtype=bfloat16"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300,
                              env=dict(os.environ, PYTHONPATH=ROOT))
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        cent = np.loadtxt(out)
        norms = np.linalg.norm(cent, axis=1)
        if cent.shape != (8, 128) or not np.allclose(norms, 1.0, atol=1e-4):
            raise AssertionError(f"CLI model: shape {cent.shape}, row norms "
                                 f"{norms}")
    log(f"[7] CLI: {' '.join(cmd[1:3])} ... -> (8, 128) unit centroids, "
        f"{proc.stdout.strip().splitlines()[-1]} "
        f"({time.perf_counter() - t0:.1f} s)")

    # 8. kernel times at the main path's shapes
    log("[8] timing (CUDA events, median of 5 after 2 warm-up calls)")
    lines = []
    r = results["dense"]
    x, v, cent = r["x"], r["valid"], r["cent"]
    n, d = x.shape
    cn = kk._normalized(cent, x.dtype)
    got = kk.kmeans_stats_fused(cent, x, v)
    want = kk._stats_plain(cn, x, v)
    err = compare(torch, "dense main-path shape", got, want)
    ms = time_ms(torch, lambda: kk.kmeans_stats_fused(cent, x, v))
    plain_ms = time_ms(torch, lambda: kk._stats_plain(cn, x, v), 1, 3)
    nbytes = n * d * 2 + n * 4 + K * d * 2 + K * (d + 1) * 4
    ops = 2 * n * K * d + n * d
    lines.append(dict(
        name="kmeans_stats_dense", route="cuda",
        source="rabit_tpu_torch/ops/csrc/kmeans_stats.cu",
        replaces="rabit_tpu/ops/kmeans_kernel.py:44",
        launches=r["launches"], iterations=r["iters"], max_abs_err=err,
        ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     ops / PEAK_OPS["bfloat16"]) * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= ops / PEAK_OPS["bfloat16"] else "operations"),
        library_ms=None, library="none: no single PyTorch call",
        shape=f"x ({n}, {d}) bfloat16, k={K}"))
    r = results["ell"]
    idx_g, val_g, dvalid, d_pad, nnz = r["payload"]
    cent = torch.nn.functional.pad(r["cent"], (0, d_pad - r["cent"].shape[1]))
    n = idx_g.shape[0] * 4
    flat_i, flat_v = idx_g.view(n, nnz), val_g.view(n, nnz)

    def ell_kernel():
        return kk.kmeans_ell_stats_fused(cent, idx_g, val_g, dvalid, d_pad,
                                         nnz=nnz)

    cn = kk._normalized(cent, torch.bfloat16)
    got = ell_kernel()
    want = kk._ell_stats_plain(cn, flat_i, flat_v, dvalid, d_pad)
    err = compare(torch, "ELL main-path shape", got, want)
    ms = time_ms(torch, ell_kernel)
    plain_ms = time_ms(
        torch, lambda: kk._ell_stats_plain(cn, flat_i, flat_v, dvalid, d_pad),
        1, 3)
    srt = flat_i.sort(dim=1).values
    real = int((flat_i < d_pad).sum())
    uniq = int(((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] < d_pad)).sum()
               + (srt[:, 0] < d_pad).sum())
    nbytes = n * nnz * 8 + n * 4 + K * d_pad * 2 + K * (d_pad + 1) * 4
    ops = real + 2 * K * uniq + uniq
    lines.append(dict(
        name="kmeans_stats_ell", route="cuda",
        source="rabit_tpu_torch/ops/csrc/kmeans_stats.cu",
        replaces="rabit_tpu/ops/kmeans_kernel.py:134",
        launches=r["launches"], iterations=r["iters"], max_abs_err=err,
        ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     ops / PEAK_OPS["bfloat16"]) * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= ops / PEAK_OPS["bfloat16"] else "operations"),
        library_ms=None, library="none: no single PyTorch call",
        shape=(f"ELL ({n}, {nnz}) int32+float32, d={d_pad}, k={K}, "
               f"bfloat16 compute; {real} real slots, {uniq} distinct")))
    # the dense kernel at bench.py's shape too, both input dtypes
    n, d = 1 << 19, 256
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        cent, x, valid = clustered_dense(torch, n, d, K, dtype, 10)
        cn = kk._normalized(cent, dtype)
        ms = time_ms(torch, lambda: kk.kmeans_stats_fused(cent, x, valid))
        plain_ms = time_ms(torch, lambda: kk._stats_plain(cn, x, valid))
        size = x.element_size()
        nbytes = n * d * size + n * 4 + K * d * size + K * (d + 1) * 4
        ops = 2 * n * K * d + n * d
        log(f"    kmeans_stats_dense at n=2^19 d=256 k=64 {name}: "
            f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bytes bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms, operations bound "
            f"{ops / PEAK_OPS[name] * 1e3:.3f} ms)")
    del cent, x, valid
    for line in lines:
        log(f"    {line['name']}: {line['ms']:.3f} ms (plain "
            f"{line['plain_ms']:.3f} ms, bound {line['bound_ms']:.3f} ms by "
            f"{line['bound_by']})")
    log(f"    total {time.perf_counter() - t_start:.1f} s")

    print(smi_line(), flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
