#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rabit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, each raising on failure (the script then exits non-zero):
 1. report the card (name, power limit) and turn TF32 off;
 2. build the CUDA kernels from ``rabit_tpu_torch/ops/csrc``;
 3. hold the dense stats kernel (B1) against its plain version on the
    card, with its launch plan's shared memory against the kernel
    source's: the old shapes, then widths past 1,744 (2^18 x 2048,
    3,001 x 2,050 at k=100, 2^13 x 32,768), k=1000 at d=256, rows in a
    strided view (rows of d+1, as the chained float32 dense tier holds
    them), and a tie across a 64-centroid chunk (centroid 67 a copy of
    3, k=100) whose rows must all land on 3; each in float32 and
    bfloat16, each launched twice for the same bits;
 4. hold the ELL stats kernel against its plain version on the card: the
    main shape, then edge cases (2-4 duplicate indices, all-pad rows,
    rows of validity 0, out-of-range indices carrying values) at nnz 16,
    32, 64 and k 10, 64, 100, then wide rows (nnz 512 and 1024, staged in
    device memory) and wide d (the accumulator in several column slices,
    more slices than blocks of the grid's column), in float32 and
    bfloat16, each launched twice for the same bits;
 5. the main path, dense16 tier: ``kmeans.run`` chained and per
    iteration on 4,194,304 clustered rows, d=256, bfloat16, checked
    against the plain device loop; then ``kmeans.run`` at d=2048, three
    chained iterations, on the dense16 tier (2^19 rows, bfloat16) and on
    the chained float32 dense tier (2^17 rows);
 6. the main path, ell_fused tier: the same at d=512, float32, then
    chained on 32,768 rows of 512 slots at d=32,768;
 7. the CLI, ``python -m rabit_tpu_torch.learn.kmeans``;
 8. time each k-means kernel at the main path's shapes (the ELL kernel in
    bfloat16, the compute dtype the ell_fused tier runs, and in float32),
    B1 also with its classify, fold and reduce stages apart and at
    2^19 x 2048, and count the HMMA instructions in B1's SASS;
 9. hold the GBDT histogram kernel (B3) against its plain version on the
    card, in bfloat16 and float32, each launched twice for the same bits
    and each with its plan's shared memory against the kernel source's
    (``gbdt_hist_smem_bytes``): 2,097,152 rows x 64 features x 257 slots
    at 1, 2, 3, 16, 33 and 64 channels (ragged channel groups at 1, 3,
    33), 64 channels over 1 and 3 features (ragged feature rectangles),
    bins out of range; 5 and 100,003 rows (under one tile; rows no
    multiple of the 16-byte copies); 2 slots (2^14 rows), 1024, 2048 and
    4096 slots (2^19 rows x 16 features x 64 channels, where the warps
    narrow to 16 and 8 columns), 58,045 slots (the top of the range); a
    ragged shape; and 2 slots at 2^19 rows, kernel and plain against a
    float64 ``index_add_``: equal to it on weights k/16, whose float32
    sums are exact, and their drift from it on normal weights printed;
10. the GBDT main path: ``boosting.train`` on 2,097,152 rows x 64
    features, 256 bins and a missing slot, depth 6, 4 rounds -- the
    float32 kernel against the plain path, then the default bfloat16
    kernel, with its launches counted against the level chunks and by
    channel count (nw = 2 x the level's nodes);
11. time the histogram kernel, its plain version and ``index_add_`` at
    every level's channel count (``index_add_`` at the widest over row
    chunks whose expanded source fits the card, summed), each beside its
    bound and its shared-memory floor (8 B of shared traffic an add at
    128 B a clock an SM and the card's top SM clock, or the bytes where
    larger, printed on the line before); print the plan at 2 and 64
    channels; at 32 and 64 channels, where the plan takes the
    one-feature-warp add path, time the same plan on the general path
    (the same bits asked), the A/B that keeps the first; sum launches x
    (time - bound) over the levels, and split ``train()``'s time;
12. hold the ring allreduce kernel (B4) against its plain version, bit
    for bit: SUM/MAX/MIN/PROD over 2, 3, 4 and 8 logical ranks on the
    card, 1000, 257, (17, 9), 2^20 and 10^7 elements, float32, int32 and
    bfloat16, MAX/MIN with NaN inputs, rank views that are not 16-byte
    aligned (``x[1:]``) and sizes that are not a multiple of the vector
    width, and launches of other shapes back to back; time it at the
    data-parallel steps' shapes, one call at a time and back to back;
13. the data-parallel steps of ``dryrun_multichip`` over 4 logical ranks
    at the main paths' widths: dense16 k-means (B1 per rank, B4), ELL
    k-means (B2, B4) and one GBDT level (B3 at nw=64, B4), each against
    its world-1 result, and B4 on an integer-valued payload against the
    exact sum, with the launches counted;
14. ``rabit_tpu_torch.tools.ici_bench`` over 8 ranks at 10^4 .. 10^7 and
    2^26 floats (psum, ring, pallas), and over 2 and 4 ranks at 10^7;
15. ``rabit_tpu_torch.tools.kernel_experiments`` with its default specs
    (every classify stage of the B1 variant study, P1, in the one-pass
    kernel of ``kmeans_stats_variant.cu``, each checked against its plain
    version before it is timed); then every stage against its plain
    version, each launched twice for the same bits and with its plan's
    shared memory against the kernel source's, on clustered rows at
    2^19 x 256 (counts exact where they count rows), 3,001 x 250 at
    k=10, d=2048 (several column slices) and a strided view into rows of
    257, in float32 and bfloat16, and on a ``maxcmp`` tie (centroid 5 a
    copy of 2) whose rows count in both clusters; ``simonlyT`` in
    float32 on random rows against a float64 sum; P1 ``argmax`` (one
    read of x) timed beside B1 (two) on the same inputs, in bfloat16 and
    float32; then each stage's kernel timed alone;
16. (run right after 13, while its dense16 shard is still on the card)
    the wire, on the host of the card machine: the port's ``Tracker(4)``
    on 127.0.0.1:0 and four rank threads that register through the
    port's protocol, wire the ``connect``/``naccept`` links of their
    replies through the port's ``LinkFactory`` (default config, then
    ``rabit_wire_integrity=crc32c``), compute B1's stats for a quarter of
    phase 13's dense16 shard each on the card, pass them once around the
    ring and check that each rank got ring_prev's bytes, then shut down;
    every reply is held against ``tree_neighbors``, ``ring_neighbors``
    and ``extra_link_peers``, every thread and the tracker's ``run()``
    must end within 120 s; then rendezvous-only rounds at worlds 4 and
    16, five each.  It prints the round, wiring and ring-pass times;
17. (last) k-means and GBDT at world 3 over the port's
    ``PySocketEngine``: the port's ``Tracker(3)`` and three rank
    processes sharing the card (this script with ``--world3-rank``).
    ``kmeans.run`` on phase 5's rows split in three, each third on the
    dense16 tier (B1), 3 iterations, against a world-1 oracle that runs
    B1's plain version on all the rows with no wire: counts exact every
    iteration, centroids within the float32 sum bar and bit-identical on
    the ranks; then ``boosting.train`` on phase 10's rows split in three,
    2 rounds, with the float32 kernel against the plain path (top three
    levels identical, log-loss within 1e-4) and with the bfloat16
    kernel, B3's launches per rank against the level chunks.  It prints
    each rank's time split (staging or binning, kernel, wire, rest), the
    schedule the stats rode and the allreduce times at the stats' and
    the largest level's sizes;
18. (after 17) the pysocket engine's async pump, bucket fusion, custom
    reduction and hierarchical schedule at world 3: the port's
    ``Tracker(3)`` twice and three rank processes again (this script
    with ``--phase18-rank``).  (a) Each rank takes its third of phase
    10's rows (699,051 x 64, 256 bins and the missing slot, binned on
    the card from rank 0's cuts) and one tree level of 32 nodes: each
    node's (64, 257, 2) float32 histogram (131,584 B) comes from B3 over
    the rows with that node's weights (zero elsewhere) and is issued
    through ``build_allreduce_async(..., fuse=True)``, waited in issue
    order; the fused results must equal, bit for bit, the same local
    histograms allreduced with ``fuse=False`` and through
    ``allreduce_many``, on every rank alike, with 32 B3 launches and 5
    fused wire ops (buckets of 7, 7, 7, 7 and 4 under the 1 MiB
    ``rabit_bucket_bytes``) a rank; it prints the stream's host time
    and the fused and solo wire times.  (b) ``kmeans.run`` on phase 17's
    dense16 thirds, 3 iterations, under ``rabit_sched=hier`` with
    ``RABIT_TRACKER_GROUPS=0,0,1`` (ranks 0 and 1 one group, rank 2 the
    other): counts exact against phase 17's oracle every iteration,
    centroids bit-identical on the ranks, B1 on each, the stats
    allreduce time printed beside phase 17's ring.  (c) The last
    iteration's local (64, 257) stats through ``allreduce_custom`` with
    an ``np.add`` reducer: the bits of a forced-tree ``allreduce`` SUM
    of the same stats, on every rank.

It ends with three lines: the card's name and power limit as
``nvidia-smi`` gives them, a JSON line of kernel numbers
(``{"kernels": [...]}``), and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.  K-means data is
clustered so that every row's best centroid wins by a wide margin, and
GBDT labels come from a planted tree whose splits win by wide margins:
counts, assignments and the top splits are then compared exactly, and
summation order alone separates kernel and plain sums.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 64
MAIN_ROWS = 1 << 22               # 4,194,304: over the 2 GiB dense budget
DP_RANKS = 4                      # logical ranks of the data-parallel steps
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor / FMA
F32_ADDS_PER_S = PEAK_OPS["float32"] / 2            # an FMA counts as two
SMEM_BYTES_PER_CLOCK = 128        # an SM's shared memory, 32 banks x 4 B
GBDT_ROWS, GBDT_FEATURES, GBDT_NBIN = 1 << 21, 64, 256
GBDT_DEPTH, GBDT_ROUNDS = 6, 4
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
def clustered_dense(torch, n, d, k, dtype, seed, tie=None):
    """Rows near one of k random unit directions, and centroids near
    the same directions: cosine margins of ~0.9 against rounding noise
    of ~1e-3.  ``tie=(a, b)``: centroid b is a copy of centroid a and
    rows of cluster b move to a, so every row of a ties exactly between
    a and b, and no row is left without a clear winner."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    basis = torch.randn(k, d, generator=g, device="cuda")
    basis /= basis.norm(dim=1, keepdim=True)
    label = torch.randint(0, k, (n,), generator=g, device="cuda")
    x = basis[label] + 0.02 * torch.randn(n, d, generator=g, device="cuda")
    cent = basis + 0.02 * torch.randn(k, d, generator=g, device="cuda")
    if tie is not None:
        a, b = tie
        cent[b] = cent[a]
        x[label == b] = (basis[a] + 0.02 * torch.randn(
            int((label == b).sum()), d, generator=g, device="cuda"))
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


def sparse_clusters(n, d, nnz, k, seed, init_seed=0, picks=None):
    """A SparseMat of n clustered rows for kmeans.run: each cluster has
    16 signature features; a row puts 3/4 of its slots there and the
    rest on random features.  The rows run() seeds its centroids from
    (the same numpy draws as init_centroids at world 1, or ``picks``,
    the global rows it seeds them from at a larger world) are given one
    cluster each, so no cluster starts with two centroids and no row
    sits on a tie."""
    from rabit_tpu_torch.learn.data import SparseMat

    rng = np.random.default_rng(seed)
    sig = np.stack([rng.choice(d, 16, replace=False) for _ in range(k)])
    label = rng.integers(0, k, n)
    if picks is None:
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


def dense_plan(torch, kk, x, k):
    """B1's plan for x and k, checked against the shared memory the
    kernel's source states for each stage."""
    n, d = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = kk._dense_plan(n, d, k, x.dtype, sms)
    lib = kk._dense_lib()
    bf16 = int(x.dtype == torch.bfloat16)
    for stage, want in ((0, plan.classify_smem), (1, plan.fold_smem)):
        got = lib.kmeans_stats_dense_smem_bytes(stage, bf16, k, plan.dt)
        if got != want:
            raise AssertionError(f"B1 plan for ({n}, {d}) k={k}: stage "
                                 f"{stage} shared memory {want} B, the "
                                 f"kernel's source says {got} B")
    return plan


def check_dense(torch, kk, name, cent, x, valid):
    plan = dense_plan(torch, kk, x, cent.shape[0])
    got = kk.kmeans_stats_fused(cent, x, valid)
    again = kk.kmeans_stats_fused(cent, x, valid)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    want = kk._stats_plain(kk._normalized(cent, x.dtype), x, valid)
    err = compare(torch, name, got, want)
    log(f"  {name}: ok (same bits twice, counts exact, sums within rtol "
        f"{SUM_RTOL} atol {SUM_ATOL}), max |kernel - plain| = {err:.3g}; "
        f"fold {plan.tiles} x {plan.dt} columns by {plan.chunks} chunks of "
        f"{plan.chunk_rows} rows")
    return got, err


def dense_kernel_checks(torch, kk):
    """Phase 3: B1 against its plain version at the old shapes, then the
    widths C1 broke (d past 1,744), ragged shapes, rows in a strided view
    (the chained float32 dense tier's layout), a tie across a
    64-centroid chunk, and k=1000; each in float32 and bfloat16."""
    log("[3] dense stats kernel vs plain")
    for dtype in (torch.float32, torch.bfloat16):
        cent, x, valid = clustered_dense(torch, 1 << 19, 256, K, dtype, 3)
        check_dense(torch, kk, f"n=2^19 d=256 k=64 {dtype}", cent, x, valid)
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
    for n, d, k, seed in ((1 << 18, 2048, K, 31), (3001, 2050, 100, 32),
                          (1 << 13, 32768, K, 33), (1 << 16, 256, 1000, 34)):
        for dtype in (torch.float32, torch.bfloat16):
            cent, x, valid = clustered_dense(torch, n, d, k, dtype, seed)
            check_dense(torch, kk, f"n={n} d={d} k={k} {dtype}", cent, x,
                        valid)
            del cent, x, valid
    # rows of d+1 elements, x an (n, d) view: 16-byte loads do not line up
    for n, d in ((1 << 17, 2048), (3001, 2050)):
        for dtype in (torch.float32, torch.bfloat16):
            cent, x, valid = clustered_dense(torch, n, d + 1, K, dtype, 35)
            check_dense(torch, kk, f"strided view n={n} d={d} (rows of "
                        f"{d + 1}) k=64 {dtype}", cent[:, :d], x[:, :d],
                        valid)
            del cent, x, valid
    # centroid 67 copies centroid 3: every tied row lands on 3, the first
    # index, across the boundary of the 64-centroid chunks
    for dtype in (torch.float32, torch.bfloat16):
        cent, x, valid = clustered_dense(torch, 1 << 16, 256, 100, dtype, 36,
                                         tie=(3, 67))
        got, _ = check_dense(torch, kk, f"tie 3 = 67 n=2^16 d=256 k=100 "
                             f"{dtype}", cent, x, valid)
        if float(got[67, -1]) != 0.0 or float(got[3, -1]) <= 0.0:
            raise AssertionError(f"tie {dtype}: counts {float(got[3, -1])} "
                                 f"on 3 and {float(got[67, -1])} on 67")
        log(f"    tie {dtype}: {float(got[3, -1]):.0f} rows on centroid 3, "
            "none on 67")


def dense_split_ms(torch, kk, cent, x, valid):
    """B1's three stages timed apart on the same inputs: classify, fold
    (on the classify stage's assignments), reduce."""
    cn = kk._normalized(cent, x.dtype)
    _out, ws = kk._dense_launch(cn, x, valid)
    return {name: time_ms(torch, lambda: kk._dense_launch(cn, x, valid,
                                                          stages, ws))
            for name, stages in (("classify", 1), ("fold", 2),
                                 ("reduce", 4))}


SASS_OPS = ("HMMA", "LDSM", "LDS")
_SASS_OP = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)")


def sass_counts(path):
    """Counts of the instructions of ``SASS_OPS`` in the SASS of the
    library at ``path`` (tensor-core products, ``ldmatrix`` loads, other
    shared-memory loads; by opcode, whatever its suffixes), or None and
    why they could not be counted."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None, "cuobjdump not found"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None, f"cuobjdump failed: {out.stderr.strip()[:200]}"
    counts = dict.fromkeys(SASS_OPS, 0)
    for m in _SASS_OP.finditer(out.stdout):
        if m.group(1) in counts:
            counts[m.group(1)] += 1
    return counts, "cuobjdump"


def check_ell(torch, kk, name, cent, idx, val, valid, d, cdt):
    n, nnz = idx.shape
    flat = kk.kmeans_ell_stats_fused(cent, idx, val, valid, d,
                                     compute_dtype=cdt)
    again = kk.kmeans_ell_stats_fused(cent, idx, val, valid, d,
                                      compute_dtype=cdt)
    grouped = kk.kmeans_ell_stats_fused(
        cent, idx.view(n // 4, 4 * nnz), val.view(n // 4, 4 * nnz), valid,
        d, nnz=nnz, group=4, compute_dtype=cdt)
    torch.cuda.synchronize()
    if not torch.equal(flat, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    if not torch.equal(flat, grouped):
        raise AssertionError(f"{name}: flat and grouped layouts differ")
    want = kk._ell_stats_plain(kk._normalized(cent, cdt), idx, val, valid, d)
    err = compare(torch, name, flat, want)
    plan = kk._ell_plan(kk._ell_lib(), idx.device, n, d, cent.shape[0], nnz)
    log(f"  {name}: ok (same bits twice, flat == grouped), max |kernel - "
        f"plain| = {err:.3g}; grid {plan[0]} x {plan[1]}, {plan[2]} column "
        f"slice(s), {plan[4]} row(s) a warp, row groups in "
        f"{'device' if plan[5] else 'shared'} memory")
    return plan


def ell_edge_case(torch, n, d, nnz, k, seed):
    """clustered_ell rows with the ELL kernel's edge cases: slots 1-3 of a
    quarter of the rows repeat slot 0 (2-4 duplicates of one index),
    every 97th row all pad slots, a tenth of the rows of validity 0, and
    indices below 0 or at/above d that carry values (dropped)."""
    cent, idx, val, valid = clustered_ell(torch, n, d, nnz, k, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = torch.rand(n, generator=g, device="cuda")
    for j, frac in ((1, 0.25), (2, 0.15), (3, 0.05)):
        dup = rows < frac
        idx[dup, j] = idx[dup, 0]
    pad = torch.arange(n, device="cuda") % 97 == 0
    idx[pad] = d
    val[pad] = 0.0
    valid[torch.rand(n, generator=g, device="cuda") < 0.1] = 0.0
    r = torch.rand(n, nnz, generator=g, device="cuda")
    idx[(r < 0.01) & ~pad[:, None]] = -3
    idx[(r > 0.995) & ~pad[:, None]] = d + 11
    return cent, idx, val, valid


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


# ------------------------------------------------------------------ GBDT
def gbdt_data(n, f, seed):
    """Uniform features in [-1, 1) and labels from a planted depth-3 tree
    on features 0-4 whose leaf rates lie far apart, so that the top three
    levels' splits win by wide margins; 2% NaN in each of the last 8
    features (missing values, none on a planted feature)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, f), dtype=np.float32) * 2 - 1
    left = x[:, 0] < 0.1
    leaf = np.where(left, (x[:, 1] >= -0.3) * 2 + (x[:, 3] >= 0.2),
                    4 + (x[:, 2] >= 0.4) * 2 + (x[:, 4] >= -0.5))
    rate = np.array([0.05, 0.3, 0.6, 0.9, 0.15, 0.45, 0.75, 0.97],
                    np.float32)
    y = (rng.random(n, dtype=np.float32) < rate[leaf]).astype(np.float32)
    x[:, f - 8:][rng.random((n, 8), dtype=np.float32) < 0.02] = np.nan
    return x, y


def level_chunks(tree, max_depth, chunk):
    """Histogram launches train() issues for one tree: one for each chunk
    of ``chunk`` live nodes at every level above ``max_depth``."""
    depth, counts = {0: 0}, [0] * max_depth
    for nid, node in enumerate(tree):        # parents precede children
        if depth[nid] < max_depth:
            counts[depth[nid]] += 1
        if node.feature >= 0:
            depth[node.left] = depth[node.right] = depth[nid] + 1
    return sum(-(-c // chunk) for c in counts)


def top_levels(tree, levels):
    """(feature, threshold, default direction) of the nodes of the top
    ``levels`` levels, breadth first."""
    out, frontier = [], [0]
    for _ in range(levels):
        nxt = []
        for nid in frontier:
            node = tree[nid]
            out.append((node.feature, node.bin_threshold, node.default_left))
            if node.feature >= 0:
                nxt += [node.left, node.right]
        frontier = nxt
    return out


def round_losses(model, bins, y):
    """Training log-loss after each round, the final accuracy and the
    final predictions (margins summed as ``BoostedModel.margin`` does)."""
    m = np.full(len(y), model.base_score, np.float32)
    losses = []
    for tree in model.trees:
        m += model.learning_rate * model._tree_margin(tree, bins)
        p = 1.0 / (1.0 + np.exp(-m.astype(np.float64)))
        losses.append(float(-np.mean(y * np.log(p + 1e-12)
                                     + (1 - y) * np.log(1 - p + 1e-12))))
    return losses, float(((m > 0) == (y > 0.5)).mean()), p


def hist_plan(torch, hk, bins_t, w, nbin, cdt):
    """B3's plan for these inputs, checked against the shared memory the
    kernel's source states for it."""
    f, n = bins_t.shape
    nw = w.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = hk._hist_plan(n, f, nw, nbin, cdt, sms)
    got = hk._lib().gbdt_hist_smem_bytes(
        int(cdt == torch.bfloat16), nbin, plan.warps, plan.cols,
        plan.features, plan.channels, plan.tile_rows)
    if got != plan.smem:
        raise AssertionError(f"B3 plan for f={f} n={n} nw={nw} nbin={nbin} "
                             f"{cdt}: {plan.smem} B of shared memory, the "
                             f"kernel's source says {got} B")
    return plan


def plan_text(plan):
    path = "one-feature warps" if plan.uniform else "general"
    return (f"{plan.warps} warps x {plan.cols} columns, F x C = "
            f"{plan.features} x {plan.channels}, T={plan.tile_rows} "
            f"rows, {path} add path, {plan.chunks} "
            f"chunks of {plan.chunk_rows} rows, {plan.smem} B shared")


def check_hist(torch, hk, name, bins_t, w, nbin, cdt):
    """Kernel against plain on the same inputs: the plan's shared memory
    against the source's, the same bits on two launches, sums within the
    float32 bar; returns max |err|."""
    plan = hist_plan(torch, hk, bins_t, w, nbin, cdt)
    got = hk.hist_fused_multi(bins_t, w, nbin, compute_dtype=cdt)
    again = hk.hist_fused_multi(bins_t, w, nbin, compute_dtype=cdt)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    want = hk._hist_plain(bins_t, w, nbin, cdt)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite sums")
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL,
                               msg=lambda m: f"{name}: {m}")
    err = float((got - want).abs().max())
    log(f"  {name}: ok (same bits twice, within rtol {SUM_RTOL} atol "
        f"{SUM_ATOL}), max |kernel - plain| = {err:.3g}; {plan_text(plan)}")
    return err


def hist_inputs(torch, g, n, f, nw, nbin, bad=0.0):
    """(f, n) int32 bins in [0, nbin), a share ``bad`` of them -1, nbin or
    nbin + 1000 (adding nothing), and (nw, n) weights."""
    bins_t = torch.randint(0, nbin, (f, n), generator=g, device="cuda",
                           dtype=torch.int32)
    if bad:
        odd = torch.tensor([-1, nbin, nbin + 1000], device="cuda",
                           dtype=torch.int32)
        hit = torch.rand(f, n, generator=g, device="cuda") < bad
        bins_t[hit] = odd[torch.randint(0, 3, (int(hit.sum()),),
                                        generator=g, device="cuda")]
    return bins_t, torch.randn(nw, n, generator=g, device="cuda")


def hist_f64(torch, bins_t, w, nbin):
    """B3's function summed in float64 with ``index_add_``, a feature at a
    time."""
    f, n = bins_t.shape
    out = torch.zeros(w.shape[0], f, nbin + 1, dtype=torch.float64,
                      device=w.device)
    wd = w.double()
    for j in range(f):
        b = bins_t[j].long()
        out[:, j].index_add_(1, torch.where((b >= 0) & (b < nbin), b, nbin),
                             wd)
    return out[:, :, :-1]


def check_hist_f64(torch, hk, g):
    """2 slots at 2^19 rows x 16 features x 64 channels (about 2^18 rows a
    slot), kernel and plain against a float64 sum.  Weights that are
    multiples of 1/16 in [-1, 1] keep every partial sum exact in float32
    (|sum| <= 2^19 on a grid of 2^-4: 23 bits), so both must equal it
    bit for bit, in any order.  Normal weights show how far each float32
    sum drifts from it: the rounding error grows with the partial sums
    while a slot's sum can cancel to near 0, so at this size the plain
    version's drift alone (its ``index_add_`` adds in no fixed order) can
    put kernel against plain off the rtol 1e-4 / atol 1e-3 bar of
    ``check_hist``."""
    n, f, nw, nbin = 1 << 19, 16, 64, 2
    b, w = hist_inputs(torch, g, n, f, nw, nbin, bad=0.01)
    exact = torch.randint(-16, 17, (nw, n), generator=g,
                          device="cuda").float() / 16
    for cdt in (torch.bfloat16, torch.float32):
        name = f"n=2^19 f={f} nbin={nbin} nw={nw} {cdt}"
        hist_plan(torch, hk, b, exact, nbin, cdt)
        want = hist_f64(torch, b, exact, nbin)
        for who, got in (("kernel", hk.hist_fused_multi(b, exact, nbin,
                                                        compute_dtype=cdt)),
                         ("plain", hk._hist_plain(b, exact, nbin, cdt))):
            if not torch.equal(got.double(), want):
                raise AssertionError(
                    f"{name}, weights k/16: {who} is off the exact sum by "
                    f"{float((got.double() - want).abs().max()):.3g}")
        ref = hist_f64(torch, b, w.to(cdt), nbin)
        drift = {who: float((got.double() - ref).abs().max()) for who, got in
                 (("kernel", hk.hist_fused_multi(b, w, nbin,
                                                 compute_dtype=cdt)),
                  ("plain", hk._hist_plain(b, w, nbin, cdt)))}
        log(f"  {name}: ok (weights k/16: kernel and plain equal the exact "
            f"sum); normal weights, max |sum - float64 sum|: kernel "
            f"{drift['kernel']:.3g}, plain {drift['plain']:.3g}, the sums "
            f"up to {float(ref.abs().max()):.4g}, the smallest "
            f"{float(ref.abs().min()):.3g}")


def gbdt_kernel_checks(torch, hk):
    """Phase 9; returns the main-shape bins and the max errors."""
    log("[9] GBDT histogram kernel vs plain")
    n, f, nbin = GBDT_ROWS, GBDT_FEATURES, GBDT_NBIN + 1
    g = torch.Generator(device="cuda").manual_seed(12)
    bins_t = torch.randint(0, nbin, (f, n), generator=g, device="cuda",
                           dtype=torch.int32)
    errs = {}
    # the level widths, and ragged channel groups (1, 3, 33)
    for nw in (1, 2, 3, 16, 33, 64):
        w = torch.randn(nw, n, generator=g, device="cuda")
        for cdt in (torch.bfloat16, torch.float32):
            errs[nw, cdt] = check_hist(
                torch, hk, f"n=2^21 f=64 nbin=257 nw={nw} {cdt}", bins_t, w,
                nbin, cdt)
    # ragged feature rectangles: 1 and 3 features of 64 channels
    w = torch.randn(64, n, generator=g, device="cuda")
    for nf in (1, 3):
        for cdt in (torch.bfloat16, torch.float32):
            check_hist(torch, hk, f"n=2^21 f={nf} nbin=257 nw=64 {cdt}",
                       bins_t[:nf], w, nbin, cdt)
    del w
    # bins -1, nbin and 1000 add nothing: at the main shape and ragged
    odd = torch.tensor([-1, nbin, 1000], device="cuda", dtype=torch.int32)
    bad = bins_t.clone()
    hit = torch.rand(f, n, generator=g, device="cuda") < 0.01
    bad[hit] = odd[torch.randint(0, 3, (int(hit.sum()),), generator=g,
                                 device="cuda")]
    check_hist(torch, hk, "n=2^21 f=64 nbin=257 nw=16 out-of-range bins",
               bad, torch.randn(16, n, generator=g, device="cuda"), nbin,
               torch.float32)
    del bad, hit
    # rows under one tile, and rows that are no multiple of the 16-byte
    # copies (every staged row goes element by element)
    for rows, nw in ((5, 64), (100003, 64), (100003, 3)):
        b, w = hist_inputs(torch, g, rows, f, nw, nbin, bad=0.01)
        for cdt in (torch.bfloat16, torch.float32):
            check_hist(torch, hk, f"n={rows} f=64 nbin=257 nw={nw} {cdt}",
                       b, w, nbin, cdt)
    # other widths: 2 slots (2^14 rows: about 8,000 a slot, as at the
    # main shape; 2^19 rows in check_hist_f64), and 1024-4096, where the
    # warps narrow
    for width, rows in ((2, 1 << 14), (1024, 1 << 19), (2048, 1 << 19),
                        (4096, 1 << 19)):
        b, w = hist_inputs(torch, g, rows, 16, 64, width, bad=0.01)
        for cdt in (torch.bfloat16, torch.float32):
            check_hist(torch, hk, f"n={rows} f=16 nbin={width} nw=64 {cdt}",
                       b, w, width, cdt)
    check_hist_f64(torch, hk, g)
    # the top of the range: one-column warps, 8-row tiles
    b, w = hist_inputs(torch, g, 3001, 3, 64, 58045, bad=0.01)
    for cdt in (torch.bfloat16, torch.float32):
        check_hist(torch, hk, f"n=3001 f=3 nbin=58045 nw=64 {cdt}", b, w,
                   58045, cdt)
    del b, w
    n, f, nbin = 100003, 5, 7
    small = torch.randint(0, nbin, (f, n), generator=g, device="cuda",
                          dtype=torch.int32)
    hit = torch.rand(f, n, generator=g, device="cuda") < 0.2
    small[hit] = odd[torch.randint(0, 3, (int(hit.sum()),), generator=g,
                                   device="cuda")]
    w = torch.randn(3, n, generator=g, device="cuda")
    for cdt in (torch.bfloat16, torch.float32):
        check_hist(torch, hk, f"ragged n={n} f={f} nbin={nbin} nw=3 {cdt}",
                   small, w, nbin, cdt)
    got = hk.hist_fused_multi(small, w, nbin, compute_dtype=torch.float32)
    kept = w.double() @ (~hit).double().T       # (nw, f) in-range mass
    torch.testing.assert_close(got.sum(dim=2).double(), kept, rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    log(f"  ragged: the mass of the {int(hit.sum())} out-of-range bins is "
        "dropped")
    return bins_t, errs


def gbdt_main_path(torch, rabit_tpu_torch, kk, hk):
    """Phase 10: boosting.train on the card, three ways."""
    from rabit_tpu_torch.learn import boosting as gb
    from rabit_tpu_torch.learn import histogram as bh

    n, f = GBDT_ROWS, GBDT_FEATURES
    t0 = time.perf_counter()
    x, y = gbdt_data(n, f, seed=11)
    log(f"[10] GBDT main path: n={n} f={f} nbin={GBDT_NBIN} (+1 missing "
        f"slot) depth={GBDT_DEPTH} rounds={GBDT_ROUNDS} logistic (data "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    bins, _cuts = bh.quantize(x, GBDT_NBIN)   # train()'s round-0 binning
    binning_s = time.perf_counter() - t0
    chunk = hk.max_channels(GBDT_NBIN + 1, f) // 2
    runs = {}
    real = hk.hist_fused_multi
    for label, kw in (("f32 kernel", dict(compute_dtype="float32")),
                      ("plain", dict(use_kernel=False)),
                      ("bf16 kernel", {})):
        events, stamps, widths = [], [], []

        def timed(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real(*a, **k)
            ev[1].record()
            events.append(ev)
            widths.append(int(a[1].shape[0]))     # nw: 2 x the level's nodes
            return out

        rabit_tpu_torch.init(rabit_engine="empty")
        commit = rabit_tpu_torch.checkpoint

        def stamped(model):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            commit(model)

        hk.hist_fused_multi, rabit_tpu_torch.checkpoint = timed, stamped
        for counts in (kk.LAUNCHES, hk.LAUNCHES):
            for key in counts:
                counts[key] = 0
        t1 = time.perf_counter()
        try:
            model = gb.train(x, y, num_round=GBDT_ROUNDS,
                             max_depth=GBDT_DEPTH, nbin=GBDT_NBIN, **kw)
            torch.cuda.synchronize()
        finally:
            hk.hist_fused_multi, rabit_tpu_torch.checkpoint = real, commit
            rabit_tpu_torch.finalize()
        wall = time.perf_counter() - t1
        launches = hk.LAUNCHES["gbdt_hist"]
        want = (0 if label == "plain" else
                sum(level_chunks(t, GBDT_DEPTH, chunk) for t in model.trees))
        if launches != want or (label != "plain" and launches == 0) \
                or any(kk.LAUNCHES.values()):
            raise AssertionError(f"GBDT {label}: {launches} histogram "
                                 f"launches for {want} level chunks, k-means "
                                 f"{kk.LAUNCHES}")
        losses, acc, pred = round_losses(model, bins, y)
        b3_ms = sum(a.elapsed_time(b) for a, b in events)
        rounds = np.diff([t1] + stamps)
        runs[label] = dict(model=model, losses=losses, acc=acc, pred=pred,
                           launches=launches, wall=wall, b3_ms=b3_ms,
                           rounds=rounds,
                           by_nw={nw: widths.count(nw) for nw in set(widths)})
        log(f"    {label}: {wall:.2f} s ({', '.join(f'{r:.2f}' for r in rounds)}"
            f" s by round), histogram launches {launches} (= level chunks), "
            f"B3 calls {b3_ms:.1f} ms, log-loss by round "
            f"{[round(v, 5) for v in losses]}, accuracy {acc:.4f}")
    k32, plain, k16 = runs["f32 kernel"], runs["plain"], runs["bf16 kernel"]
    # 1. float32 kernel against the plain path
    top_k = top_levels(k32["model"].trees[0], 3)
    top_p = top_levels(plain["model"].trees[0], 3)
    if top_k != top_p:
        raise AssertionError(f"first tree's top levels differ:\n{top_k}\n"
                             f"{top_p}")
    rel = max(abs(a - b) / b for a, b in zip(k32["losses"], plain["losses"]))
    if rel > 1e-4:
        raise AssertionError(f"float32 kernel log-loss off the plain path "
                             f"by {rel:.3g} relative (bar 1e-4)")
    dpred = float(np.abs(k32["pred"] - plain["pred"]).max())
    log(f"    f32 kernel vs plain: top 3 levels identical {top_k}; log-loss "
        f"within {rel:.3g} relative; max |d prediction| {dpred:.3g}")
    # 2. the default bfloat16 kernel
    leaves = [node.value for t in k16["model"].trees for node in t]
    if not np.isfinite(leaves).all():
        raise AssertionError("bf16 kernel: non-finite leaf values")
    if any(b >= a for a, b in zip(k16["losses"], k16["losses"][1:])):
        raise AssertionError(f"bf16 kernel: log-loss did not fall every "
                             f"round: {k16['losses']}")
    if abs(k16["acc"] - k32["acc"]) > 0.005:
        raise AssertionError(f"bf16 kernel accuracy {k16['acc']:.4f} vs "
                             f"{k32['acc']:.4f} (bar 0.5 points)")
    log(f"    bf16 kernel: finite trees, log-loss falls every round, "
        f"accuracy {k16['acc']:.4f} vs f32 {k32['acc']:.4f}")
    log(f"    bf16 kernel launches by channel count nw: "
        f"{dict(sorted(k16['by_nw'].items()))}")
    return dict(launches=k16["launches"], wall=k16["wall"],
                rounds=k16["rounds"], b3_ms=k16["b3_ms"], binning_s=binning_s,
                plain_wall=plain["wall"], f32_wall=k32["wall"], bins=bins,
                by_nw=k16["by_nw"])


def index_add_ms(torch, bins_t, w, nbin, budget=1 << 33):
    """The library call's time for B3's function: ``index_add_`` of the
    weights, expanded to one source row per (feature, row), along the
    flattened (feature, slot) axis.  Where that source passes ``budget``
    bytes (nw=64: 34 GB) the rows go in chunks whose source fits, each
    chunk's call timed apart and the times summed."""
    f, n = bins_t.shape
    nw = w.shape[0]
    rows = max(1, min(n, budget // (nw * f * 4)))
    acc = torch.zeros(nw, f * nbin, device="cuda")
    off = torch.arange(f, device="cuda")[:, None] * nbin
    total = 0.0
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        idx = (bins_t[:, lo:hi].long() + off).reshape(-1)
        src = w[:, lo:hi].float()[:, None, :].expand(nw, f, hi - lo
                                                      ).reshape(nw, -1)
        total += time_ms(torch, lambda: acc.index_add_(1, idx, src))
        del idx, src
    return total


def gbdt_timing(torch, hk, bins_t, errs, gbdt):
    """Phase 11: B3 times at the main shape and train()'s time split;
    returns the kernel's JSON entry."""
    log("[11] GBDT histogram timing (CUDA events, median of 5 after 2 "
        "warm-up calls), bfloat16 weights")
    f, n = bins_t.shape
    nbin = GBDT_NBIN + 1
    g = torch.Generator(device="cuda").manual_seed(13)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    adds_per_s = SMEM_BYTES_PER_CLOCK / 8 * sms * clock_mhz * 1e6
    log(f"    shared-memory floor: 8 B of shared traffic an add (a 4-byte "
        f"load and store) at {SMEM_BYTES_PER_CLOCK} B a clock on each of "
        f"{sms} SMs at the top SM clock of {clock_mhz:.0f} MHz: "
        f"{adds_per_s:.3g} adds/s")
    by_nw = {}
    for nw in sorted({2, 16, 64} | set(gbdt["by_nw"])):
        w = torch.randn(nw, n, generator=g, device="cuda").to(torch.bfloat16)
        if nw in (2, 64):
            log(f"    plan at nw={nw}: "
                f"{plan_text(hist_plan(torch, hk, bins_t, w, nbin, w.dtype))}")
        ms = time_ms(torch, lambda: hk.hist_fused_multi(bins_t, w, nbin))
        plan = hk._hist_plan(n, f, nw, nbin, torch.bfloat16, sms)
        if plan.uniform:
            # the A/B that keeps the one-feature-warp add path: the same
            # plan on the general path, which must give the same bits
            general = dataclasses.replace(plan, uniform=False)
            run = lambda: hk._hist_cuda(bins_t, w, nbin,  # noqa: E731
                                        torch.bfloat16, general)
            if not torch.equal(run(), hk.hist_fused_multi(bins_t, w, nbin)):
                raise AssertionError(f"B3 nw={nw}: the general add path "
                                     "gave other bits")
            general_ms = time_ms(torch, run)
            again_ms = time_ms(torch, lambda: hk.hist_fused_multi(bins_t, w,
                                                                  nbin))
            log(f"    nw={nw}: one-feature-warp add path {ms:.3f} / "
                f"{again_ms:.3f} ms (before / after), the general path "
                f"{general_ms:.3f} ms on the same plan, the same bits")
        plain_ms = time_ms(
            torch, lambda: hk._hist_plain(bins_t, w, nbin, torch.bfloat16),
            1, 3)
        library_ms = index_add_ms(torch, bins_t, w, nbin)
        nbytes = f * n * 4 + nw * n * 2 + nw * f * nbin * 4
        adds = nw * f * n
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, adds / F32_ADDS_PER_S
        by_nw[nw] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=max(by_bytes, by_ops) * 1e3,
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations",
                         launches=gbdt["by_nw"].get(nw, 0),
                         max_abs_err=errs.get((nw, torch.bfloat16)))
        log(f"    nw={nw}: shared-memory floor "
            f"{max(by_bytes, adds / adds_per_s) * 1e3:.3f} ms (the bytes "
            "where larger)")
        log(f"    nw={nw}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"index_add_ {'-' if library_ms is None else f'{library_ms:.3f}'}"
            f" ms, bound {by_nw[nw]['bound_ms']:.3f} ms by "
            f"{by_nw[nw]['bound_by']}")
        del w
    # train()'s time: host binning, uploads, B3, and the rest (numpy tree
    # work, node masks on the device)
    t0 = time.perf_counter()
    up = torch.from_numpy(np.ascontiguousarray(gbdt["bins"].T)).cuda()
    torch.cuda.synchronize()
    bins_up_s = time.perf_counter() - t0
    vec = np.zeros(GBDT_ROWS, np.float32)
    t0 = time.perf_counter()
    for _ in range(3):               # grad, hess and node_of_row
        torch.from_numpy(vec).cuda()
    torch.cuda.synchronize()
    level_up_s = time.perf_counter() - t0
    del up
    levels = GBDT_ROUNDS * GBDT_DEPTH
    wall, b3 = gbdt["wall"], gbdt["b3_ms"] / 1e3
    uploads = bins_up_s + levels * level_up_s
    rest = wall - gbdt["binning_s"] - uploads - b3
    log(f"    train() bf16: {wall:.2f} s for {GBDT_ROUNDS} rounds "
        f"({wall / GBDT_ROUNDS:.2f} s a round; rounds 2-{GBDT_ROUNDS} "
        f"{np.mean(gbdt['rounds'][1:]):.2f} s each); host binning "
        f"{gbdt['binning_s']:.2f} s, uploads {uploads:.3f} s (bins once "
        f"{bins_up_s:.3f} s, {levels} levels x {level_up_s * 1e3:.1f} ms), "
        f"B3 calls {b3:.3f} s ({100 * b3 / wall:.1f}% of train()), the rest "
        f"(numpy tree work, masks) {rest:.2f} s; plain path train() "
        f"{gbdt['plain_wall']:.2f} s, f32 kernel {gbdt['f32_wall']:.2f} s")
    gap = sum(v["launches"] * (v["ms"] - v["bound_ms"])
              for v in by_nw.values())
    log(f"    B3 launches x (ms - bound) summed over the levels of train(): "
        f"{gap:.1f} ms")
    main = by_nw[16]
    return dict(
        name="gbdt_hist", route="cuda",
        source="rabit_tpu_torch/ops/csrc/histogram.cu",
        replaces="rabit_tpu/ops/histogram_kernel.py:102",
        launches=gbdt["launches"], max_abs_err=main["max_abs_err"],
        ms=main["ms"], kernel_ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"],
        library="torch.Tensor.index_add_ along the flattened (feature, "
                "slot) axis",
        shape=f"bins_t ({f}, {n}) int32, nw=16 bfloat16 weights, "
              f"nbin={nbin}",
        by_nw={str(k): v for k, v in by_nw.items()},
        launches_x_gap_ms=gap, train_s=wall, train_b3_share=b3 / wall)


# ------------------------------------------------- ring allreduce (B4)
def same_bits(torch, got, want) -> bool:
    """Equal bits, except that any NaN matches any NaN."""
    if got.dtype.is_floating_point:
        nan = torch.isnan(got)
        if not torch.equal(nan, torch.isnan(want)):
            return False
        got, want = got.masked_fill(nan, 0), want.masked_fill(nan, 0)
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return torch.equal(got.view(width[got.element_size()]),
                       want.view(width[want.element_size()]))


def ring_case(torch, ndev, shape, dtype, g, nan=False):
    if dtype == torch.int32:
        return [torch.randint(-1000, 1000, shape, generator=g, device="cuda",
                              dtype=torch.int32) for _ in range(ndev)]
    xs = [torch.randn(shape, generator=g, device="cuda") for _ in range(ndev)]
    if nan:
        for x in xs:
            x[torch.rand(shape, generator=g, device="cuda") < 0.01] = np.nan
    return [x.to(dtype) for x in xs]


def check_ring(torch, rg, name, xs, op):
    got = rg.ring_allreduce_p2p(xs, op)
    want = rg._ring_plain(xs, op)
    for r, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not same_bits(torch, a, b):
            raise AssertionError(f"B4 {name} {op.name}: rank {r} differs "
                                 "from the plain ring")
    return float((got[0].double() - want[0].double()).nan_to_num().abs()
                 .max())


def ring_checks(torch, rg):
    """Phase 12: B4 against its plain version, bit for bit; returns the
    largest |kernel - plain| seen (0 when every bit agrees)."""
    from rabit_tpu_torch.ops import ReduceOp

    log("[12] ring allreduce kernel (B4) vs plain, bit for bit")
    g = torch.Generator(device="cuda").manual_seed(21)
    ops = (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.PROD)
    sizes = ((1000,), (257,), (17, 9), (1 << 20,), (10 ** 7,))
    n, worst = 0, 0.0
    for ndev in (2, 3, 4, 8):
        for shape in sizes:
            for dtype in (torch.float32, torch.int32, torch.bfloat16):
                xs = ring_case(torch, ndev, shape, dtype, g)
                for op in ops:
                    worst = max(worst, check_ring(
                        torch, rg, f"ndev={ndev} {shape} {dtype}", xs, op))
                    n += 1
                if dtype == torch.int32:   # integers: any order, one sum
                    got = rg.ring_allreduce_p2p(xs)[0]
                    if not torch.equal(got, torch.stack(xs).sum(0)
                                       .to(torch.int32)):
                        raise AssertionError(f"B4 int32 ndev={ndev} {shape}"
                                             ": SUM off torch.sum")
    log(f"    {n} cases: 4 ops x ranks 2/3/4/8 x {len(sizes)} shapes x "
        "float32/int32/bfloat16, every rank's bits equal to the plain ring;"
        " int32 SUM equal to torch.sum")
    for ndev, shape in ((4, (1000,)), (8, (1 << 20,))):
        for dtype in (torch.float32, torch.bfloat16):
            xs = ring_case(torch, ndev, shape, dtype, g, nan=True)
            for op in (ReduceOp.MAX, ReduceOp.MIN):
                check_ring(torch, rg, f"NaN ndev={ndev} {shape} {dtype}", xs,
                           op)
                got = rg.ring_allreduce_p2p(xs, op)[0]
                if not torch.equal(torch.isnan(got),
                                   torch.isnan(torch.stack(xs)).any(0)):
                    raise AssertionError("B4: NaN did not propagate")
    log("    MAX/MIN with 1% NaN inputs: the same bits, NaN wherever a rank "
        "held one")
    # rank views 4 bytes past a 16-byte boundary (the kernel's scalar
    # path) and sizes that are not a multiple of its 16-byte vectors
    m = 0
    for ndev in (2, 3, 8):
        for size in (255, 1001, (1 << 20) + 3):
            for dtype in (torch.float32, torch.int32, torch.bfloat16):
                whole = ring_case(torch, ndev, (size + 2,), dtype, g)
                for xs in ([x[1:size + 1] for x in whole],
                           [x[:size] for x in whole]):
                    for op in ops:
                        worst = max(worst, check_ring(
                            torch, rg, f"views ndev={ndev} ({size},) {dtype}",
                            xs, op))
                        m += 1
    log(f"    {m} cases of rank views at offset 1 and 0 (sizes 255, 1001, "
        "2^20+3): the same bits")
    a = ring_case(torch, 8, (10 ** 7,), torch.float32, g)
    b = ring_case(torch, 3, (257,), torch.float32, g)
    want_a, want_b = rg._ring_plain(a), rg._ring_plain(b)
    for xs, want in ((a, want_a), (b, want_b), (a, want_a), (b, want_b)):
        got = rg.ring_allreduce_p2p(xs)
        if not all(same_bits(torch, p, q) for p, q in zip(got, want)):
            raise AssertionError("B4: a launch after another shape differs")
    log("    back to back (8 x 10^7, 3 x 257, again): the same bits as fresh")
    return worst


def back_to_back_ms(torch, fn, reps=50):
    """Mean time of ``reps`` calls enqueued back to back, between two CUDA
    events: the device's time where it, not the host, is the limit."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def ring_timing(torch, rg, shapes):
    """B4's times at each {label: (ndev, size)}; the first is the main
    entry of the JSON line.  ``ms`` is one call between two events (the
    host's work included, as a data-parallel step sees it);
    ``back_to_back_ms`` the mean of 50 calls in a row."""
    by_shape = {}
    g = torch.Generator(device="cuda").manual_seed(22)
    for label, (ndev, size) in shapes.items():
        xs = ring_case(torch, ndev, (size,), torch.float32, g)
        ms = time_ms(torch, lambda: rg.ring_allreduce_p2p(xs))
        plain_ms = time_ms(torch, lambda: rg._ring_plain(xs), 1, 3)
        library_ms = time_ms(torch, lambda: torch.stack(xs).sum(0))
        nbytes = 2 * ndev * size * 4
        adds = (ndev - 1) * size
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, adds / F32_ADDS_PER_S
        b2b = back_to_back_ms(torch, lambda: rg.ring_allreduce_p2p(xs))
        b2b_lib = back_to_back_ms(torch, lambda: torch.stack(xs).sum(0))
        by_shape[label] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            back_to_back_ms=b2b, library_back_to_back_ms=b2b_lib,
            bound_ms=max(by_bytes, by_ops) * 1e3,
            bound_by="bytes" if by_bytes >= by_ops else "operations")
        log(f"    B4 {label} ({ndev} ranks x {size} float32): kernel "
            f"{ms:.4f} ms ({b2b:.4f} back to back), plain {plain_ms:.3f} ms, "
            f"torch.stack(xs).sum(0) {library_ms:.4f} ms ({b2b_lib:.4f} back "
            f"to back), bound {by_shape[label]['bound_ms']:.4f} ms by "
            f"{by_shape[label]['bound_by']}")
    return by_shape


# ------------------------------------------------ data-parallel steps
def data_parallel(torch, results, bins_t, kk, hk, rg):
    """Phase 13: dryrun_multichip's data-parallel steps over DP_RANKS
    logical ranks at the main paths' widths; returns the launch counts
    and B4's payload sizes."""
    from rabit_tpu_torch.learn import histogram as bh
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.parallel.mesh import local_data_slice, make_mesh

    ranks = make_mesh(devices=["cuda:0"] * DP_RANKS).rank_devices()
    log(f"[13] data-parallel steps over {DP_RANKS} logical ranks "
        f"({', '.join(map(str, ranks))})")
    dense, ell = results["dense"], results["ell"]
    x16, v16, cent16 = dense["x"], dense["valid"], dense["cent"]
    idx_g, val_g, dvalid, d_pad, nnz = ell["payload"]
    n_ell = idx_g.shape[0] * 4
    flat_i, flat_v = idx_g.view(n_ell, nnz), val_g.view(n_ell, nnz)
    cent_ell = torch.nn.functional.pad(ell["cent"],
                                       (0, d_pad - ell["cent"].shape[1]))
    f, n = bins_t.shape
    nbin = GBDT_NBIN + 1
    g = torch.Generator(device="cuda").manual_seed(23)
    w = torch.randn(64, n, generator=g, device="cuda")
    w[32:] = w[32:].abs()             # hessian channels: positive
    w = w.to(torch.bfloat16)
    # world-1 references first: their launches are comparisons
    ref_dense = kk.kmeans_stats_fused(cent16, x16, v16)
    ref_ell = kk.kmeans_ell_stats_fused(cent_ell, flat_i, flat_v, dvalid,
                                        d_pad)
    ref_hist = hk.hist_fused_multi(bins_t, w, nbin)
    torch.cuda.synchronize()
    rows = [local_data_slice(r, DP_RANKS, x16.shape[0])
            for r in range(DP_RANKS)]
    erows = [local_data_slice(r, DP_RANKS, n_ell) for r in range(DP_RANKS)]
    cols = [local_data_slice(r, DP_RANKS, n) for r in range(DP_RANKS)]
    shards = dict(
        x=[x16[s].to(d) for s, d in zip(rows, ranks)],
        v=[v16[s].to(d) for s, d in zip(rows, ranks)],
        i=[flat_i[s].to(d) for s, d in zip(erows, ranks)],
        val=[flat_v[s].to(d) for s, d in zip(erows, ranks)],
        ev=[dvalid[s].to(d) for s, d in zip(erows, ranks)],
        b=[bins_t[:, s].contiguous().to(d) for s, d in zip(cols, ranks)],
        w=[w[:, s].contiguous().to(d) for s, d in zip(cols, ranks)])
    torch.cuda.synchronize()
    for counts in (kk.LAUNCHES, hk.LAUNCHES, rg.LAUNCHES):
        for key in counts:
            counts[key] = 0
    t0 = time.perf_counter()
    # dense16 k-means step: B1 per rank, B4, centroid update
    stats = [kk.kmeans_stats_fused(cent16.to(d), x, v)
             for d, x, v in zip(ranks, shards["x"], shards["v"])]
    dense_sum = rg.ring_allreduce_p2p(stats)
    new16 = [km.centroid_update(cent16.to(d), s)
             for d, s in zip(ranks, dense_sum)]
    # ELL k-means step: B2 per rank, B4, centroid update
    estats = [kk.kmeans_ell_stats_fused(cent_ell.to(d), i, v, ev, d_pad)
              for d, i, v, ev in zip(ranks, shards["i"], shards["val"],
                                     shards["ev"])]
    ell_sum = rg.ring_allreduce_p2p(estats)
    new_ell = [km.centroid_update(cent_ell.to(d), s)
               for d, s in zip(ranks, ell_sum)]
    # one GBDT level: B3 per rank at nw=64, B4
    hists = [hk.hist_fused_multi(b, ww, nbin)
             for b, ww in zip(shards["b"], shards["w"])]
    hist_sum = rg.ring_allreduce_p2p(hists)
    # the ring against psum on integer-valued floats (section 2b)
    ints = [torch.randint(-8, 9, (512,), generator=g, device="cuda").float()
            for _ in ranks]
    int_sum = rg.ring_allreduce_p2p(ints)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**{k: v for k, v in kk.LAUNCHES.items() if v},
                **hk.LAUNCHES, **rg.LAUNCHES}
    want = {"kmeans_stats_dense": DP_RANKS, "kmeans_stats_ell": DP_RANKS,
            "gbdt_hist": DP_RANKS, "ring_allreduce": 4}
    if launches != want:
        raise AssertionError(f"data-parallel launches {launches}, want "
                             f"{want}")
    log(f"    four steps in {wall:.3f} s, launches {launches}")
    exact = torch.stack(ints).sum(0)
    if not all(torch.equal(s, exact) for s in int_sum + C.allreduce(ints)):
        raise AssertionError("integer-valued ring: off the exact sum")
    log(f"    integer-valued {DP_RANKS} x 512: every rank's ring result and "
        "collectives.allreduce equal the exact sum")
    for name, per_rank, summed, ref in (
            ("dense16 k-means", stats, dense_sum, ref_dense),
            ("ELL k-means", estats, ell_sum, ref_ell),
            ("GBDT level", hists, hist_sum, ref_hist)):
        plain = rg._ring_plain(per_rank)
        named = C.allreduce(per_rank)
        for r in range(DP_RANKS):
            if not same_bits(torch, summed[r], plain[r]):
                raise AssertionError(f"{name}: rank {r} off the plain ring")
        torch.testing.assert_close(summed[0], named[0], rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
        if name == "GBDT level":
            torch.testing.assert_close(summed[0], ref, rtol=SUM_RTOL,
                                       atol=SUM_ATOL)
            err = float((summed[0] - ref).abs().max())
        else:
            err = compare(torch, f"{name} vs world 1", summed[0], ref)
        log(f"    {name}: every rank == plain ring (bits), within the sum "
            f"bar of collectives.allreduce and of world 1 (max |err| "
            f"{err:.3g})")
    for name, new, cent, ref in (("dense16", new16, cent16, ref_dense),
                                 ("ELL", new_ell, cent_ell, ref_ell)):
        want_c = km.centroid_update(cent, ref)
        for c in new:
            if not torch.isfinite(c).all():
                raise AssertionError(f"{name}: non-finite centroids")
            torch.testing.assert_close(c, want_c, rtol=0, atol=CENT_ATOL)
    h = hist_sum[0].cpu().numpy()
    hr = ref_hist.cpu().numpy()
    best = bh.split_gain(np.stack([h[0], h[32]], axis=-1)).argmax(axis=1)
    best_ref = bh.split_gain(np.stack([hr[0], hr[32]], axis=-1)).argmax(
        axis=1)
    if not np.array_equal(best, best_ref):
        raise AssertionError("GBDT level: best bins differ from world 1")
    log(f"    centroid updates within {CENT_ATOL} of world 1 on every rank; "
        f"split_gain's best bin per feature identical for all {f} features")
    return launches, {"k-means stats": (DP_RANKS, stats[0].numel()),
                      "GBDT histograms": (DP_RANKS, hists[0].numel())}


# ------------------------------------------------------------- tools
def ici_sweep(torch):
    """Phase 14: the ici_bench tool over logical ranks."""
    from rabit_tpu_torch.tools import ici_bench

    log("[14] python -m rabit_tpu_torch.tools.ici_bench")
    rows = []
    for argv in (["--ndev", "8", "--impls", "psum,ring,pallas", "--sizes",
                  "10000,100000,1000000,10000000,67108864"],
                 ["--ndev", "2", "--impls", "psum,ring,pallas", "--sizes",
                  "10000000"],
                 ["--ndev", "4", "--impls", "psum,ring,pallas", "--sizes",
                  "10000000"]):
        log(f"    ici_bench {' '.join(argv)}")
        rows += ici_bench.main(argv)
    failed = [r for r in rows if r["seconds"] is None]
    if failed:
        raise AssertionError(f"ici_bench failed: {failed}")
    return rows


def dense_wide_run(torch, rabit_tpu_torch, km, kk, label, n, tier, cdt):
    """Phase 5's runs at d=2048, past the width C1 capped: ``kmeans.run``
    chained 3 at a time for 3 iterations on ``n`` clustered rows, which
    must stage as ``tier``, launch B1 once an iteration at least, and
    end within CENT_ATOL of the plain device loop."""
    d, n_it = 2048, 3
    t0 = time.perf_counter()
    data = sparse_clusters(n, d, 32, K, seed=12)
    rabit_tpu_torch.init(rabit_engine="empty")
    for key in kk.LAUNCHES:
        kk.LAUNCHES[key] = 0
    t1 = time.perf_counter()
    model = km.run(data, K, n_it, device_chain=3, compute_dtype=cdt)
    torch.cuda.synchronize()
    launches = dict(kk.LAUNCHES)
    wall = time.perf_counter() - t1
    init = km.init_centroids(data, K, d, seed=0)
    rabit_tpu_torch.finalize()
    if launches["kmeans_stats_dense"] < n_it:
        raise AssertionError(f"{label}: B1 launched "
                             f"{launches['kmeans_stats_dense']} times for "
                             f"{n_it} iterations")
    idx, val, _lab, valid = data.to_ell(pad_index=d, row_block=1024)
    shard = km.prepare_shard(idx, val, valid, d, 1024, compute_dtype=cdt)
    if shard[0] != tier:
        raise AssertionError(f"{label}: expected the {tier} tier, got "
                             f"{shard[0]}")
    if tier == "dense":
        flat = shard[2].view(-1, d + 1)
        x, v = flat[:, :d], flat[:, d]
    else:
        x, v = shard[2]
    ref = km.device_iterations(torch.from_numpy(init.centroids).cuda(), x,
                               v, n_it, use_kernel=False,
                               compute_dtype=cdt).cpu().numpy()
    err = float(np.abs(model.centroids - ref).max())
    if not (np.isfinite(model.centroids).all()
            and model.centroids.shape == (K, d) and err <= CENT_ATOL):
        raise AssertionError(f"{label}: centroids off the plain loop by "
                             f"{err} (bar {CENT_ATOL})")
    log(f"    {label}: n={n} d={d} {cdt}, tier {tier}, {n_it} chained "
        f"iterations in {wall:.2f} s, launches {launches}; centroids within "
        f"{err:.3g} of the plain loop ({time.perf_counter() - t0:.1f} s "
        "with data and check)")
    return launches["kmeans_stats_dense"]


def variant_plan(torch, kk, x, k):
    """P1's plan for x and k, its shared memory checked against the
    kernel source's (``kmeans_stats_variant_smem_bytes``)."""
    n, d = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = kk._variant_plan(n, d, k, x.dtype, sms)
    got = kk._variant_lib().kmeans_stats_variant_smem_bytes(
        int(x.dtype == torch.bfloat16), plan.kp, d, plan.ds, plan.slices,
        int(plan.resident), plan.prefetch)
    if got != plan.smem:
        raise AssertionError(f"P1 plan for ({n}, {d}) k={k} {x.dtype}: "
                             f"shared memory {plan.smem} B, the kernel's "
                             f"source says {got} B")
    return plan


def check_variant(torch, kk, ke, name, mode, cent, x, valid, block=2048):
    """P1's stage ``mode`` against its plain version: the same bits from
    two launches, counts exact where they count rows, everything within
    the sum bar.  Returns (result, max |kernel - plain|, plan)."""
    plan = variant_plan(torch, kk, x, cent.shape[0])
    got = kk.kmeans_stats_variant(cent, x, valid, mode, block)
    again = kk.kmeans_stats_variant(cent, x, valid, mode, block)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {mode}: two launches gave different "
                             "bits")
    want = kk._variant_plain(kk._normalized(cent, x.dtype), x, valid, mode,
                             block)
    if mode in ke._ROW_COUNTS:
        err = compare(torch, f"{name} {mode}", got, want)
    else:
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {mode}: non-finite output")
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL,
                                   msg=lambda m: f"{name} {mode}: {m}")
        err = float((got - want).abs().max())
    return got, err, plan


def variant_kernel_checks(torch, kk, ke):
    """Phase 15's kernel checks: every P1 stage against its plain version
    on clustered rows at the study's shape, on shapes that reach the
    masks and the column slices (3,001 x 250 at k=10, d=2048, a strided
    view into rows of 257), each in float32 and bfloat16, and the
    ``maxcmp`` tie (a copy of centroid 2 as centroid 5) counted in both
    clusters."""
    log("    P1 kernel vs plain (same bits twice, counts exact where they "
        "count rows, sums within the bar)")
    plans = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = [("clustered n=2^19 d=256 k=64",
                  clustered_dense(torch, 1 << 19, 256, K, dtype, 40)),
                 ("ragged n=3001 d=250 k=10",
                  clustered_dense(torch, 3001, 250, 10, dtype, 41)),
                 ("wide n=2^16 d=2048 k=64",
                  clustered_dense(torch, 1 << 16, 2048, K, dtype, 42))]
        cent, x, valid = clustered_dense(torch, 1 << 16, 257, K, dtype, 43)
        cases.append(("strided view n=2^16 d=256 (rows of 257) k=64",
                      (cent[:, :256], x[:, :256], valid)))
        for name, (cent, x, valid) in cases:
            errs = []
            for mode in kk.VARIANTS:
                _got, err, plan = check_variant(torch, kk, ke,
                                                f"{name} {dtype}", mode,
                                                cent, x, valid)
                errs.append(err)
            plans.append(plan)
            log(f"    {name} {dtype}: all {len(kk.VARIANTS)} stages ok, max "
                f"|kernel - plain| {max(errs):.3g}; plan kp={plan.kp}, "
                f"{plan.slices} slice(s) of {plan.ds}, centroids "
                f"{'resident' if plan.resident else 'streamed'}, prefetch "
                f"{plan.prefetch}, grid {plan.grid}, {plan.smem} B shared")
        cent, x, valid = clustered_dense(torch, 1 << 16, 256, K, dtype, 44,
                                         tie=(2, 5))
        got, _err, _plan = check_variant(torch, kk, ke,
                                         f"tie 2 = 5 {dtype}", "maxcmp",
                                         cent, x, valid)
        tied = float(got[2, -1])
        if not (tied > 0 and float(got[5, -1]) == tied
                and float(got[:, -1].sum()) == float(valid.sum()) + tied):
            raise AssertionError(f"maxcmp tie {dtype}: counts {tied} on 2, "
                                 f"{float(got[5, -1])} on 5")
        log(f"    maxcmp tie {dtype}: {tied:.0f} tied rows counted on both "
            "2 and 5")
        del cent, x, valid, cases
    for what, seen in (("several column slices",
                        any(p.slices > 1 for p in plans)),
                       ("resident centroids", any(p.resident for p in plans)),
                       ("streamed centroids",
                        any(not p.resident for p in plans))):
        if not seen:
            raise AssertionError(f"phase 15 never ran {what}")


def simonly_t_float64(torch, kk):
    """``simonlyT`` in float32 on the random rows of phase 15's timing
    (seed 24): its sums are x's column sums over 2^19 rows, where the
    plain version's float32 product misses the sum bar against the
    kernel (ROADMAP C).  The kernel must meet the bar against a float64
    sum; the plain version's distance from it is printed."""
    g = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(1 << 19, 256, generator=g, device="cuda")
    c = torch.randn(K, 256, generator=g, device="cuda")
    v = torch.ones(1 << 19, device="cuda")
    got = kk.kmeans_stats_variant(c, x, v, "simonlyT")[:, :-1]
    plain = kk._variant_plain(kk._normalized(c, torch.float32), x, v,
                              "simonlyT", 2048)[:, :-1]
    exact = x.double().sum(0).expand(K, -1)
    torch.testing.assert_close(got.double(), exact, rtol=SUM_RTOL,
                               atol=SUM_ATOL,
                               msg=lambda m: f"simonlyT f32 vs float64: {m}")
    err, plain_err = (float((t.double() - exact).abs().max())
                      for t in (got, plain))
    log(f"    simonlyT float32 column sums (2^19 random rows) against "
        f"float64: kernel {err:.3g} (within the bar), plain {plain_err:.3g}")
    return err, plain_err


def one_pass_vs_two_pass(torch, kk):
    """P1 ``argmax`` (one read of x) beside B1 (classify, then fold: two
    reads) on the same clustered 2^19 x 256 x 64 inputs, bfloat16 and
    float32, interleaved B1, P1, P1, B1 three times; medians of the
    per-turn medians."""
    out = {}
    n, d = 1 << 19, 256
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        cent, x, valid = clustered_dense(torch, n, d, K, dtype, 45)
        one = kk.kmeans_stats_variant(cent, x, valid, "argmax")
        two = kk.kmeans_stats_fused(cent, x, valid)
        err = compare(torch, f"P1 argmax vs B1 {name}", one, two)
        fns = {"one": lambda: kk.kmeans_stats_variant(cent, x, valid,
                                                      "argmax"),
               "two": lambda: kk.kmeans_stats_fused(cent, x, valid)}
        ts = {"one": [], "two": []}
        b2b = {"one": [], "two": []}
        for who in ("two", "one", "one", "two") * 3:
            ts[who].append(time_ms(torch, fns[who]))
            b2b[who].append(back_to_back_ms(torch, fns[who], 20))
        read = x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        out[name] = dict(
            one_pass_ms=statistics.median(ts["one"]),
            two_pass_ms=statistics.median(ts["two"]),
            one_pass_back_to_back_ms=statistics.median(b2b["one"]),
            two_pass_back_to_back_ms=statistics.median(b2b["two"]),
            max_abs_diff=err)
        log(f"    one pass (P1 argmax) {out[name]['one_pass_ms']:.4f} ms "
            f"({out[name]['one_pass_back_to_back_ms']:.4f} back to back) vs "
            f"two passes (B1) {out[name]['two_pass_ms']:.4f} ms "
            f"({out[name]['two_pass_back_to_back_ms']:.4f}) at ({n}, {d}) "
            f"{name} k={K}; one read of x {read:.4f} ms; counts equal, sums "
            f"within {err:.3g}")
        del cent, x, valid
    return out


def variant_study(torch, kk):
    """Phase 15: the kernel_experiments tool, then P1's kernel checks, P1
    ``argmax`` beside B1, and each classify stage's kernel timed alone;
    returns the JSON entries."""
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.tools import kernel_experiments as ke

    log("[15] python -m rabit_tpu_torch.tools.kernel_experiments")
    for key in kk.LAUNCHES:
        kk.LAUNCHES[key] = 0
    study = ke.main([])
    launches = dict(kk.LAUNCHES)
    for mode in kk.VARIANTS:
        if launches[f"p1_{mode}"] == 0:
            raise AssertionError(f"P1 {mode}: no launch in the study")
    log(f"    launches {launches}")
    variant_kernel_checks(torch, kk, ke)
    simonly_t_float64(torch, kk)
    passes = one_pass_vs_two_pass(torch, kk)
    sass = {}
    for lib in ("kmeans_stats_variant", "kmeans_stats_dense"):
        counts, how = sass_counts(_build.library_path(lib))
        sass[lib] = counts if counts is not None else how
        log(f"    {lib} SASS ({how} -sass on the built library): " + (
            ", ".join(f"{op} {c}" for op, c in counts.items())
            if counts is not None else "not inspected"))
    n, d, block = ke.N, ke.D, 2048
    g = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(n, d, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.randn(K, d, generator=g, device="cuda")
    v = torch.ones(n, device="cuda")
    cn = kk._normalized(c, torch.bfloat16)
    lines = []
    for mode in kk.VARIANTS:
        err = ke.check_variant(mode, block, torch.bfloat16, c, x, v)
        ms = time_ms(torch, lambda: kk.kmeans_stats_variant(c, x, v, mode,
                                                            block))
        b2b = back_to_back_ms(torch, lambda: kk.kmeans_stats_variant(
            c, x, v, mode, block), 20)
        plain_ms = time_ms(torch, lambda: kk._variant_plain(cn, x, v, mode,
                                                            block), 1, 3)
        nbytes = n * d * 2 + n * 4 + K * d * 2 + K * (d + 1) * 4
        ops = 2 * n * K * d + (2 * n * K * d if mode in
                               ("maxcmp", "simonly", "simonlyT") else n * d)
        by_bytes = nbytes / HBM_BYTES_PER_S
        by_ops = ops / PEAK_OPS["bfloat16"]
        line = dict(
            name=f"p1_{mode}", route="cuda",
            source="rabit_tpu_torch/ops/csrc/kmeans_stats_variant.cu",
            replaces=("tools/kernel_experiments.py:138"
                      if mode.endswith("T") else
                      "tools/kernel_experiments.py:157"),
            launches=launches[f"p1_{mode}"], max_abs_err=err, ms=ms,
            kernel_ms=ms, back_to_back_ms=b2b, plain_ms=plain_ms,
            bound_ms=max(by_bytes, by_ops) * 1e3,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None, library="none: no single PyTorch call",
            shape=f"x ({n}, {d}) bfloat16, k={K}, block={block}",
            study_ms_per_iter={s: r["ms"] for s, r in study.items()
                               if r["mode"] == mode})
        if mode == "argmax":
            line["one_pass_vs_two_pass"] = passes
            line["sass"] = sass
        log(f"    p1_{mode}: kernel {ms:.4f} ms ({b2b:.4f} back to back), "
            f"plain {plain_ms:.3f} ms, "
            f"bound {line['bound_ms']:.4f} ms by {line['bound_by']}, max "
            f"|kernel - plain| {err:.3g}")
        lines.append(line)
    return lines


# -------------------------------------------------------------- the wire
WIRE_RANKS = 4                    # ranks of phase 16's wired rounds
WIRE_TIMEOUT = 120.0              # seconds any rank thread or run() may take


def _thread(target, errors, name, *args):
    """A daemon thread whose exception lands in ``errors``."""
    import threading

    def body():
        try:
            target(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised by the phase
            errors.append(e)
    t = threading.Thread(target=body, name=name, daemon=True)
    t.start()
    return t


def _join_all(threads, what):
    deadline = time.monotonic() + WIRE_TIMEOUT
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
        if t.is_alive():
            raise AssertionError(f"{what}: {t.name} did not end within "
                                 f"{WIRE_TIMEOUT:g} s")


def wire_rank(i, tracker_port, world, integrity, payload, barrier, out):
    """One rank of a phase-16 round: register through the port's protocol,
    wire its links through the port's LinkFactory, pass ``payload(rank)``
    to ring_next while receiving ring_prev's, then say goodbye.  With
    ``payload`` None it only registers (a rendezvous-only round)."""
    import socket

    from rabit_tpu_torch.tracker import protocol as P
    from rabit_tpu_torch.transport import LinkFactory, TransportConfig

    task = f"rank-{i}"
    links = {}
    lst = socket.socket()
    try:
        lst.bind(("127.0.0.1", 0))
        lst.listen(world)
        lst.settimeout(WIRE_TIMEOUT)
        with socket.create_connection(("127.0.0.1", tracker_port),
                                      timeout=WIRE_TIMEOUT) as s:
            P.send_hello(s, P.CMD_START, task, world)
            P.send_str(s, "127.0.0.1")
            P.send_u32(s, lst.getsockname()[1])
            reply = P.TopologyReply.recv_or_reject(s)
        rec = out[task] = dict(reply=reply, t_reply=time.perf_counter())
        if not isinstance(reply, P.TopologyReply):
            raise AssertionError(f"{task}: registration rejected: {reply}")
        if payload is not None:
            factory = LinkFactory(TransportConfig(integrity=integrity),
                                  reply.rank, timeout=WIRE_TIMEOUT)
            for peer, host, port in reply.connect:
                links[peer] = factory.dial(socket.create_connection(
                    (host, port), timeout=WIRE_TIMEOUT), peer)
            for _ in range(reply.naccept):
                link, peer = factory.accept(lst.accept()[0])
                links[peer] = link
            rec["t_wired"] = time.perf_counter()
            rec["frames"] = {p: link._frames for p, link in links.items()}
            mine = payload(reply.rank)
            barrier.wait()
            rec["t_ring"] = time.perf_counter()
            errors = []
            send = _thread(links[reply.ring_next].sendall, errors,
                           f"{task}-send", mine)
            got = bytes(links[reply.ring_prev].recv_exact(len(mine)))
            send.join(WIRE_TIMEOUT)
            if send.is_alive() or errors:
                raise AssertionError(f"{task}: send to ring_next failed: "
                                     f"{errors or 'timed out'}")
            rec.update(t_done=time.perf_counter(), sent=mine, got=got)
        with socket.create_connection(("127.0.0.1", tracker_port),
                                      timeout=WIRE_TIMEOUT) as s:
            P.send_hello(s, P.CMD_SHUTDOWN, task, world)
    except BaseException:
        if barrier is not None:
            barrier.abort()         # the other ranks fail fast
        raise
    finally:
        for link in links.values():
            link.close()
        lst.close()


def wire_round(world, integrity=None, payload=None):
    """One round of phase 16 under a fresh port Tracker on 127.0.0.1:0;
    checks every reply against the handout functions and that the ranks
    and the tracker's run() end; returns the per-rank records and the
    round's times in seconds."""
    import threading

    from rabit_tpu_torch.sched import topo
    from rabit_tpu_torch.tracker.tracker import (Tracker, ring_neighbors,
                                                 tree_neighbors)

    tr = Tracker(world, host="127.0.0.1", port=0)
    tr.start()
    out, errors = {}, []
    barrier = threading.Barrier(world, timeout=WIRE_TIMEOUT) \
        if payload is not None else None
    try:
        t0 = time.perf_counter()
        threads = [_thread(wire_rank, errors, f"rank-{i}", i, tr.port, world,
                           integrity, payload, barrier, out)
                   for i in range(world)]
        _join_all(threads, f"world {world} round")
        if errors:
            raise errors[0]
        tr.join(WIRE_TIMEOUT)
        if tr._thread.is_alive():
            raise AssertionError(f"world {world}: the tracker's run() did "
                                 "not return after every shutdown")
    finally:
        tr.stop()
    ranks = sorted(o["reply"].rank for o in out.values())
    if ranks != list(range(world)):
        raise AssertionError(f"world {world}: ranks {ranks} are not a "
                             "permutation")
    for task, o in out.items():
        r = o["reply"]
        parent, nb = tree_neighbors(r.rank, world)
        rp, rn = ring_neighbors(r.rank, world)
        peers = set(nb) | topo.extra_link_peers(r.rank, world, r.groups)
        peers = (peers | ({rp, rn} if world > 1 else set())) - {r.rank}
        o["peers"] = peers
        want = (world, parent, nb, rp, rn,
                sorted(p for p in peers if p < r.rank),
                sum(1 for p in peers if p > r.rank), 0, "", [], 0)
        got = (r.world, r.parent, r.neighbors, r.ring_prev, r.ring_next,
               [c[0] for c in r.connect], r.naccept, r.epoch, r.sched,
               r.demoted, r.relaunched)
        if got != want:
            raise AssertionError(f"world {world} {task}: reply {got}, the "
                                 f"handout functions give {want}")
    times = {"round_s": max(o["t_reply"] for o in out.values()) - t0}
    if payload is not None:
        by_rank = {o["reply"].rank: o for o in out.values()}
        for rank, o in by_rank.items():
            r = o["reply"]
            if o["got"] != by_rank[r.ring_prev]["sent"]:
                raise AssertionError(f"{integrity}: rank {rank} received "
                                     "other bytes than ring_prev computed")
            if (set(o["frames"]) != o["peers"]
                    or set(o["frames"].values()) != {integrity != "off"}):
                raise AssertionError(f"{integrity}: rank {rank} wired "
                                     f"{o['frames']} for reply {r}")
        times["wiring_s"] = (max(o["t_wired"] for o in out.values())
                             - min(o["t_reply"] for o in out.values()))
        times["ring_s"] = (max(o["t_done"] for o in out.values())
                           - min(o["t_ring"] for o in out.values()))
    return out, times


def wire_phase(torch, kk, x, valid, cent):
    """Phase 16: the port's tracker and TCP links on the card machine.
    Four rank threads register with the port's Tracker, wire their links
    (default config, then rabit_wire_integrity=crc32c), each computes
    B1's stats for its quarter of phase 13's dense16 shard on the card
    and passes them once around the ring; then rendezvous-only rounds at
    worlds 4 and 16.  Returns the times in seconds."""
    import threading

    # the rank threads' imports, loaded before any clock starts
    import rabit_tpu_torch.transport  # noqa: F401
    from rabit_tpu_torch.parallel.mesh import local_data_slice

    n = x.shape[0]
    k, d = cent.shape
    lock = threading.Lock()         # one card, one binding: launch in turn

    def stats_bytes(rank):
        s = local_data_slice(rank, WIRE_RANKS, n)
        with lock:
            st = kk.kmeans_stats_fused(cent, x[s], valid[s])
            return st.cpu().numpy().tobytes()

    log(f"[16] the wire: port Tracker({WIRE_RANKS}) on 127.0.0.1, "
        f"{WIRE_RANKS} rank threads, B1 stats ({k}, {d + 1}) float32 of a "
        f"quarter of {n} dense16 rows each, passed once around the ring")
    times = {}
    total = float(valid.sum())
    for integrity in ("off", "crc32c"):
        out, t = wire_round(WIRE_RANKS, integrity, stats_bytes)
        counts = sum(np.frombuffer(o["got"], np.float32).reshape(k, d + 1)[
            :, d].sum(dtype=np.float64) for o in out.values())
        if counts != total:
            raise AssertionError(f"{integrity}: the ring carried {counts} "
                                 f"counts, the shard has {total} valid rows")
        nbytes = len(next(iter(out.values()))["sent"])
        log(f"    integrity {integrity}: round {t['round_s'] * 1e3:.3f} ms, "
            f"wiring {t['wiring_s'] * 1e3:.3f} ms, ring pass of {nbytes} B "
            f"{t['ring_s'] * 1e3:.3f} ms; every rank got ring_prev's bytes, "
            f"counts sum to the {int(total)} valid rows")
        times[integrity] = t
    for world in (WIRE_RANKS, 16):
        rounds = [wire_round(world)[1]["round_s"] for _ in range(5)]
        log(f"    rendezvous only, world {world}: rounds "
            + ", ".join(f"{r * 1e3:.3f}" for r in rounds)
            + f" ms (median {statistics.median(rounds) * 1e3:.3f})")
        times[f"rendezvous_{world}"] = rounds
    return times


# ------------------------------------------------------------- world 3
W3_RANKS = 3                      # rank processes of phase 17
W3_TIMEOUT = 400.0                # seconds each rank process may take
W3_KM_ITERS = 3                   # k-means iterations at world 3
W3_GB_ROUNDS = 2                  # boosting rounds at world 3
W3_RUNS = ("kmeans", "f32 kernel", "plain", "bf16 kernel")
W3_GB_KW = {"f32 kernel": dict(compute_dtype="float32"),
            "plain": dict(use_kernel=False), "bf16 kernel": {}}
P18_NODES = 32                    # nodes of phase 18's tree level
P18_GROUPS = "0,0,1"              # RABIT_TRACKER_GROUPS of its hier run
P18_BUCKET = 1 << 20              # the engine's default rabit_bucket_bytes


def world3_picks(n, k, world):
    """The global rows ``init_centroids`` seeds each centroid from when n
    rows are split into ``world`` contiguous shards: each rank draws k
    rows of its own shard and then k roots from one generator of seed 0,
    and centroid i is root i's row i.  The roots must agree across the
    shards' sizes (they differ by a row), or the ranks' broadcasts would
    not meet."""
    from rabit_tpu_torch.parallel.mesh import local_data_slice

    rows, roots = [], []
    for r in range(world):
        size = local_data_slice(r, world, n).stop - local_data_slice(
            r, world, n).start
        draw = np.random.default_rng(0)
        rows.append([int(draw.integers(size)) for _ in range(k)])
        roots.append([int(draw.integers(world)) for _ in range(k)])
    if any(rt != roots[0] for rt in roots):
        raise AssertionError("init_centroids' roots differ between shards")
    return [local_data_slice(roots[0][i], world, n).start
            + rows[roots[0][i]][i] for i in range(k)]


def _shard_rows(data, s):
    """Rows ``s`` of a SparseMat of rows with equal slot counts."""
    from rabit_tpu_torch.learn.data import SparseMat

    nnz = int(data.indptr[1] - data.indptr[0])
    return SparseMat(indptr=np.arange(s.stop - s.start + 1,
                                      dtype=np.int64) * nnz,
                     findex=data.findex[s.start * nnz:s.stop * nnz],
                     fvalue=data.fvalue[s.start * nnz:s.stop * nnz],
                     labels=data.labels[s], feat_dim=data.feat_dim)


class _Clock:
    """Host seconds by part of one rank's run, and each wire op."""

    def __init__(self):
        self.parts = dict(staging=0.0, kernel=0.0, wire=0.0)
        self.ops = []      # (bytes, wire seconds, schedule, fill seconds)

    def timed(self, part, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.parts[part] += time.perf_counter() - t0
        return call

    def wire(self, eng):
        """Time the live engine's allreduce and broadcast; the lazy fill
        of an allreduce is counted as kernel time, not wire."""
        real_ar, real_bc = eng.allreduce, eng.broadcast

        def allreduce(buf, op, prepare_fun=None):
            fill = [0.0]

            def prep():
                t = time.perf_counter()
                prepare_fun()
                fill[0] = time.perf_counter() - t
            t0 = time.perf_counter()
            out = real_ar(buf, op, prep if prepare_fun else None)
            dt = time.perf_counter() - t0 - fill[0]
            self.parts["kernel"] += fill[0]
            self.parts["wire"] += dt
            self.ops.append((int(buf.nbytes), dt, eng._op_sched, fill[0]))
            return out
        eng.allreduce = allreduce
        eng.broadcast = self.timed("wire", real_bc)

    def split(self, wall):
        return dict(self.parts, wall=wall,
                    rest=wall - sum(self.parts.values()))


def _device_timed(torch, fn, events):
    """``fn`` with CUDA events recorded around each call into
    ``events``."""
    def call(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = fn(*a, **k)
        ev[1].record()
        events.append(ev)
        return res
    return call


def world3_rank(task, ports):
    """One rank process of phase 17 (``chip_smoke.py --world3-rank TASK
    PORT...``): k-means on its third of phase 5's dense16 rows under the
    first tracker, then boosting.train on its third of phase 10's rows
    under one tracker each for the float32 kernel, the plain path and the
    bfloat16 kernel, all through the port's PySocketEngine.  Prints one
    JSON line: results, kernel launches and the time split."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the world-3 ranks run on the card")
    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch import engine as engine_mod
    from rabit_tpu_torch.learn import boosting as gb
    from rabit_tpu_torch.learn import histogram as bh
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.ops import histogram_kernel as hk
    from rabit_tpu_torch.ops import kmeans_kernel as kk
    from rabit_tpu_torch.parallel.mesh import local_data_slice

    torch.backends.cuda.matmul.allow_tf32 = False

    def init(port):
        rabit_tpu_torch.init(rabit_engine="pysocket",
                             rabit_tracker_uri="127.0.0.1",
                             rabit_tracker_port=port, rabit_task_id=task,
                             rabit_world_size=W3_RANKS,
                             rabit_timeout_sec=W3_TIMEOUT)
        clock = _Clock()
        clock.wire(engine_mod.get_engine())
        return clock, rabit_tpu_torch.get_rank()

    def reset():
        for counts in (kk.LAUNCHES, hk.LAUNCHES):
            for key in counts:
                counts[key] = 0

    out = {}
    # (a) k-means, dense16 tier
    clock, rank = init(ports[0])
    data = sparse_clusters(MAIN_ROWS, 256, 32, K, seed=7,
                           picks=world3_picks(MAIN_ROWS, K, W3_RANKS))
    shard = _shard_rows(data, local_data_slice(rank, W3_RANKS, MAIN_ROWS))
    del data
    shard.to_ell = clock.timed("staging", shard.to_ell)
    real = dict(prepare_shard=km.prepare_shard, b1=km.kmeans_stats_fused)
    tiers, b1_events = [], []
    km.kmeans_stats_fused = _device_timed(torch, real["b1"], b1_events)

    def dense16(*a, **k):
        # A third of the rows (1.4M x 257 x 4 B) fits the float32 dense
        # tier's 2 GiB budget, where run() would stage it for plain
        # products; budget 0 takes the next tier, dense16 (B1), as the
        # CPU tests force tiers.
        staged = real["prepare_shard"](*a, budget=0, **k)
        tiers.append(staged[0])
        return staged
    km.prepare_shard = clock.timed("staging", dense16)
    counts = []
    eng = engine_mod.get_engine()
    real_ar = eng.allreduce

    def stats_allreduce(buf, op, prepare_fun=None):
        res = real_ar(buf, op, prepare_fun)
        if res.ndim == 2:
            counts.append(res[:, -1].tolist())
        return res
    eng.allreduce = stats_allreduce
    reset()
    t0 = time.perf_counter()
    model = km.run(shard, K, W3_KM_ITERS, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    km.prepare_shard = real["prepare_shard"]
    km.kmeans_stats_fused = real["b1"]
    out["kmeans"] = dict(rank=rank, centroids=model.centroids.tolist(),
                         counts=counts, launches=dict(kk.LAUNCHES),
                         tiers=tiers, b1_ms=[a.elapsed_time(b)
                                             for a, b in b1_events],
                         split=clock.split(wall), ops=clock.ops)
    rabit_tpu_torch.finalize()
    del shard
    # (b) GBDT, three ways
    x_all, y_all = gbdt_data(GBDT_ROWS, GBDT_FEATURES, seed=11)
    chunk = hk.max_channels(GBDT_NBIN + 1, GBDT_FEATURES) // 2
    real.update(hist=hk.hist_fused_multi, cuts=bh.quantile_cuts,
                apply=gb.apply_cuts)
    for label, port in zip(W3_RUNS[1:], ports[1:]):
        clock, rank = init(port)
        # each tracker hands out its own ranks: the shard follows this one
        s = local_data_slice(rank, W3_RANKS, GBDT_ROWS)
        x, y = np.ascontiguousarray(x_all[s]), np.ascontiguousarray(y_all[s])
        events, bins = [], []

        def keep_bins(*a, **k):
            bins.append(real["apply"](*a, **k))
            return bins[-1]
        hk.hist_fused_multi = _device_timed(torch, real["hist"], events)
        bh.quantile_cuts = clock.timed("staging", real["cuts"])
        gb.apply_cuts = clock.timed("staging", keep_bins)
        reset()
        t0 = time.perf_counter()
        try:
            model = gb.train(x, y, num_round=W3_GB_ROUNDS,
                             max_depth=GBDT_DEPTH, nbin=GBDT_NBIN,
                             **W3_GB_KW[label])
            torch.cuda.synchronize()
        finally:
            hk.hist_fused_multi = real["hist"]
            bh.quantile_cuts = real["cuts"]
            gb.apply_cuts = real["apply"]
        wall = time.perf_counter() - t0
        clock.parts["kernel"] = sum(a.elapsed_time(b)
                                    for a, b in events) / 1e3
        losses, acc, _pred = round_losses(model, bins[0], y)
        out[label] = dict(
            rank=rank, rows=len(y), loss_sums=[v * len(y) for v in losses],
            hits=acc * len(y), top=top_levels(model.trees[0], 3),
            trees=[[dataclasses.astuple(n) for n in t] for t in model.trees],
            leaves_finite=bool(np.isfinite(
                [n.value for t in model.trees for n in t]).all()),
            launches=dict(hk.LAUNCHES), other=dict(kk.LAUNCHES),
            level_chunks=sum(level_chunks(t, GBDT_DEPTH, chunk)
                             for t in model.trees),
            split=clock.split(wall), ops=clock.ops)
        rabit_tpu_torch.finalize()
    print(json.dumps(out), flush=True)
    return 0


def _read_back(f):
    f.seek(0)
    return f.read()


def _ms(seconds):
    return f"{seconds * 1e3:.3f}"


def _run_rank_processes(flag, ntrackers, phase, meanwhile=None):
    """Start the port's ``Tracker(3)`` ``ntrackers`` times on
    127.0.0.1:0 and three processes of this script with ``flag TASK
    PORT...`` (no ``RABIT_`` variable in their environment), run
    ``meanwhile()`` here, and wait: a rank that fails fails the phase at
    once (the others would wait on it until their link or tracker
    timeouts).  Returns each rank's last JSON line, once every tracker's
    ``run()`` has returned after the ranks' shutdowns."""
    from rabit_tpu_torch.tracker.tracker import Tracker

    t0 = time.perf_counter()
    trackers = [Tracker(W3_RANKS, host="127.0.0.1", port=0)
                for _ in range(ntrackers)]
    procs = []
    # the ranks' output goes to files: a rank blocked on a full pipe in
    # mid-collective would stall the ranks waiting on it
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(W3_RANKS)]
    try:
        for t in trackers:
            t.start()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("RABIT_")}
        env["PYTHONPATH"] = ROOT
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(i)]
            + [str(t.port) for t in trackers], cwd=ROOT, env=env,
            stdout=logs[i][0], stderr=logs[i][1]) for i in range(W3_RANKS)]
        if meanwhile is not None:
            meanwhile()
        while any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise AssertionError(
                        f"phase-{phase} rank process {i} failed "
                        f"({p.returncode}):\n"
                        f"{_read_back(logs[i][1])[-4000:]}")
            if time.perf_counter() - t0 > W3_TIMEOUT:
                raise AssertionError(f"the phase-{phase} rank processes "
                                     f"did not end within {W3_TIMEOUT:g} s")
            time.sleep(0.2)
        results = []
        for i, p in enumerate(procs):
            stdout, stderr = map(_read_back, logs[i])
            if p.returncode != 0:
                raise AssertionError(f"phase-{phase} rank process {i} "
                                     f"failed ({p.returncode}):\n"
                                     f"{stderr[-4000:]}")
            results.append(json.loads(stdout.strip().splitlines()[-1]))
        for t in trackers:
            t.join(30)
            if t._thread.is_alive():
                raise AssertionError(f"a phase-{phase} tracker's run() did "
                                     f"not return after every shutdown")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in trackers:
            t.stop()
        for f in (f for pair in logs for f in pair):
            f.close()
    return results


def world3_phase(torch, km, kk):
    """Phase 17: k-means and GBDT at world 3 over the port's
    PySocketEngine, three rank processes sharing the card (see
    ``world3_rank``), against a world-1 oracle for k-means and against
    the plain path for GBDT.  Returns each kernel's launches by rank,
    the oracle's counts and the stats allreduce times."""
    log(f"[17] world {W3_RANKS} over the port's PySocketEngine: {W3_RANKS} "
        f"rank processes on one card; k-means dense16 {MAIN_ROWS} x 256 "
        f"k={K}, {W3_KM_ITERS} iterations; boosting.train {GBDT_ROWS} x "
        f"{GBDT_FEATURES}, {GBDT_NBIN} bins, depth {GBDT_DEPTH}, "
        f"{W3_GB_ROUNDS} rounds, three ways")
    t0 = time.perf_counter()
    oracle = {}

    def run_oracle():
        # world 1 on the whole data, the plain device loop from the
        # centroids init_centroids seeds at world 3 (the same rows,
        # learn/kmeans.py init_centroids), with no wire
        picks = world3_picks(MAIN_ROWS, K, W3_RANKS)
        data = sparse_clusters(MAIN_ROWS, 256, 32, K, seed=7, picks=picks)
        init = np.zeros((K, 256), np.float32)
        for i, row in enumerate(picks):
            fi, fv = data.row(row)
            np.add.at(init, (i, fi), fv)
        model = km.KMeansModel(init)
        model.normalize()
        idx, val, _lab, valid = data.to_ell(pad_index=256, row_block=1024)
        del data
        shard = km.prepare_shard(idx, val, valid, 256, 1024, budget=0,
                                 compute_dtype="bfloat16")
        del idx, val, valid
        if shard[0] != "dense16":
            raise AssertionError(f"oracle: staged {shard[0]}, not dense16")
        x16, v16 = shard[2]
        want_counts = []
        for _ in range(W3_KM_ITERS):
            # B1's plain version on all the rows, then run()'s own host
            # update (learn/kmeans.py run)
            cn = kk._normalized(torch.from_numpy(model.centroids).cuda(),
                                torch.bfloat16)
            stats = kk._stats_plain(cn, x16, v16).cpu().numpy()
            counts = stats[:, -1:]
            want_counts.append(counts[:, 0])
            model.centroids = (stats[:, :-1] / counts).astype(np.float32)
            model.normalize()
        del shard, x16, v16
        torch.cuda.empty_cache()
        oracle.update(counts=want_counts, cent=model.centroids,
                      seconds=time.perf_counter() - t0)

    results = _run_rank_processes("--world3-rank", len(W3_RUNS), "17",
                                  run_oracle)
    want_counts, want_cent = oracle["counts"], oracle["cent"]
    t_oracle = oracle["seconds"]
    wall = time.perf_counter() - t0
    by_rank = {r["kmeans"]["rank"]: r for r in results}
    if sorted(by_rank) != list(range(W3_RANKS)):
        raise AssertionError(f"world-3 ranks {sorted(by_rank)}")
    # (a) k-means against the oracle
    km3 = [by_rank[r]["kmeans"] for r in range(W3_RANKS)]
    cents = [np.asarray(k["centroids"], np.float32) for k in km3]
    if any(not np.array_equal(c, cents[0]) for c in cents):
        raise AssertionError("k-means: the ranks' final centroids differ")
    for k in km3:
        if k["tiers"] != ["dense16"]:
            raise AssertionError(f"k-means rank {k['rank']}: staged "
                                 f"{k['tiers']}, not the dense16 tier")
        got = np.asarray(k["counts"])
        if got.shape != (W3_KM_ITERS, K) or not np.array_equal(
                got, np.asarray(want_counts)):
            raise AssertionError(f"k-means rank {k['rank']}: counts by "
                                 f"iteration {got.tolist()} vs the oracle's "
                                 f"{np.asarray(want_counts).tolist()}")
        if k["launches"]["kmeans_stats_dense"] < W3_KM_ITERS or \
                k["launches"]["kmeans_stats_ell"]:
            raise AssertionError(f"k-means rank {k['rank']}: launches "
                                 f"{k['launches']}")
    err = float(np.abs(cents[0] - want_cent).max())
    if not (np.isfinite(cents[0]).all() and cents[0].shape == (K, 256)
            and np.allclose(cents[0], want_cent, rtol=SUM_RTOL,
                            atol=SUM_ATOL)):
        raise AssertionError(f"k-means world 3: centroids off the world-1 "
                             f"oracle by {err}")
    stats_bytes = K * 257 * 4
    scheds = {op[2] for k in km3 for op in k["ops"] if op[0] == stats_bytes}
    stat_ms = [statistics.median(op[1] for op in k["ops"]
                                 if op[0] == stats_bytes) for k in km3]
    fill_ms = [statistics.median(op[3] for op in k["ops"]
                                 if op[0] == stats_bytes) for k in km3]
    b1_ms = [statistics.median(k["b1_ms"]) for k in km3]
    log(f"    k-means: counts of all {W3_KM_ITERS} iterations equal the "
        f"oracle's, centroids bit-identical on the {W3_RANKS} ranks and "
        f"within {err:.3g} of the world-1 plain loop; B1 launches by rank "
        f"{[k['launches']['kmeans_stats_dense'] for k in km3]}; the "
        f"({K}, 257) float32 stats ({stats_bytes} B) rode {sorted(scheds)}; "
        f"medians by rank over the iterations: allreduce "
        f"{[_ms(t) for t in stat_ms]} ms, its lazy fill (B1 and the "
        f"stats' copy to the host) {[_ms(t) for t in fill_ms]} ms, B1 "
        f"alone (CUDA events) {[_ms(t / 1e3) for t in b1_ms]} ms")
    for k in km3:
        sp = k["split"]
        log(f"    k-means rank {k['rank']}: wall {sp['wall']:.3f} s = "
            f"staging {sp['staging']:.3f} + kernel (B1 and the stats' "
            f"copy to the host) {sp['kernel']:.3f} + wire {sp['wire']:.3f} "
            f"+ rest {sp['rest']:.3f} s")
    # (b) GBDT: the float32 kernel against the plain path, then bf16
    gb3 = {label: [by_rank[r][label] for r in range(W3_RANKS)]
           for label in W3_RUNS[1:]}
    summary = {}
    for label, ranks in gb3.items():
        if any(g["trees"] != ranks[0]["trees"] for g in ranks):
            raise AssertionError(f"GBDT {label}: the ranks' trees differ")
        n = sum(g["rows"] for g in ranks)
        losses = [sum(g["loss_sums"][i] for g in ranks) / n
                  for i in range(W3_GB_ROUNDS)]
        acc = sum(g["hits"] for g in ranks) / n
        for g in ranks:
            want = 0 if label == "plain" else g["level_chunks"]
            got = g["launches"]["gbdt_hist"]
            if got != want or (label != "plain" and got == 0) or \
                    any(g["other"].values()):
                raise AssertionError(f"GBDT {label} rank {g['rank']}: "
                                     f"{got} histogram launches for {want} "
                                     f"level chunks, k-means {g['other']}")
        summary[label] = dict(losses=losses, acc=acc, top=ranks[0]["top"])
        hist_ops = [max(g["ops"]) for g in ranks]
        log(f"    {label}: log-loss by round {[round(v, 6) for v in losses]}"
            f", accuracy {acc:.4f}, B3 launches by rank "
            f"{[g['launches']['gbdt_hist'] for g in ranks]}; largest level "
            f"histogram {hist_ops[0][0]} B rode {hist_ops[0][2]}, "
            f"allreduce by rank {[_ms(o[1]) for o in hist_ops]} ms")
        for g in ranks:
            sp = g["split"]
            log(f"      rank {g['rank']}: wall {sp['wall']:.3f} s = binning "
                f"{sp['staging']:.3f} + kernel (B3, device time) "
                f"{sp['kernel']:.3f} + wire {sp['wire']:.3f} + rest "
                f"{sp['rest']:.3f} s")
    k32, plain, k16 = (summary[x] for x in W3_RUNS[1:])
    if [tuple(t) for t in k32["top"]] != [tuple(t) for t in plain["top"]]:
        raise AssertionError(f"GBDT world 3: first tree's top levels "
                             f"differ:\n{k32['top']}\n{plain['top']}")
    rel = max(abs(a - b) / b for a, b in zip(k32["losses"], plain["losses"]))
    if rel > 1e-4:
        raise AssertionError(f"GBDT world 3: float32 kernel log-loss off "
                             f"the plain path by {rel:.3g} relative")
    if not all(g["leaves_finite"] for g in gb3["bf16 kernel"]) or any(
            b >= a for a, b in zip(k16["losses"], k16["losses"][1:])) or \
            abs(k16["acc"] - k32["acc"]) > 0.005:
        raise AssertionError(f"GBDT world 3 bf16 kernel: losses "
                             f"{k16['losses']}, accuracy {k16['acc']} vs "
                             f"{k32['acc']}")
    log(f"    GBDT: f32 kernel vs plain top 3 levels identical, log-loss "
        f"within {rel:.3g} relative; bf16 finite, falling, accuracy "
        f"{k16['acc']:.4f} vs f32 {k32['acc']:.4f}")
    log(f"    phase 17 wall {wall:.1f} s (the oracle {t_oracle:.1f} s of it, "
        f"beside the ranks)")
    return dict(
        kmeans_stats_dense=[k["launches"]["kmeans_stats_dense"]
                            for k in km3],
        gbdt_hist={label: [g["launches"]["gbdt_hist"] for g in ranks]
                   for label, ranks in gb3.items() if label != "plain"},
        oracle_counts=np.asarray(want_counts).tolist(),
        ring_stats_ms=[[op[1] * 1e3 for op in k["ops"]
                        if op[0] == stats_bytes] for k in km3])


def phase18_rank(task, ports):
    """One rank process of phase 18 (``chip_smoke.py --phase18-rank TASK
    PORT PORT``): (a) the per-node GBDT histogram stream on its third of
    phase 10's rows under the first tracker; (b) k-means on its third of
    phase 5's dense16 rows under ``rabit_sched=hier`` and (c) the last
    iteration's stats through ``allreduce_custom``, under the second.
    Prints one JSON line: results, digests, counts and times."""
    import hashlib

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the phase-18 ranks run on the card")
    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch import SUM
    from rabit_tpu_torch import engine as engine_mod
    from rabit_tpu_torch.learn import histogram as bh
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.ops import histogram_kernel as hk
    from rabit_tpu_torch.ops import kmeans_kernel as kk
    from rabit_tpu_torch.parallel.mesh import local_data_slice

    torch.backends.cuda.matmul.allow_tf32 = False

    def init(port, **params):
        rabit_tpu_torch.init(rabit_engine="pysocket",
                             rabit_tracker_uri="127.0.0.1",
                             rabit_tracker_port=port, rabit_task_id=task,
                             rabit_world_size=W3_RANKS,
                             rabit_timeout_sec=W3_TIMEOUT, **params)
        return engine_mod.get_engine(), rabit_tpu_torch.get_rank()

    def reset():
        for counts in (kk.LAUNCHES, hk.LAUNCHES):
            for key in counts:
                counts[key] = 0

    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0

    out = {}
    # (a) one tree level's per-node histograms as a fused async stream
    eng, rank = init(ports[0])
    x_all, y_all = gbdt_data(GBDT_ROWS, GBDT_FEATURES, seed=11)
    s = local_data_slice(rank, W3_RANKS, GBDT_ROWS)
    x, y = np.ascontiguousarray(x_all[s]), y_all[s]
    del x_all, y_all
    # rank 0's quantiles of every 16th row of its shard are everyone's
    # cuts; the bins are taken on the card, NaN to the missing slot
    # (learn/histogram.py apply_cuts)
    cuts = rabit_tpu_torch.broadcast(
        bh.quantile_cuts(x[::16], GBDT_NBIN) if rank == 0 else None, 0)
    x_t = torch.from_numpy(x).cuda().T.contiguous()
    bins_t = torch.searchsorted(torch.from_numpy(cuts).cuda(), x_t,
                                right=True).to(torch.int32)
    bins_t[torch.isnan(x_t)] = GBDT_NBIN
    del x_t
    yd = torch.from_numpy(np.ascontiguousarray(y)).cuda()
    grad, hess = 0.5 - yd, torch.full_like(yd, 0.25)
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    node = torch.randint(0, P18_NODES, yd.shape, device="cuda",
                         generator=gen)
    weights = [((grad * (node == j)), (hess * (node == j)))
               for j in range(P18_NODES)]
    torch.cuda.synchronize()
    issued, buckets, solo_ops = [], [], [0]
    real_async = rabit_tpu_torch.allreduce_async
    real_exec = eng._fused_allreduce_exec
    real_blocking = eng._allreduce_blocking

    def recording(buf, op=SUM, prepare_fun=None, fuse=True, codec=True):
        issued.append(buf.copy())    # the local histogram, as issued
        return real_async(buf, op, prepare_fun, fuse=fuse, codec=codec)

    def counted(items, op):
        buckets.append(len(items))
        return real_exec(items, op)

    def solo(buf, op, prepare_fun=None):
        solo_ops[0] += 1
        return real_blocking(buf, op, prepare_fun)
    rabit_tpu_torch.allreduce_async = recording
    eng._fused_allreduce_exec, eng._allreduce_blocking = counted, solo
    reset()
    try:
        handles, t_issue = timed(lambda: [bh.build_allreduce_async(
            bins_t.T, g, h, GBDT_NBIN + 1, fuse=True, use_kernel=True)
            for g, h in weights])
        fused, t_wait = timed(lambda: [hd.wait() for hd in handles])
    finally:
        rabit_tpu_torch.allreduce_async = real_async
    launches = hk.LAUNCHES["gbdt_hist"]
    fused_buckets, fused_solo_ops = list(buckets), solo_ops[0]
    # the same local histograms, solo (fuse=False) and fused again
    # (allreduce_many), twice each in turn
    t_solo, t_many = [], []
    for _ in range(2):
        solo_ops[0] = 0
        hs, dt = timed(lambda: [rabit_tpu_torch.allreduce_async(
            a.copy(), SUM, fuse=False) for a in issued])
        got, dt2 = timed(lambda: [hd.wait() for hd in hs])
        t_solo.append(dt + dt2)
        solo_count = solo_ops[0]
        buckets.clear()
        many, dt = timed(lambda: rabit_tpu_torch.allreduce_many(
            [a.copy() for a in issued]))
        t_many.append(dt)
    eng._fused_allreduce_exec, eng._allreduce_blocking = real_exec, \
        real_blocking
    flat = [f.reshape(-1) for f in fused]
    out["stream"] = dict(
        rank=rank, launches=launches, buckets=fused_buckets,
        many_buckets=list(buckets),
        fused_solo_ops=fused_solo_ops, solo_ops=solo_count,
        shape=list(fused[0].shape), nbytes=int(fused[0].nbytes),
        same_solo=all(a.tobytes() == b.tobytes()
                      for a, b in zip(flat, got)),
        same_many=all(a.tobytes() == b.tobytes()
                      for a, b in zip(flat, many)),
        finite=bool(all(np.isfinite(f).all() for f in fused)),
        hess_sum=float(sum(f[..., 1].sum(dtype=np.float64)
                           for f in fused)),
        digest=digest(fused), t_issue=t_issue, t_wait=t_wait,
        t_solo=t_solo, t_many=t_many)
    rabit_tpu_torch.finalize()
    del bins_t, weights, grad, hess, node, yd
    torch.cuda.empty_cache()

    # (b) k-means, dense16 tier, under the hierarchical schedule
    eng, rank = init(ports[1], rabit_sched="hier")
    data = sparse_clusters(MAIN_ROWS, 256, 32, K, seed=7,
                           picks=world3_picks(MAIN_ROWS, K, W3_RANKS))
    shard = _shard_rows(data, local_data_slice(rank, W3_RANKS, MAIN_ROWS))
    del data
    orig_allreduce = eng.allreduce
    clock = _Clock()
    clock.wire(eng)
    timed_allreduce = eng.allreduce
    counts, local_stats, tiers = [], [], []

    def stats_allreduce(buf, op, prepare_fun=None):
        def prep():
            prepare_fun()
            if buf.ndim == 2:
                local_stats.append(buf.copy())
        if prepare_fun is None and buf.ndim == 2:
            local_stats.append(buf.copy())
        res = timed_allreduce(buf, op, prep if prepare_fun else None)
        if res.ndim == 2:
            counts.append(res[:, -1].tolist())
        return res
    eng.allreduce = stats_allreduce
    real_prepare = km.prepare_shard

    def dense16(*a, **k):
        staged = real_prepare(*a, budget=0, **k)
        tiers.append(staged[0])
        return staged
    km.prepare_shard = dense16
    reset()
    try:
        model, wall = timed(lambda: km.run(shard, K, W3_KM_ITERS,
                                           compute_dtype="bfloat16"))
        torch.cuda.synchronize()
    finally:
        km.prepare_shard = real_prepare
        eng.allreduce = orig_allreduce
    stats_bytes = K * 257 * 4
    out["hier"] = dict(
        rank=rank, groups=list(eng._groups), tiers=tiers, counts=counts,
        centroids=model.centroids.tolist(), launches=dict(kk.LAUNCHES),
        hist_launches=hk.LAUNCHES["gbdt_hist"], wall=wall,
        stats_ms=[op[1] * 1e3 for op in clock.ops if op[0] == stats_bytes],
        scheds=sorted({op[2] for op in clock.ops
                       if op[0] == stats_bytes}))
    # (c) the last iteration's stats through allreduce_custom
    local = local_stats[-1]
    eng.set_schedule("tree")
    tree = rabit_tpu_torch.allreduce(local.copy(), SUM)
    tree_sched = eng._op_sched
    eng.set_schedule("hier")
    custom, t_custom = timed(lambda: rabit_tpu_torch.allreduce_custom(
        local.copy(), lambda dst, src: np.add(dst, src, out=dst)))
    out["custom"] = dict(rank=rank, shape=list(local.shape),
                         tree_sched=tree_sched, custom_sched=eng._op_sched,
                         same=custom.tobytes() == tree.tobytes(),
                         digest=digest([custom]), ms=t_custom * 1e3)
    rabit_tpu_torch.finalize()
    print(json.dumps(out), flush=True)
    return 0


def phase18(torch, w3):
    """Phase 18: the async per-node histogram stream, k-means under the
    hierarchical schedule and ``allreduce_custom`` at world 3 over the
    port's PySocketEngine (see ``phase18_rank``), three rank processes
    on the card.  Returns B1's and B3's launches by rank."""
    per = -(-P18_NODES // (P18_BUCKET // (GBDT_FEATURES * (GBDT_NBIN + 1)
                                          * 2 * 4)))
    log(f"[18] world {W3_RANKS}: async per-node stream ({P18_NODES} nodes "
        f"x ({GBDT_FEATURES}, {GBDT_NBIN + 1}, 2) float32 from B3, fused "
        f"under a {P18_BUCKET} B bucket: {per} wire ops expected), "
        f"k-means dense16 under rabit_sched=hier with "
        f"RABIT_TRACKER_GROUPS={P18_GROUPS}, allreduce_custom")
    t0 = time.perf_counter()
    saved = os.environ.get("RABIT_TRACKER_GROUPS")
    # the trackers run here: their topology replies carry the groups
    os.environ["RABIT_TRACKER_GROUPS"] = P18_GROUPS
    try:
        results = _run_rank_processes("--phase18-rank", 2, "18")
    finally:
        if saved is None:
            os.environ.pop("RABIT_TRACKER_GROUPS", None)
        else:
            os.environ["RABIT_TRACKER_GROUPS"] = saved
    # (a) the stream
    st = sorted((r["stream"] for r in results), key=lambda r: r["rank"])
    if [r["rank"] for r in st] != list(range(W3_RANKS)):
        raise AssertionError(f"phase-18 ranks {[r['rank'] for r in st]}")
    cap = P18_BUCKET // st[0]["nbytes"]
    want_buckets = [cap] * (P18_NODES // cap) + (
        [P18_NODES % cap] if P18_NODES % cap else [])
    for r in st:
        bad = []
        if r["shape"] != [GBDT_FEATURES, GBDT_NBIN + 1, 2]:
            bad.append(f"shape {r['shape']}")
        if r["launches"] != P18_NODES:
            bad.append(f"{r['launches']} B3 launches")
        if r["buckets"] != want_buckets or r["fused_solo_ops"]:
            bad.append(f"wire ops: buckets {r['buckets']} and "
                       f"{r['fused_solo_ops']} solo ops")
        if r["many_buckets"] != want_buckets:
            bad.append(f"allreduce_many buckets {r['many_buckets']}")
        if r["solo_ops"] != P18_NODES:
            bad.append(f"{r['solo_ops']} solo ops with fuse=False")
        if not (r["same_solo"] and r["same_many"] and r["finite"]):
            bad.append(f"fused equal to solo {r['same_solo']}, to "
                       f"allreduce_many {r['same_many']}, finite "
                       f"{r['finite']}")
        if r["digest"] != st[0]["digest"]:
            bad.append("fused bits differ from rank 0's")
        # every row sits in one node: the hessians sum to 0.25 x rows x f
        want_h = 0.25 * GBDT_ROWS * GBDT_FEATURES
        if abs(r["hess_sum"] - want_h) > 1e-3 * want_h:
            bad.append(f"hessian mass {r['hess_sum']} vs {want_h}")
        if bad:
            raise AssertionError(f"phase 18 stream rank {r['rank']}: "
                                 + "; ".join(bad))
    log(f"    stream: {P18_NODES} nodes x {st[0]['nbytes']} B on each rank, "
        f"B3 launches by rank {[r['launches'] for r in st]}, wire ops "
        f"{st[0]['buckets']} (fused) vs {st[0]['solo_ops']} solo; fused "
        f"bits equal fuse=False and allreduce_many on every rank, and "
        f"the ranks' bits agree")
    for r in st:
        log(f"      rank {r['rank']}: issue (B3 + copy + enqueue) "
            f"{_ms(r['t_issue'])} ms, wait {_ms(r['t_wait'])} ms; wire of "
            f"the same locals: fused (allreduce_many) "
            f"{[_ms(t) for t in r['t_many']]} ms, solo (fuse=False) "
            f"{[_ms(t) for t in r['t_solo']]} ms")
    # (b) k-means under hier
    hr = sorted((r["hier"] for r in results), key=lambda r: r["rank"])
    want_counts = np.asarray(w3["oracle_counts"])
    cents = [np.asarray(r["centroids"], np.float32) for r in hr]
    for r, c in zip(hr, cents):
        got = np.asarray(r["counts"])
        if r["groups"] != [int(g) for g in P18_GROUPS.split(",")] or \
                r["scheds"] != ["hier"] or r["tiers"] != ["dense16"]:
            raise AssertionError(f"phase 18 hier rank {r['rank']}: groups "
                                 f"{r['groups']}, stats rode "
                                 f"{r['scheds']}, tiers {r['tiers']}")
        if got.shape != want_counts.shape or \
                not np.array_equal(got, want_counts):
            raise AssertionError(f"phase 18 hier rank {r['rank']}: counts "
                                 f"{got.tolist()} vs the oracle's "
                                 f"{want_counts.tolist()}")
        if r["launches"]["kmeans_stats_dense"] < W3_KM_ITERS or \
                r["launches"]["kmeans_stats_ell"] or r["hist_launches"]:
            raise AssertionError(f"phase 18 hier rank {r['rank']}: "
                                 f"launches {r['launches']}")
        if not (np.isfinite(c).all() and np.array_equal(c, cents[0])):
            raise AssertionError("phase 18 hier: the ranks' centroids "
                                 "differ")
    ring = [statistics.median(v) for v in w3["ring_stats_ms"]]
    log(f"    k-means hier: counts of all {W3_KM_ITERS} iterations equal "
        f"the oracle's, centroids bit-identical on the ranks, B1 launches "
        f"by rank {[r['launches']['kmeans_stats_dense'] for r in hr]}; "
        f"stats allreduce ({K * 257 * 4} B) by rank and iteration "
        f"{[[_ms(t / 1e3) for t in r['stats_ms']] for r in hr]} ms "
        f"under hier, medians {[_ms(statistics.median(r['stats_ms']) / 1e3) for r in hr]}"
        f" ms beside phase 17's ring {[_ms(t / 1e3) for t in ring]} ms; "
        f"run() {[round(r['wall'], 3) for r in hr]} s")
    # (c) allreduce_custom against the forced-tree SUM
    cu = sorted((r["custom"] for r in results), key=lambda r: r["rank"])
    for r in cu:
        if not r["same"] or r["tree_sched"] != "tree" or \
                r["custom_sched"] != "tree" or r["digest"] != cu[0]["digest"]:
            raise AssertionError(f"phase 18 allreduce_custom rank "
                                 f"{r['rank']}: {r}")
    log(f"    allreduce_custom (np.add) of the {tuple(cu[0]['shape'])} "
        f"stats: the forced-tree SUM's bits on every rank, "
        f"{[_ms(r['ms'] / 1e3) for r in cu]} ms by rank")
    log(f"    phase 18 wall {time.perf_counter() - t0:.1f} s")
    return dict(kmeans_stats_dense=[r["launches"]["kmeans_stats_dense"]
                                    for r in hr],
                gbdt_hist=[r["launches"] for r in st])


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
    from rabit_tpu_torch.ops import histogram_kernel as hk
    from rabit_tpu_torch.ops import kmeans_kernel as kk
    from rabit_tpu_torch.ops import ring_allreduce as rg

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
    dense_kernel_checks(torch, kk)
    log(f"    phase 3 took {time.perf_counter() - t0:.1f} s")

    # 4. ELL kernel against its plain version
    t0 = time.perf_counter()
    log("[4] ELL stats kernel vs plain")
    cent, idx, val, valid = clustered_ell(torch, 1 << 20, 512, 32, K, 6)
    for cdt in (torch.bfloat16, torch.float32):
        check_ell(torch, kk, f"n=2^20 d=512 nnz=32 k=64 {cdt}", cent, idx,
                  val, valid, 512, cdt)
    plans = []
    for n, d, nnz, k in ([(1 << 18, 512, nnz, k) for nnz in (16, 32, 64)
                          for k in (10, 64, 100)]
                         + [(1 << 16, 512, 512, 64), (1 << 16, 512, 512, 100),
                            (1 << 14, 4096, 1024, 64),
                            (1 << 18, 1024, 32, 64),
                            (1 << 13, 32768, 32, 1000)]):
        cent, idx, val, valid = ell_edge_case(torch, n, d, nnz, k,
                                              60 + nnz + k + d)
        for cdt in (torch.bfloat16, torch.float32):
            plans.append(check_ell(
                torch, kk, f"edge cases n={n} d={d} nnz={nnz} k={k} {cdt}",
                cent, idx, val, valid, d, cdt))
    # every layout of the kernel ran: row groups in shared and in device
    # memory, several column slices, more slices than the grid's rows
    for what, seen in (("device-memory row groups", any(p[5] for p in plans)),
                       ("shared-memory row groups with several slices",
                        any(not p[5] and p[2] > 1 for p in plans)),
                       ("more slices than grid rows",
                        any(p[2] > p[1] for p in plans))):
        if not seen:
            raise AssertionError(f"phase 4 never ran {what}")
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
    # the widths C1 made raise: dense16 over the dense budget, and the
    # chained float32 dense tier (x a view into rows of d+1)
    results["dense"]["wide_launches"] = {
        "dense16": dense_wide_run(torch, rabit_tpu_torch, km, kk,
                                  "dense16 d=2048", 1 << 19, "dense16",
                                  "bfloat16"),
        "dense": dense_wide_run(torch, rabit_tpu_torch, km, kk,
                                "dense d=2048", 1 << 17, "dense", "float32")}
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
    del data, idx, val, valid, shard
    # rows wider than the shared-memory row groups take, at a d whose
    # dense copy is over the dense budget
    n_wide, d_wide, nnz_wide, n_it = 1 << 15, 1 << 15, 512, 3
    data = sparse_clusters(n_wide, d_wide, nnz_wide, K, seed=11)
    rabit_tpu_torch.init(rabit_engine="empty")
    for key in kk.LAUNCHES:
        kk.LAUNCHES[key] = 0
    t1 = time.perf_counter()
    model = km.run(data, K, n_it, device_chain=n_it, compute_dtype="float32")
    torch.cuda.synchronize()
    wide_launches = kk.LAUNCHES["kmeans_stats_ell"]
    init = km.init_centroids(data, K, d_wide, seed=0)
    rabit_tpu_torch.finalize()
    log(f"    wide rows n={n_wide} d={d_wide} nnz={nnz_wide}: {n_it} iters "
        f"in {time.perf_counter() - t1:.2f} s, {wide_launches} ELL launches")
    if wide_launches < n_it:
        raise AssertionError(f"ell_fused wide rows: kernel launched "
                             f"{wide_launches} times for {n_it} iterations")
    idx, val, _lab, valid = data.to_ell(pad_index=d_wide, row_block=1024)
    shard = km.prepare_shard(idx, val, valid, d_wide, 1024,
                             compute_dtype="float32")
    if shard[0] != "ell_fused" or shard[2][4] != nnz_wide:
        raise AssertionError(f"wide rows: expected the ell_fused tier at "
                             f"nnz {nnz_wide}, got {shard[0]}")
    ref = km.ell_chain(torch.from_numpy(init.centroids).cuda(), shard[2],
                       d_wide, n_it, use_kernel=False).cpu().numpy()
    err = float(np.abs(model.centroids - ref).max())
    if not (np.isfinite(model.centroids).all()
            and model.centroids.shape == (K, d_wide) and err <= CENT_ATOL):
        raise AssertionError(f"ell_fused wide rows: centroids off the plain "
                             f"loop by {err} (bar {CENT_ATOL})")
    log(f"    wide rows: centroids within {err:.3g} of the plain loop")
    results["ell"].update(wide_launches=wide_launches, wide_payload=shard[2],
                          wide_cent=torch.from_numpy(model.centroids).cuda())
    del data, idx, val, valid, shard
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
    split = dense_split_ms(torch, kk, cent, x, v)
    log(f"    kmeans_stats_dense at ({n}, {d}) bf16 k={K}: {ms:.3f} ms = "
        f"classify {split['classify']:.3f} + fold {split['fold']:.3f} + "
        f"reduce {split['reduce']:.3f} ms apart (one read of x: "
        f"{n * d * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    wide = {}
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        cw, xw, vw = clustered_dense(torch, 1 << 19, 2048, K, dtype, 37)
        wide_ms = time_ms(torch, lambda: kk.kmeans_stats_fused(cw, xw, vw))
        wsplit = dense_split_ms(torch, kk, cw, xw, vw)
        read = xw.numel() * xw.element_size() / HBM_BYTES_PER_S * 1e3
        wide[name] = dict(ms=wide_ms, **{
            f"{stage}_ms": t for stage, t in wsplit.items()})
        log(f"    kmeans_stats_dense at (524288, 2048) {name} k={K}: "
            f"{wide_ms:.3f} ms = classify {wsplit['classify']:.3f} + fold "
            f"{wsplit['fold']:.3f} + reduce {wsplit['reduce']:.3f} ms apart "
            f"(one read of x: {read:.3f} ms)")
        del cw, xw, vw
    sass, how = sass_counts(_build.library_path("kmeans_stats_dense"))
    hmma = sass["HMMA"] if sass is not None else None
    log(f"    kmeans_stats_dense SASS: " + (
        f"{hmma} HMMA instructions ({how} -sass on the built library)"
        if hmma is not None else f"not inspected: {how}"))
    lines.append(dict(
        name="kmeans_stats_dense", route="cuda",
        source="rabit_tpu_torch/ops/csrc/kmeans_stats_dense.cu",
        replaces="rabit_tpu/ops/kmeans_kernel.py:44",
        launches=r["launches"], iterations=r["iters"],
        wide_run_launches=r["wide_launches"], max_abs_err=err,
        ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     ops / PEAK_OPS["bfloat16"]) * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= ops / PEAK_OPS["bfloat16"] else "operations"),
        library_ms=None, library="none: no single PyTorch call",
        shape=f"x ({n}, {d}) bfloat16, k={K}",
        **{f"{stage}_ms": t for stage, t in split.items()},
        d2048=wide, sass_hmma=hmma if hmma is not None else how))
    r = results["ell"]
    idx_g, val_g, dvalid, d_pad, nnz = r["payload"]
    cent = torch.nn.functional.pad(r["cent"], (0, d_pad - r["cent"].shape[1]))
    n = idx_g.shape[0] * 4
    flat_i, flat_v = idx_g.view(n, nnz), val_g.view(n, nnz)

    srt = flat_i.sort(dim=1).values
    real = int((flat_i < d_pad).sum())
    uniq = int(((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] < d_pad)).sum()
               + (srt[:, 0] < d_pad).sum())
    # the slots read once, the sums written once; a merge add per real
    # slot, 2k similarity operations and one sums FMA per distinct
    # nonzero, all float32 on the CUDA cores
    nbytes = n * nnz * 8 + n * 4 + K * d_pad * 2 + K * (d_pad + 1) * 4
    ops = real + 2 * K * uniq + 2 * uniq
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
    by_dtype = {}
    for cdt, name in ((torch.bfloat16, "bfloat16"),
                      (torch.float32, "float32")):
        cn = kk._normalized(cent, cdt)

        def ell_kernel():
            return kk.kmeans_ell_stats_fused(cent, idx_g, val_g, dvalid, d_pad,
                                             nnz=nnz, compute_dtype=cdt)

        got = ell_kernel()
        want = kk._ell_stats_plain(cn, flat_i, flat_v, dvalid, d_pad)
        err = compare(torch, f"ELL main-path shape {name}", got, want)
        ms = time_ms(torch, ell_kernel)
        plain_ms = time_ms(
            torch,
            lambda: kk._ell_stats_plain(cn, flat_i, flat_v, dvalid, d_pad),
            1, 3)
        plan = kk._ell_plan(kk._ell_lib(), flat_i.device, n, d_pad, K, nnz)
        by_dtype[name] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=err,
            column_slices=plan[2], rows_per_warp=plan[4])
        log(f"    kmeans_stats_ell {name}: {ms:.3f} ms ({plan[2]} column "
            f"slice(s), {plan[4]} rows a warp); plain {plain_ms:.3f} ms")
    # the wide-row run's shape (row groups in device memory)
    idx_w, val_w, valid_w, d_w, nnz_w = r["wide_payload"]
    cent_w = torch.nn.functional.pad(r["wide_cent"],
                                     (0, d_w - r["wide_cent"].shape[1]))
    wide_ms = time_ms(torch, lambda: kk.kmeans_ell_stats_fused(
        cent_w, idx_w, val_w, valid_w, d_w, nnz=nnz_w))
    n_w = idx_w.shape[0] * 4
    plan = kk._ell_plan(kk._ell_lib(), idx_w.device, n_w, d_w, K, nnz_w)
    wide_bound_ms = (n_w * nnz_w * 8 + n_w * 4 + K * d_w * 2
                     + K * (d_w + 1) * 4) / HBM_BYTES_PER_S * 1e3
    log(f"    kmeans_stats_ell wide rows ({n_w}, {nnz_w}), d={d_w}, "
        f"bfloat16: {wide_ms:.3f} ms ({plan[2]} column slices, row groups "
        f"in {'device' if plan[5] else 'shared'} memory; bytes bound "
        f"{wide_bound_ms:.4f} ms)")
    del r["wide_payload"], idx_w, val_w, valid_w
    main = by_dtype["bfloat16"]
    lines.append(dict(
        name="kmeans_stats_ell", route="cuda",
        source="rabit_tpu_torch/ops/csrc/kmeans_ell_stats.cu",
        replaces="rabit_tpu/ops/kmeans_kernel.py:134",
        launches=r["launches"], iterations=r["iters"],
        wide_row_launches=r["wide_launches"], wide_row_ms=wide_ms,
        wide_row_bound_ms=wide_bound_ms,
        max_abs_err=main["max_abs_err"], ms=main["ms"], kernel_ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=max(by_bytes, by_ops) * 1e3,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=None, library="none: no single PyTorch call",
        shape=(f"ELL ({n}, {nnz}) int32+float32, d={d_pad}, k={K}, "
               f"bfloat16 compute (what the ell_fused tier runs); {real} "
               f"real slots, {uniq} distinct"),
        by_dtype=by_dtype))
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

    # 9-11. the GBDT histogram kernel and the boosting main path
    t0 = time.perf_counter()
    bins_t, errs = gbdt_kernel_checks(torch, hk)
    log(f"    phase 9 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gbdt = gbdt_main_path(torch, rabit_tpu_torch, kk, hk)
    log(f"    phase 10 took {time.perf_counter() - t0:.1f} s")
    lines.append(gbdt_timing(torch, hk, bins_t, errs, gbdt))

    # 12-13. the ring allreduce kernel and the data-parallel steps
    t0 = time.perf_counter()
    ring_err = ring_checks(torch, rg)
    log(f"    phase 12 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dp_launches, dp_shapes = data_parallel(torch, results, bins_t, kk, hk,
                                           rg)
    log(f"    phase 13 took {time.perf_counter() - t0:.1f} s")

    # 16. the wire: tracker, link handshake and a ring pass on the host,
    # run here while phase 13's dense16 shard is still on the card
    t0 = time.perf_counter()
    dense = results["dense"]
    wire_phase(torch, kk, dense["x"], dense["valid"], dense["cent"])
    log(f"    phase 16 took {time.perf_counter() - t0:.1f} s")
    del results, bins_t, dense
    shapes = {"GBDT histograms": dp_shapes["GBDT histograms"],
              "k-means stats": dp_shapes["k-means stats"],
              "8 x 10^7": (8, 10 ** 7)}
    by_shape = ring_timing(torch, rg, shapes)
    main_b4 = by_shape["GBDT histograms"]
    lines.append(dict(
        name="ring_allreduce", route="cuda",
        source="rabit_tpu_torch/ops/csrc/ring_allreduce.cu",
        replaces="rabit_tpu/ops/ring_allreduce.py:58",
        launches=dp_launches["ring_allreduce"], max_abs_err=ring_err,
        ms=main_b4["ms"], kernel_ms=main_b4["ms"],
        plain_ms=main_b4["plain_ms"], bound_ms=main_b4["bound_ms"],
        bound_by=main_b4["bound_by"], library_ms=main_b4["library_ms"],
        library="torch.stack(xs).sum(0): the reduction, not fanned out to "
                "the ranks",
        shape=f"{shapes['GBDT histograms'][0]} ranks x "
              f"{shapes['GBDT histograms'][1]} float32 (GBDT level "
              "histograms), one card; ms is one call with its host work",
        by_shape=by_shape))

    # 14-15. the tools
    t0 = time.perf_counter()
    ici_sweep(torch)
    log(f"    phase 14 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lines += variant_study(torch, kk)
    log(f"    phase 15 took {time.perf_counter() - t0:.1f} s")

    # 17. k-means and GBDT at world 3 over the pysocket engine
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    w3 = world3_phase(torch, km, kk)
    for line in lines:
        if line["name"] in w3:
            line["world3_launches_by_rank"] = w3[line["name"]]
    log(f"    phase 17 took {time.perf_counter() - t0:.1f} s")

    # 18. the async per-node stream, hier and allreduce_custom at world 3
    t0 = time.perf_counter()
    p18 = phase18(torch, w3)
    for line in lines:
        if line["name"] in p18:
            line["phase18_launches_by_rank"] = p18[line["name"]]
    log(f"    phase 18 took {time.perf_counter() - t0:.1f} s")
    log(f"    total {time.perf_counter() - t_start:.1f} s")

    print(smi_line(), flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world3-rank"]:
        sys.exit(world3_rank(sys.argv[2], [int(p) for p in sys.argv[3:]]))
    if sys.argv[1:2] == ["--phase18-rank"]:
        sys.exit(phase18_rank(sys.argv[2], [int(p) for p in sys.argv[3:]]))
    sys.exit(main())
