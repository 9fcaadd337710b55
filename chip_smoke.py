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
    features, 256 bins and a missing slot, depth 6, 2 rounds -- the
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
    of the same stats, on every rank;
19. (after 18) recovery at world 3 over the port's fault-tolerant
    ``pyrobust`` engine: the port's ``launch_local.launch(3, ...)``
    starts three rank processes (this script with ``--phase19-rank``)
    that join through the tracker URI alone, so the autodetect picks
    ``pyrobust``, and restarts a rank that dies at a ``RABIT_MOCK``
    kill-point with ``RABIT_NUM_TRIAL`` one higher; each life loads the
    kernels phase 2 built and re-stages its third of phase 17's rows.
    (a) ``kmeans.run`` on the dense16 tier, 3 iterations, rank 1 killed
    entering iteration 2's stats allreduce and rank 2 at iteration 3's
    commit: final centroids bit for bit phase 17's on every rank,
    counts exact against phase 17's oracle, B1 launches by life (3; 1
    and 2; 3 and 0).  (b) ``boosting.train``, 2 rounds, float32 kernel,
    rank 0 killed before round 2's third collective: its second life
    replays seqs 0-1 (``last_op_replayed`` only there) and issues the
    survivors' version-1 ops and no other; trees and log-loss bit for
    bit phase 17's float32-kernel run; B3 launches by life against the
    level chunks.  It prints, for every rank and life, the survivors'
    time from the LinkError to the resumed op (recover rendezvous,
    serving, the rest) with the checkpoint bytes served, and the
    relaunched ranks' times from process start (torch, CUDA, engine
    init, data, load, staging or binning, first fresh op).

20. (after 19) liveness at world 3 over ``pyrobust``: the port's
    ``launch_local.launch(3, ...)`` again (this script with
    ``--phase20-rank``), where a rank hangs once (it sends itself
    SIGSTOP at a kill-point check, behind a marker file) with its
    sockets open.  (a) ``kmeans.run`` on the dense16 tier, 3
    iterations, ``heartbeat_sec=0.5`` and the engine's default 600 s
    link timeout, rank 1 stopping entering iteration 2's stats
    allreduce: the tracker's heartbeat verdict makes the launcher kill
    it.  (b) ``boosting.train``, 2 rounds, float32 kernel,
    ``watchdog_sec=10``, no heartbeat, ``RABIT_TIMEOUT_SEC`` three times
    phase 17's longest wait in one collective (30 s at least), rank 0
    stopping before round 2's third collective: the survivors' link
    timeout sends them to the recover round, which the stall watchdog
    finds short of the stopped rank.  Either hang costs exactly one
    kill and one extra life with the same ``RABIT_NUM_TRIAL``;
    centroids, trees and log-loss bit for bit phase 17's; B1 launches
    by life (3; 1 and 2; 3), B3's against the level chunks; the GBDT
    relaunch replays seqs 0-1 as in phase 19.  It prints the stop ->
    verdict or stall -> kill -> relaunched life's first op times and
    each survivor's LinkError -> resumed op.
21. (after 20) the durable checkpoint tier at world 3: the port's
    ``launch_local.launch(3, ..., ckpt_dir=..., max_restarts=3)`` (this
    script with ``--phase21-rank``), every rank a writer (the default
    1 + ``rabit_local_replica``) into one fresh store directory, whose
    filesystem type it prints.  Every rank SIGKILLs itself once right
    after a commit, once all three have made it (marker files), so no
    in-memory replica survives and the relaunched lives must resume
    from disk.  (a) ``kmeans.run`` on the dense16 tier, 3 iterations,
    ``heartbeat_sec=0.5``, every rank killed after iteration 2's
    commit: the relaunched lives load version 2 from disk, served by
    one holder, and run iteration 3 alone; centroids bit for bit phase
    17's, counts exact against phase 17's oracle, B1 launches by rank
    and life [2, 1].  (b) ``boosting.train``, 2 rounds, float32 kernel,
    every rank killed after round 1's commit: the relaunched lives
    resume at version 1 from disk with the cuts in the model (no cut
    broadcast) and train round 2; trees and log-loss bit for bit phase
    17's float32-kernel run, B3 launches by life against the level
    chunks.  Both stores end valid: every blob's CRC, every manifest
    parses, at most ``rabit_ckpt_keep`` blobs a writer, no tmp file.
    It prints each commit's persist time and bytes on each writer, the
    last death -> every relaunch registered, each relaunch's start ->
    cold load (disk read, the whole cold path) -> first fresh op, and
    each job's time against phase 17's.
22. (after 21) elastic membership at world 3 <-> 2 over ``pyrobust``:
    the app loop of ``tests/workers/elastic_worker.py`` around
    ``kmeans.run`` on phase 5's dense16 rows (4,194,304 x 256, k=64,
    bfloat16, 4 iterations, ``heartbeat_sec=0.5``, a fresh ckpt_dir a
    job), each rank re-sharding with ``splitrows.rows_for_rank`` at every
    world (this script with ``--phase22-rank`` or ``--phase22-grow``).
    (a) Shrink: ``launch_local.launch(3, ..., min_workers=2,
    max_restarts=0)``; the world-3 rank 2 SIGKILLs itself right after
    version 1's commit, the tracker's heartbeat EOF verdict (and the
    launcher's elastic leave) shrink the target to 2, and the survivors
    catch ``WorldChangedError``, reload version 1 and finish in halves.
    (b) Grow: two rank processes against the port's ``Tracker(2,
    max_workers=3)``; after version 1's commit they hold at a marker
    file while a third process starts with ``cmd=start`` and parks;
    version 2's commit lands the grow, the survivors reload version 2
    and the joiner's ``load_checkpoint`` is served it.  Every stats
    allreduce at every world counts exactly 4,194,304 rows, every resume
    starts at the committed version, the final centroids lie within
    1e-3 of phase 5's plain device loop over all the rows from the same
    seeds, everything is staged dense16 and B1 runs on every rank at
    every world, its launches by task and (epoch, world) checked and put
    on the ``kernels`` line.  It prints death -> verdict -> rescale ->
    survivors in the new world, joiner start -> parked -> admitted,
    every ``rows_for_rank`` and every re-staging time, and each job's
    wall.

23. (after 22) the device-plane engine at world 3: the port's
    ``launch_local.launch(3, ...)`` (this script with ``--phase23-rank``)
    with ``rabit_engine="xla"`` over ``pyrobust`` and
    ``heartbeat_sec=0.5``; the three rank processes share the card, so
    the group must be gloo on CUDA tensors.  (a) ``kmeans.run`` on phase
    17's dense16 thirds, 4 iterations, rank 1 SIGKILLing itself entering
    iteration 2's device allreduce (``max_restarts=1``): iteration 1 on
    the device plane everywhere, the survivors degrade to the host
    engine (one host op each), the relaunch comes up degraded,
    checkpoint 2 re-forms the plane (``device_epoch`` 1 on all three,
    the shard re-staged once), iterations 3-4 on the device plane again;
    every stats allreduce counts 4,194,304 rows, iterations 1-3 phase
    17's counts, centroids within 1e-3 of the plain loop (run here
    meanwhile) and, at version 3, within the float32 sum bar of phase
    17's; B1 launches by life [4], [2, 3], [4].  (b) ``boosting.train``
    on phase 17's thirds, 2 rounds, float32 kernel, no fault: each
    level's histograms in one device allreduce, the top three levels of
    both trees phase 17's, log-loss within 1e-4.  (c) The engine's NCCL
    ``new_group`` at world 1 on an in-process store, one allreduce of
    the (64, 257) stats (the only NCCL one card can run).  It prints the
    device allreduce ms for the stats and the largest level beside phase
    17's host-plane times, death -> degrade, relaunch start -> degraded
    registration, the reform ms and the phase's wall.

24. (after 23) the linear learner (``learn/linear.py`` on the L-BFGS
    solver, ``learn/lbfgs.py``) and the device plane's adopt and mixed
    modes.  (a) World 1: logistic regression, ``reg_L2=1``, 10 L-BFGS
    iterations, on 4,194,304 rows x 32 hashed features in 2^20 (the ELL
    k-means shard's rows and slots), labels from a planted model, all
    from a seed; the first eval and gradient on the card against the CPU
    path at the same weights within the float32 bar, the objective
    falling every iteration, accuracy over 0.5 points above the base
    score's; then ``python -m rabit_tpu_torch.learn.linear`` on a small
    LibSVM file.  (b) The same rows under ``torchrun --standalone
    --nproc_per_node 3`` (this script with ``--phase24-linear ok``):
    each rank its own gloo group, ``rabit_engine="xla"`` with no
    tracker, so adopt mode, rows by ``splitrows.rows_for_rank``; final
    weights and objective within the bars of ``P24_W_TOL`` and
    ``P24_OBJ_RTOL`` of (a)'s.  Then three plain processes on one group
    (MASTER_ADDR/MASTER_PORT) where rank 1 SIGKILLs itself entering
    iteration 2's gradient allreduce: both survivors raise
    ``RuntimeError`` within ``P24_RAISE_SEC`` and exit 0.  (c)
    ``kmeans.run`` on phase 17's dense16 thirds, 4 iterations, under the
    port's ``Tracker(3)`` with ``RABIT_TRACKER_PIN_RANKS=1`` and ranks
    from torchrun (``--phase24-kmeans``): ``rabit_engine="xla"`` over
    ``pyrobust`` in mixed mode, the stats on the external gloo group,
    checkpoints on the host engine; every stats allreduce counting
    4,194,304 rows, iterations 1-3 phase 17's counts, version 3 within
    the float32 bar of phase 17's; B1 by rank on the ``kernels`` line.
    It prints s per iteration, eval and gradient ms, the ELL's resident
    bytes, the gradient allreduce ms on the adopted group, death ->
    raise, and the stats op ms on the external group beside phase 23's.

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
import signal
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
# 2 rounds (4 until phase 24 was added): the script's time, not a width
GBDT_DEPTH, GBDT_ROUNDS = 6, 2
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


def level_chunk_list(tree, max_depth, chunk):
    """Histogram launches train() issues for one tree, level by level:
    one for each chunk of ``chunk`` live nodes at every level above
    ``max_depth``."""
    depth, counts = {0: 0}, [0] * max_depth
    for nid, node in enumerate(tree):        # parents precede children
        if depth[nid] < max_depth:
            counts[depth[nid]] += 1
        if node.feature >= 0:
            depth[node.left] = depth[node.right] = depth[nid] + 1
    return [-(-c // chunk) for c in counts]


def level_chunks(tree, max_depth, chunk):
    """Histogram launches train() issues for one tree."""
    return sum(level_chunk_list(tree, max_depth, chunk))


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
    chunk = hk.max_channels(GBDT_NBIN + 1, f) // 2
    runs = {}
    real = hk.hist_fused_multi
    real_cuts, real_apply = bh.quantile_cuts, gb.apply_cuts
    for label, kw in (("f32 kernel", dict(compute_dtype="float32")),
                      ("plain", dict(use_kernel=False)),
                      ("bf16 kernel", {})):
        events, stamps, widths = [], [], []
        # train()'s round-0 binning, timed in place; its bins are kept
        binning = dict(s=0.0)

        def binned(fn):
            def call(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                binning["s"] += time.perf_counter() - t
                if fn is real_apply:
                    binning["bins"] = out
                return out
            return call

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
        bh.quantile_cuts, gb.apply_cuts = binned(real_cuts), binned(real_apply)
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
            bh.quantile_cuts, gb.apply_cuts = real_cuts, real_apply
            rabit_tpu_torch.finalize()
        wall = time.perf_counter() - t1
        bins, binning_s = binning["bins"], binning["s"]
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
                           rounds=rounds, binning_s=binning_s, bins=bins,
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
                rounds=k16["rounds"], b3_ms=k16["b3_ms"],
                binning_s=k16["binning_s"], plain_wall=plain["wall"],
                f32_wall=k32["wall"], bins=k16["bins"], by_nw=k16["by_nw"])


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


def _run_rank_processes(flag, ntrackers, phase, meanwhile=None,
                        nranks=W3_RANKS, tracker_kw=None, args=()):
    """Start the port's ``Tracker(nranks, **tracker_kw)`` ``ntrackers``
    times on 127.0.0.1:0 and ``nranks`` processes of this script with
    ``flag TASK PORT... ARGS...`` (no ``RABIT_`` variable in their
    environment), run ``meanwhile(ctl)`` here (``ctl.trackers``;
    ``ctl.spawn(task)`` starts one more such process; ``ctl.failed()``
    says whether one has failed), and wait: a rank that fails fails the
    phase at once (the others would wait on it until their link or
    tracker timeouts).  Returns each rank's last JSON line, once every
    tracker's ``run()`` has returned after the ranks' shutdowns."""
    import types

    from rabit_tpu_torch.tracker.tracker import Tracker

    t0 = time.perf_counter()
    trackers = [Tracker(nranks, host="127.0.0.1", port=0,
                        **(tracker_kw or {})) for _ in range(ntrackers)]
    procs, logs = [], []
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RABIT_")}
    env["PYTHONPATH"] = ROOT

    def spawn(task):
        # the ranks' output goes to files: a rank blocked on a full pipe
        # in mid-collective would stall the ranks waiting on it
        logs.append((tempfile.TemporaryFile("w+"),
                     tempfile.TemporaryFile("w+")))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(task)]
            + [str(t.port) for t in trackers] + [str(a) for a in args],
            cwd=ROOT, env=env, stdout=logs[-1][0], stderr=logs[-1][1]))

    try:
        for t in trackers:
            t.start()
        for i in range(nranks):
            spawn(i)
        if meanwhile is not None:
            meanwhile(types.SimpleNamespace(
                trackers=trackers, spawn=spawn,
                failed=lambda: any(p.poll() not in (None, 0)
                                   for p in procs)))
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

    def run_oracle(_ctl):
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
        centroids=cents[0].tolist(), f32_trees=gb3["f32 kernel"][0]["trees"],
        f32_losses=k32["losses"],
        # the longest one rank waited in one collective of the float32
        # kernel's train(): its longest allreduce, or all its broadcast
        # time (the cuts' broadcast, timed apart from the allreduces)
        f32_longest_wait=max(max(max(op[1] for op in g["ops"]),
                                 g["split"]["wire"]
                                 - sum(op[1] for op in g["ops"]))
                             for g in gb3["f32 kernel"]),
        ring_stats_ms=[[op[1] * 1e3 for op in k["ops"]
                        if op[0] == stats_bytes] for k in km3],
        kmeans_walls=[k["split"]["wall"] for k in km3],
        f32_walls=[g["split"]["wall"] for g in gb3["f32 kernel"]],
        # the largest level histogram's allreduce, by rank (ms)
        f32_level_ms=[max(g["ops"])[1] * 1e3 for g in gb3["f32 kernel"]])


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


# ------------------------------------------------- recovery at world 3
# Phase 19's kill-points, (rank, version, seqno, life) as RABIT_MOCK
# takes them; seqno P19_CKPT is the checkpoint() call.
P19_CKPT = 1 << 20
P19_RUNS = {
    # rank 1 entering iteration 2's stats allreduce, rank 2 at iteration
    # 3's commit
    "kmeans": ((1, 1, 0, 0), (2, 2, P19_CKPT, 0)),
    # rank 0 before round 2's third collective (level 2's histograms)
    "gbdt": ((0, 1, 2, 0),),
}
# B1 launches of each rank's lives under those kill-points: rank 1's
# first life ran iteration 1, its second iterations 2-3; rank 2's first
# ran all three and died at the last commit, its second loads version 3
# and runs none
P19_B1_LIVES = {0: [3], 1: [1, 2], 2: [3, 0]}


# Phase 20's hangs, (rank, version, seqno): the rank sends itself SIGSTOP
# there once (a marker file in the lives' directory keeps its next life,
# started with the same RABIT_NUM_TRIAL, from stopping again).  k-means'
# rank 1 entering iteration 2's stats allreduce is found by the
# heartbeat (0.5 s, a miss budget of 3), GBDT's rank 0 before round 2's
# third collective by the stall watchdog once the survivors' link
# timeout sends them to the recover round.
P20_RUNS = {"kmeans": (1, 1, 0), "gbdt": (0, 1, 2)}
P20_HEARTBEAT_SEC = 0.5
# The watchdog rearms every period while the recover round waits for the
# relaunched rank; the stall killer spares a life until the tracker has
# seen it register (launch_local.START_GRACE_SEC at most), so the period
# only bounds how long a hung rank holds the round: 10 s.
P20_WATCHDOG_SEC = 10.0
# The survivors' link timeout in (b): at least this many times the
# longest wait in one collective of phase 17's float32-kernel run, and
# never under P20_TIMEOUT_MIN seconds.
P20_TIMEOUT_WAITS, P20_TIMEOUT_MIN = 3, 30
# B1 launches by life: the stop comes at the allreduce's kill-point
# check, before prepare_fun fills the stats (engine/robust.py
# _allreduce_blocking), so rank 1's first life ran iteration 1 and its
# second, loading version 1, iterations 2-3
P20_B1_LIVES = {0: [3], 1: [1, 2], 2: [3]}


_STARTED = []      # monotonic clock at this process's start


def since_start():
    """Seconds since this process started: the kernel's start time of
    the process against its uptime (10 ms ticks) fixes the origin once,
    on the monotonic clock, which times everything after."""
    if not _STARTED:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        _STARTED.append(time.monotonic()
                        - (up - start / os.sysconf("SC_CLK_TCK")))
    return time.monotonic() - _STARTED[0]


def _recovery_probe(eng, rec, dump, stop=None):
    """Record, on the live engine, every collective of this life (kind,
    version, seqno, bytes, whether replayed, when issued and done),
    each recovery episode (from the LinkError through the recover
    rendezvous and the serving rounds to the op that resumed) with the
    checkpoint bytes served, and ``dump()`` the record before a
    kill-point ends the process.  ``stop`` (rank, version, seqno,
    marker): at that kill-point check, unless the marker file exists,
    make it, dump the record and send this process SIGSTOP."""
    real = {name: getattr(eng, name) for name in (
        "_allreduce_blocking", "_broadcast_blocking", "_rendezvous_recover",
        "_serve_checkpoint_load", "_serve_result", "_bcast_impl", "_verify",
        "checkpoint", "load_checkpoint")}
    ep, serving = {}, [False]

    def close(what, version, seq):
        if ep:
            now = since_start()
            rec["episodes"].append(dict(
                ep, resumed=now, total=now - ep["t_err"], op=what,
                version=version, seq=seq))
            ep.clear()

    def collective(kind, nbytes):
        def call(*a, **k):
            version, seq, t0 = eng._version, eng._seq, since_start()
            out = real[f"_{kind}_blocking"](*a, **k)
            op = dict(kind=kind, version=version, seq=seq,
                      nbytes=nbytes(a[0], out),
                      replayed=eng.last_op_replayed, issued=t0,
                      done=since_start())
            if kind == "allreduce" and a[0].ndim == 2:
                op["counts"] = a[0][:, -1].tolist()
            rec["ops"].append(op)
            close(kind, version, seq)
            return out
        return call

    def rendezvous_recover():
        t0 = since_start()
        if not ep:
            ep.update(t_err=t0, rendezvous=0.0, serving=0.0,
                      ckpt_bytes=0, results=0)
        real["_rendezvous_recover"]()
        ep["rendezvous"] += since_start() - t0

    def served(name):
        def call(*a, **k):
            t0 = since_start()
            serving[0] = name == "_serve_checkpoint_load"
            try:
                return real[name](*a, **k)
            finally:
                serving[0] = False
                where = ep if ep else rec["load_serving"]
                where["serving"] = where.get("serving", 0.0) \
                    + since_start() - t0
                if name == "_serve_result":
                    where["results"] = where.get("results", 0) + 1
        return call

    def bcast(data, root):
        out = real["_bcast_impl"](data, root)
        if serving[0]:
            where = ep if ep else rec["load_serving"]
            where["ckpt_bytes"] = where.get("ckpt_bytes", 0) + len(out)
        return out

    def verify(seqno):
        if stop is not None and (eng._rank, eng._version, seqno) == \
                tuple(stop[:3]) and not os.path.exists(stop[3]):
            open(stop[3], "w").close()
            rec["stopped"] = [eng._version, seqno]
            rec["marks"]["stopped"] = since_start()
            dump()
            os.kill(os.getpid(), signal.SIGSTOP)   # hung until killed
        if (eng._version, seqno, eng._num_trial) in eng._kill_points:
            rec["killed"] = [eng._version, seqno]
            rec["marks"]["killed"] = since_start()
            dump()
        real["_verify"](seqno)

    def checkpoint(*a, **k):
        version = eng._version
        real["checkpoint"](*a, **k)
        close("checkpoint", version, P19_CKPT)

    def load_checkpoint():
        out = real["load_checkpoint"]()
        rec["start_version"] = out[0]
        rec["marks"]["loaded"] = since_start()
        return out

    eng._allreduce_blocking = collective("allreduce", lambda a, o: a.nbytes)
    eng._broadcast_blocking = collective("broadcast", lambda a, o: len(o))
    eng._rendezvous_recover = rendezvous_recover
    eng._serve_checkpoint_load = served("_serve_checkpoint_load")
    eng._serve_result = served("_serve_result")
    eng._bcast_impl = bcast
    eng._verify = verify
    eng.checkpoint = checkpoint
    eng.load_checkpoint = load_checkpoint


def _durable_probe(eng, rec, dump, which, out_dir):
    """Phase 21's additions to ``_recovery_probe`` on the live engine:
    every persist of this rank's store (version, ms, bytes on disk), the
    cold load's parts (the disk read, the whole cold path with its two
    agreement rounds, the serve and the install, the serving rank), and
    the kill-all: right after the commit of ``P21_KILL[which]`` this
    life leaves a marker, waits until every rank has left one (every
    rank has committed that version), dumps its record and SIGKILLs
    itself; the markers keep the next lives from dying again."""
    store = eng._ckpt_store
    if store is None:
        raise RuntimeError("phase 21's ranks need the launcher's ckpt_dir")
    rec.update(persists=[], cold=None, store=store.root)
    marker = os.path.join(out_dir, f"killed.{which}.{eng.rank}")
    real = {name: getattr(eng, name) for name in (
        "_try_disk_read", "_cold_checkpoint_load", "_bcast_impl",
        "checkpoint")}
    real_persist, cold = store.persist, {}

    def persist(version, world, global_blob, locals_=None):
        t0 = time.perf_counter()
        path = real_persist(version, world, global_blob, locals_)
        rec["persists"].append(dict(
            version=version, ms=(time.perf_counter() - t0) * 1e3,
            bytes=os.path.getsize(path), at=since_start()))
        return path

    def try_disk_read():
        t0 = time.perf_counter()
        dc = real["_try_disk_read"]()
        cold.update(disk_ms=(time.perf_counter() - t0) * 1e3,
                    disk_version=None if dc is None else dc.version)
        return dc

    def cold_load(i_am_loader):
        cold.clear()
        cold["active"], start = True, since_start()
        try:
            return real["_cold_checkpoint_load"](i_am_loader)
        finally:
            del cold["active"]
            end = since_start()
            rec["cold"] = dict(cold, start=start, end=end,
                               ms=(end - start) * 1e3, version=eng._version)

    def bcast(data, root):
        out = real["_bcast_impl"](data, root)
        if cold.get("active"):
            cold.update(root=root, nbytes=len(out))
        return out

    def checkpoint(*a, **k):
        real["checkpoint"](*a, **k)
        if eng._version == P21_KILL[which] and not os.path.exists(marker):
            open(marker, "w").close()
            deadline = time.monotonic() + W3_TIMEOUT
            while time.monotonic() < deadline and len(
                    [n for n in os.listdir(out_dir)
                     if n.startswith(f"killed.{which}.")]) < W3_RANKS:
                time.sleep(0.005)
            rec["sigkilled"] = eng._version
            rec["marks"]["killed"] = since_start()
            dump()
            os.kill(os.getpid(), signal.SIGKILL)

    store.persist = persist
    eng._try_disk_read = try_disk_read
    eng._cold_checkpoint_load = cold_load
    eng._bcast_impl = bcast
    eng.checkpoint = checkpoint


def robust_rank(phase, which, out_dir):
    """One rank process of phase 19, 20 or 21 (``chip_smoke.py
    --phase19-rank|--phase20-rank|--phase21-rank WHICH DIR``), started,
    and restarted after a kill-point or a kill, by the port's
    ``launch_local.launch``.
    It joins through the tracker URI the launcher puts in its
    environment (no ``rabit_engine``: the autodetect picks ``pyrobust``)
    and runs phase 17's job on its third of phase 17's rows:
    ``kmeans.run`` on the dense16 tier (B1) or ``boosting.train`` with
    the float32 kernel (B3).  A life writes its record (collectives,
    recovery episodes, launches, times since the process started and
    that origin on the monotonic clock, results) to DIR, also just
    before its kill-point ends it, its phase-20 stop hangs it or its
    phase-21 kill ends it (``_durable_probe``).  Phases 19 and 21 bound
    the links at W3_TIMEOUT; phase 20 leaves the timeout to the engine's
    default or ``RABIT_TIMEOUT_SEC``."""
    marks = {}
    import torch

    marks["torch"] = since_start()
    if not torch.cuda.is_available():
        raise RuntimeError("the phase-19 ranks run on the card")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda"] = since_start()
    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch import engine as engine_mod
    from rabit_tpu_torch.learn import boosting as gb
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.ops import histogram_kernel as hk
    from rabit_tpu_torch.ops import kmeans_kernel as kk
    from rabit_tpu_torch.parallel.mesh import local_data_slice

    torch.backends.cuda.matmul.allow_tf32 = False
    rabit_tpu_torch.init(**({"rabit_timeout_sec": W3_TIMEOUT}
                            if phase in ("19", "21") else {}))
    marks["init"] = since_start()
    eng = engine_mod.get_engine()
    rank = eng.rank
    trial, relaunch = (int(os.environ[v]) for v in ("RABIT_NUM_TRIAL",
                                                     "RABIT_RELAUNCH"))
    rec = dict(which=which, rank=rank, trial=trial, relaunch=relaunch,
               engine=type(eng).__name__, relaunched=eng.was_relaunched,
               marks=marks, ops=[], episodes=[], load_serving={},
               tiers=[], done=False, t0=_STARTED[0], pid=os.getpid())
    path = os.path.join(out_dir, f"{which}.{rank}.{trial}.{relaunch}.json")

    def dump():
        rec["launches"] = dict(kk.LAUNCHES, **hk.LAUNCHES)
        with open(path, "w") as f:
            json.dump(rec, f)

    stop = None
    if phase == "20":
        stop = P20_RUNS[which] + (os.path.join(out_dir, "stopped." + which),)
    _recovery_probe(eng, rec, dump, stop)
    if phase == "21":
        _durable_probe(eng, rec, dump, which, out_dir)
    if which == "kmeans":
        data = sparse_clusters(MAIN_ROWS, 256, 32, K, seed=7,
                               picks=world3_picks(MAIN_ROWS, K, W3_RANKS))
        shard = _shard_rows(data, local_data_slice(rank, W3_RANKS,
                                                   MAIN_ROWS))
        del data
        marks["data"] = since_start()
        real_prepare = km.prepare_shard

        def dense16(*a, **k):
            staged = real_prepare(*a, budget=0, **k)   # as phase 17
            torch.cuda.synchronize()
            rec["tiers"].append(staged[0])
            marks["staged"] = since_start()
            return staged
        km.prepare_shard = dense16
        model = km.run(shard, K, W3_KM_ITERS, compute_dtype="bfloat16")
        torch.cuda.synchronize()
        rec["centroids"] = model.centroids.tolist()
    else:
        x_all, y_all = gbdt_data(GBDT_ROWS, GBDT_FEATURES, seed=11)
        s = local_data_slice(rank, W3_RANKS, GBDT_ROWS)
        x, y = np.ascontiguousarray(x_all[s]), np.ascontiguousarray(y_all[s])
        del x_all, y_all
        marks["data"] = since_start()
        bins, real_apply = [], gb.apply_cuts

        def keep_bins(*a, **k):
            bins.append(real_apply(*a, **k))
            marks["staged"] = since_start()
            return bins[-1]
        gb.apply_cuts = keep_bins
        model = gb.train(x, y, num_round=W3_GB_ROUNDS, max_depth=GBDT_DEPTH,
                         nbin=GBDT_NBIN, **W3_GB_KW["f32 kernel"])
        torch.cuda.synchronize()
        losses, _acc, _pred = round_losses(model, bins[0], y)
        chunk = hk.max_channels(GBDT_NBIN + 1, GBDT_FEATURES) // 2
        rec.update(rows=len(y), loss_sums=[v * len(y) for v in losses],
                   trees=[[dataclasses.astuple(n) for n in t]
                          for t in model.trees],
                   level_chunks=[level_chunk_list(t, GBDT_DEPTH, chunk)
                                 for t in model.trees])
    marks["end"] = since_start()
    rec["done"] = True
    dump()
    rabit_tpu_torch.finalize()
    return 0


def _children_with(marker):
    """Pids of this process's children whose command line holds
    ``marker``."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if ppid == os.getpid() and marker.encode() in cmdline:
            pids.append(int(d))
    return pids


def _launch_ranks(phase, which, out_dir, **kw):
    """The port's ``launch_local.launch`` of three rank processes of
    phase 19, 20 or 21 (``kw`` as ``launch`` takes it), bounded: past
    W3_TIMEOUT its workers are killed (the launcher then returns their
    code) and the phase fails.  Returns (launcher's code, seconds)."""
    import threading

    from rabit_tpu_torch.tracker.launch_local import launch

    flag = f"--phase{phase}-rank"
    res = {}
    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: res.update(code=launch(
        W3_RANKS, [sys.executable, os.path.abspath(__file__), flag, which,
                   out_dir], **kw)), daemon=True)
    th.start()
    th.join(W3_TIMEOUT)
    if th.is_alive():
        for pid in _children_with(flag):
            os.kill(pid, signal.SIGKILL)
        th.join(60)
        raise AssertionError(f"phase {phase} {which}: the launch did not "
                             f"end within {W3_TIMEOUT:g} s")
    return res["code"], time.perf_counter() - t0


def _rank_lives(out_dir, which):
    """{rank: [record of each life, in order]} from the lives' files."""
    lives = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(which + "."):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            lives.setdefault(r["rank"], []).append(r)
    for recs in lives.values():
        recs.sort(key=lambda r: (r["trial"], r["relaunch"]))
    return lives


def _recovery_times(which, lives):
    """Phase 19's or 20's recovery times, one line a rank and life."""
    for rank, recs in sorted(lives.items()):
        for r in recs:
            m = r["marks"]
            head = (f"      {which} rank {rank} life {r['trial'] + 1} "
                    f"(RABIT_NUM_TRIAL {r['trial']}, relaunched "
                    f"{r['relaunched']})")
            if r["relaunched"]:
                fresh = [o for o in r["ops"] if not o["replayed"]]
                first = (f"its first fresh op ({fresh[0]['kind']} v"
                         f"{fresh[0]['version']} seq {fresh[0]['seq']}) "
                         f"issued at {fresh[0]['issued']:.3f} s"
                         if fresh else "no fresh op: the checkpoint it "
                         "loaded was the last")
                ls = r["load_serving"]
                log(f"{head}: from process start, torch imported "
                    f"{m['torch']:.3f} s, CUDA ready {m['cuda']:.3f} s, "
                    f"engine init (rendezvous) {m['init']:.3f} s, data "
                    f"{m['data']:.3f} s, load_checkpoint (version "
                    f"{r['start_version']}, {ls.get('ckpt_bytes', 0)} B "
                    f"served in {ls.get('serving', 0) * 1e3:.3f} ms) "
                    f"{m['loaded']:.3f} s, "
                    f"{'staged' if which == 'kmeans' else 'binned'} "
                    f"{m['staged']:.3f} s; {first}; "
                    f"{sum(o['replayed'] for o in r['ops'])} op(s) "
                    f"replayed; done {m.get('end', 0):.3f} s")
            for e in r["episodes"]:
                log(f"{head}: LinkError at {e['t_err']:.3f} s -> "
                    f"{e['op']} v{e['version']} seq {e['seq']} resumed "
                    f"after {e['total'] * 1e3:.3f} ms = recover "
                    f"rendezvous {e['rendezvous'] * 1e3:.3f} + serving "
                    f"{e['serving'] * 1e3:.3f} ms ({e['ckpt_bytes']} B "
                    f"of checkpoint, {e['results']} cached result(s)) + "
                    f"the rest {(e['total'] - e['rendezvous'] - e['serving']) * 1e3:.3f} "
                    f"ms (waiting on the relaunched rank)")
            if "killed" in r:
                log(f"{head}: killed at v{r['killed'][0]} seq "
                    f"{r['killed'][1]} at {m['killed']:.3f} s")
            if "stopped" in r:
                log(f"{head}: stopped (SIGSTOP) at v{r['stopped'][0]} seq "
                    f"{r['stopped'][1]} at {m['stopped']:.3f} s")


def phase19(torch, w3):
    """Phase 19: k-means and GBDT at world 3 over the port's
    ``pyrobust`` engine through real rank deaths and relaunches, under
    the port's keepalive launcher (see ``robust_rank``).

    (a) ``kmeans.run``, dense16, 3 iterations, rank 1 killed at
    (version 1, seq 0) and rank 2 at (2, checkpoint): the final
    centroids bit for bit phase 17's on every rank, counts exact against
    phase 17's oracle, B1 launches by life as ``P19_B1_LIVES``.

    (b) ``boosting.train``, 2 rounds, the float32 kernel, rank 0 killed
    at (1, 2).  ``train``'s seqno map (version = rounds committed):
      version 0: seq 0 = the cuts' broadcast from rank 0, seq 1 = the
        missing-value vote (MAX, async, ``fuse=False``), seq 2 ... =
        one level histogram allreduce a depth while the frontier is not
        empty (depths 0-5), then the leaves' (g, h) sums; checkpoint;
      version 1: seq 0 ... = the level histograms, then the leaves'
        sums; checkpoint.
    A resumed rank skips the cuts' broadcast and the vote (the model
    carries both), so its version-1 ops must be the survivors' own.
    Its second life replays seqs 0-1 from the peers' caches
    (``last_op_replayed`` exactly there) and joins seq 2 fresh; trees
    node for node and log-loss bit for bit phase 17's float32-kernel
    run; B3 launches by life against the level chunks.

    Returns B1's and B3's launches by rank and life."""
    log(f"[19] recovery at world {W3_RANKS} over the port's pyrobust "
        f"engine: launch_local.launch({W3_RANKS}, ...) with kill-points; "
        f"k-means dense16 {MAIN_ROWS} x 256, {W3_KM_ITERS} iterations, "
        f"RABIT_MOCK {P19_RUNS['kmeans']}; boosting.train {GBDT_ROWS} x "
        f"{GBDT_FEATURES}, {W3_GB_ROUNDS} rounds, float32 kernel, "
        f"RABIT_MOCK {P19_RUNS['gbdt']}")
    from rabit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = [_build.library_path(n) for n in ("kmeans_stats_dense",
                                             "histogram")]
    stamps = [p.stat().st_mtime_ns for p in libs]
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in P19_RUNS:
            code, secs = _launch_ranks("19", which, tmp, extra_env={
                "RABIT_MOCK": ";".join(",".join(map(str, p))
                                       for p in P19_RUNS[which])})
            lives = _rank_lives(tmp, which)
            if code != 0:
                raise AssertionError(f"phase 19 {which}: the launcher "
                                     f"returned {code}")
            want = {r: 1 + sum(p[0] == r for p in P19_RUNS[which])
                    for r in range(W3_RANKS)}
            got = {r: len(lives.get(r, [])) for r in range(W3_RANKS)}
            if got != want:
                raise AssertionError(f"phase 19 {which}: lives by rank "
                                     f"{got}, kill-points give {want}")
            for rank, recs in lives.items():
                for i, r in enumerate(recs):
                    last = i == len(recs) - 1
                    kill = [p for p in P19_RUNS[which] if p[0] == rank
                            and p[3] == r["trial"]]
                    if (r["engine"] != "PyRobustEngine" or r["done"] != last
                            or r["relaunched"] != (i > 0)
                            or r.get("killed") != (
                                list(kill[0][1:3]) if kill else None)):
                        raise AssertionError(
                            f"phase 19 {which} rank {rank} life {i + 1}: "
                            f"engine {r['engine']}, done {r['done']}, "
                            f"relaunched {r['relaunched']}, killed "
                            f"{r.get('killed')} for kill-points {kill}")
            result[which] = dict(lives=lives, seconds=secs)
            log(f"    {which}: launcher returned 0 in {secs:.1f} s; lives "
                f"by rank {[got[r] for r in range(W3_RANKS)]}")
    if [p.stat().st_mtime_ns for p in libs] != stamps:
        raise AssertionError("phase 19: a rank process rebuilt a kernel")

    # (a) k-means
    lives = result["kmeans"]["lives"]
    want_cent = np.asarray(w3["centroids"], np.float32)
    oracle = np.asarray(w3["oracle_counts"])
    b1 = {}
    for rank, recs in sorted(lives.items()):
        final = recs[-1]
        cent = np.asarray(final["centroids"], np.float32)
        if not np.array_equal(cent, want_cent):
            raise AssertionError(
                f"phase 19 k-means rank {rank}: final centroids off phase "
                f"17's by {float(np.abs(cent - want_cent).max())}")
        for r in recs:
            for op in (o for o in r["ops"] if "counts" in o):
                if op["counts"] != oracle[op["version"]].tolist():
                    raise AssertionError(
                        f"phase 19 k-means rank {rank} life "
                        f"{r['trial'] + 1}: counts at version "
                        f"{op['version']} off the oracle's")
            if r["done"] and r["tiers"] != ["dense16"]:
                raise AssertionError(f"phase 19 k-means rank {rank}: "
                                     f"staged {r['tiers']}")
        b1[rank] = [r["launches"]["kmeans_stats_dense"] for r in recs]
        if b1[rank] != P19_B1_LIVES[rank] or any(
                r["launches"]["kmeans_stats_ell"] for r in recs):
            raise AssertionError(f"phase 19 k-means rank {rank}: B1 "
                                 f"launches by life {b1[rank]}, want "
                                 f"{P19_B1_LIVES[rank]}")
    starts = {rank: [r.get("start_version") for r in recs]
              for rank, recs in lives.items()}
    if starts != {0: [0], 1: [0, 1], 2: [0, 3]}:
        raise AssertionError(f"phase 19 k-means: checkpoints loaded by "
                             f"rank and life {starts}")
    log(f"    k-means: final centroids on every rank bit for bit phase "
        f"17's; counts of every iteration each life ran equal the "
        f"oracle's; B1 launches by rank and life "
        f"{[b1[r] for r in range(W3_RANKS)]}; versions loaded "
        f"{[starts[r] for r in range(W3_RANKS)]}")
    _recovery_times("kmeans", lives)

    # (b) GBDT
    lives = result["gbdt"]["lives"]
    dead = P19_RUNS["gbdt"][0][0]
    finals = [lives[r][-1] for r in range(W3_RANKS)]
    trees = finals[0]["trees"]
    if any(f["trees"] != trees for f in finals) or \
            trees != w3["f32_trees"]:
        raise AssertionError("phase 19 GBDT: the trees differ from phase "
                             "17's float32-kernel trees")
    n = sum(f["rows"] for f in finals)
    losses = [sum(f["loss_sums"][i] for f in finals) / n
              for i in range(W3_GB_ROUNDS)]
    if losses != w3["f32_losses"]:
        raise AssertionError(f"phase 19 GBDT: log-loss {losses} vs phase "
                             f"17's {w3['f32_losses']}")
    second = lives[dead][1]

    def seq_map(recs, version):
        return [(o["kind"], o["seq"], o["nbytes"]) for r in recs
                for o in r["ops"] if o["version"] == version]
    survivor = next(r for r in range(W3_RANKS) if r != dead)
    if seq_map([second], 0) or seq_map([second], 1) != seq_map(
            lives[survivor], 1):
        raise AssertionError(
            f"phase 19 GBDT: the relaunched rank's ops {seq_map([second], 0)}"
            f" at version 0 and {seq_map([second], 1)} at version 1, the "
            f"survivors' {seq_map(lives[survivor], 1)}")
    replayed = [(o["version"], o["seq"]) for o in second["ops"]
                if o["replayed"]]
    if replayed != [(1, 0), (1, 1)] or any(
            o["replayed"] for r in range(W3_RANKS) for life in lives[r]
            if life is not second for o in life["ops"]):
        raise AssertionError(f"phase 19 GBDT: replayed ops {replayed}")
    chunks = finals[0]["level_chunks"]
    b3 = {r: [life["launches"]["gbdt_hist"] for life in lives[r]]
          for r in range(W3_RANKS)}
    died_at = P19_RUNS["gbdt"][0][2]
    want_b3 = {r: [sum(map(sum, chunks))] for r in range(W3_RANKS)}
    want_b3[dead] = [sum(chunks[0]) + sum(chunks[1][:died_at + 1]),
                     sum(chunks[1])]
    if b3 != want_b3 or any(life["launches"]["kmeans_stats_dense"]
                            for recs in lives.values() for life in recs):
        raise AssertionError(f"phase 19 GBDT: B3 launches by rank and life "
                             f"{b3}, level chunks give {want_b3}")
    log(f"    GBDT: trees node for node and log-loss "
        f"{[round(v, 6) for v in losses]} bit for bit phase 17's float32 "
        f"kernel; the relaunched rank {dead} replayed {replayed} "
        f"(last_op_replayed there only) and issued the survivors' "
        f"version-1 ops, no cuts broadcast; B3 launches by rank and life "
        f"{[b3[r] for r in range(W3_RANKS)]} (level chunks {chunks})")
    _recovery_times("gbdt", lives)
    log(f"    phase 19 wall {time.perf_counter() - t0:.1f} s")
    return dict(kmeans_stats_dense=[b1[r] for r in range(W3_RANKS)],
                gbdt_hist=[b3[r] for r in range(W3_RANKS)])


class _KillLog:
    """Times, on the monotonic clock, of the port launcher's hung-rank
    decisions during one launch: each heartbeat verdict its ``on_dead``
    gets, each stall its ``on_stall`` gets, and each worker it kills
    (``Popen.kill``, which only those two call)."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        from rabit_tpu_torch.tracker import launch_local as ll

        self._ll = ll
        self._real = (ll.make_dead_killer, ll.make_stall_killer,
                      subprocess.Popen.kill)
        real_dead, real_stall, real_kill = self._real
        events = self.events

        def dead_killer(*a, **k):
            fn = real_dead(*a, **k)

            def on_dead(task):
                events.append(("verdict", time.monotonic(), task))
                fn(task)
            return on_dead

        def stall_killer(*a, **k):
            fn = real_stall(*a, **k)

            def on_stall(present, finished):
                events.append(("stall", time.monotonic(), sorted(present)))
                fn(present, finished)
            return on_stall

        def kill(proc):
            events.append(("kill", time.monotonic(), proc.pid))
            real_kill(proc)
        ll.make_dead_killer, ll.make_stall_killer = dead_killer, stall_killer
        subprocess.Popen.kill = kill
        return self

    def __exit__(self, *exc):
        (self._ll.make_dead_killer, self._ll.make_stall_killer,
         subprocess.Popen.kill) = self._real

    def of(self, kind):
        return [e for e in self.events if e[0] == kind]


def phase20(torch, w3):
    """Phase 20: k-means and GBDT at world 3 over ``pyrobust`` through a
    rank that hangs (SIGSTOP) while it holds its sockets, under the
    port's launcher with the liveness layer: (a) ``kmeans.run`` with
    heartbeats every P20_HEARTBEAT_SEC and the engine's default 600 s
    link timeout, so only the tracker's dead verdict can free the
    survivors; (b) ``boosting.train`` with the float32 kernel, no
    heartbeat, the stall watchdog at P20_WATCHDOG_SEC and a link
    timeout of at least P20_TIMEOUT_WAITS times phase 17's longest wait
    in one collective.  Each hang must cost exactly one kill and one
    extra life (another would be a false verdict); results bit for bit
    phase 17's; B1 and B3 launches by life as the stop point gives
    them; replays where phase 19 puts them.  Returns B1's and B3's
    launches by rank and life."""
    timeout = max(P20_TIMEOUT_MIN,
                  int(np.ceil(P20_TIMEOUT_WAITS * w3["f32_longest_wait"])))
    log(f"[20] hung ranks at world {W3_RANKS} over pyrobust: "
        f"launch_local.launch({W3_RANKS}, ...); k-means dense16 "
        f"{MAIN_ROWS} x 256, {W3_KM_ITERS} iterations, rank "
        f"{P20_RUNS['kmeans'][0]} stops at {P20_RUNS['kmeans'][1:]}, "
        f"heartbeat_sec={P20_HEARTBEAT_SEC}, link timeout left at 600 s; "
        f"boosting.train {GBDT_ROWS} x {GBDT_FEATURES}, {W3_GB_ROUNDS} "
        f"rounds, float32 kernel, rank {P20_RUNS['gbdt'][0]} stops at "
        f"{P20_RUNS['gbdt'][1:]}, watchdog_sec={P20_WATCHDOG_SEC:g}, "
        f"RABIT_TIMEOUT_SEC={timeout} (phase 17's longest wait in one "
        f"collective {w3['f32_longest_wait']:.3f} s)")
    from rabit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = [_build.library_path(n) for n in ("kmeans_stats_dense",
                                             "histogram")]
    stamps = [p.stat().st_mtime_ns for p in libs]
    kw = {"kmeans": dict(heartbeat_sec=P20_HEARTBEAT_SEC),
          "gbdt": dict(watchdog_sec=P20_WATCHDOG_SEC,
                       extra_env={"RABIT_TIMEOUT_SEC": str(timeout)})}
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in P20_RUNS:
            with _KillLog() as kl:
                code, secs = _launch_ranks("20", which, tmp, **kw[which])
            lives = _rank_lives(tmp, which)
            if code != 0:
                raise AssertionError(f"phase 20 {which}: the launcher "
                                     f"returned {code}")
            hung = P20_RUNS[which][0]
            got = {r: len(lives.get(r, [])) for r in range(W3_RANKS)}
            want = {r: 1 + (r == hung) for r in range(W3_RANKS)}
            stops = [(rank, i) for rank, recs in lives.items()
                     for i, r in enumerate(recs) if "stopped" in r]
            kills = kl.of("kill")
            if got != want or stops != [(hung, 0)] or len(kills) != 1 \
                    or kills[0][2] != lives[hung][0]["pid"]:
                raise AssertionError(
                    f"phase 20 {which}: lives by rank {got} (want {want}: "
                    f"another is a false verdict), stops {stops}, kills "
                    f"{kills}, the stopped life's pid "
                    f"{lives.get(hung, [{}])[0].get('pid')}")
            for rank, recs in lives.items():
                for i, r in enumerate(recs):
                    if (r["engine"] != "PyRobustEngine"
                            or r["done"] != (i == len(recs) - 1)
                            or r["relaunched"] != (i > 0)
                            or (r["trial"], r["relaunch"]) != (0, i)
                            or "killed" in r):
                        raise AssertionError(
                            f"phase 20 {which} rank {rank} life {i + 1}: "
                            f"engine {r['engine']}, done {r['done']}, "
                            f"relaunched {r['relaunched']}, trial "
                            f"{r['trial']}, relaunch {r['relaunch']}")
            if which == "kmeans" and (kl.of("stall")
                                      or not kl.of("verdict")):
                raise AssertionError(f"phase 20 kmeans: launcher events "
                                     f"{kl.events}")
            if which == "gbdt" and (kl.of("verdict") or not kl.of("stall")):
                raise AssertionError(f"phase 20 gbdt: launcher events "
                                     f"{kl.events}")
            result[which] = dict(lives=lives, seconds=secs,
                                 events=list(kl.events))
            log(f"    {which}: launcher returned 0 in {secs:.1f} s; lives "
                f"by rank {[got[r] for r in range(W3_RANKS)]}; one stop, "
                f"one kill; launcher events "
                f"{[(e[0], e[2]) for e in kl.events]}")
    if [p.stat().st_mtime_ns for p in libs] != stamps:
        raise AssertionError("phase 20: a rank process rebuilt a kernel")

    # (a) k-means
    lives = result["kmeans"]["lives"]
    want_cent = np.asarray(w3["centroids"], np.float32)
    oracle = np.asarray(w3["oracle_counts"])
    b1 = {}
    for rank, recs in sorted(lives.items()):
        cent = np.asarray(recs[-1]["centroids"], np.float32)
        if not np.array_equal(cent, want_cent):
            raise AssertionError(
                f"phase 20 k-means rank {rank}: final centroids off phase "
                f"17's by {float(np.abs(cent - want_cent).max())}")
        for r in recs:
            for op in (o for o in r["ops"] if "counts" in o):
                if op["counts"] != oracle[op["version"]].tolist():
                    raise AssertionError(
                        f"phase 20 k-means rank {rank}: counts at version "
                        f"{op['version']} off the oracle's")
            if r["done"] and r["tiers"] != ["dense16"]:
                raise AssertionError(f"phase 20 k-means rank {rank}: "
                                     f"staged {r['tiers']}")
            if any(o["replayed"] for o in r["ops"]):
                raise AssertionError(f"phase 20 k-means rank {rank}: a "
                                     f"replayed op (nobody completed the "
                                     f"op the hung rank stopped in)")
        b1[rank] = [r["launches"]["kmeans_stats_dense"] for r in recs]
        if b1[rank] != P20_B1_LIVES[rank] or any(
                r["launches"]["kmeans_stats_ell"] for r in recs):
            raise AssertionError(f"phase 20 k-means rank {rank}: B1 "
                                 f"launches by life {b1[rank]}, want "
                                 f"{P20_B1_LIVES[rank]}")
    starts = {rank: [r.get("start_version") for r in recs]
              for rank, recs in lives.items()}
    if starts != {0: [0], 1: [0, 1], 2: [0]}:
        raise AssertionError(f"phase 20 k-means: checkpoints loaded by "
                             f"rank and life {starts}")
    log(f"    k-means: final centroids on every rank bit for bit phase "
        f"17's; counts of every iteration each life ran equal the "
        f"oracle's; no op replayed; B1 launches by rank and life "
        f"{[b1[r] for r in range(W3_RANKS)]}; versions loaded "
        f"{[starts[r] for r in range(W3_RANKS)]}")
    _hang_timeline("kmeans", result["kmeans"])
    _recovery_times("kmeans", lives)

    # (b) GBDT
    lives = result["gbdt"]["lives"]
    hung, _v, stopped_at = P20_RUNS["gbdt"]
    finals = [lives[r][-1] for r in range(W3_RANKS)]
    trees = finals[0]["trees"]
    if any(f["trees"] != trees for f in finals) or \
            trees != w3["f32_trees"]:
        raise AssertionError("phase 20 GBDT: the trees differ from phase "
                             "17's float32-kernel trees")
    n = sum(f["rows"] for f in finals)
    losses = [sum(f["loss_sums"][i] for f in finals) / n
              for i in range(W3_GB_ROUNDS)]
    if losses != w3["f32_losses"]:
        raise AssertionError(f"phase 20 GBDT: log-loss {losses} vs phase "
                             f"17's {w3['f32_losses']}")
    second = lives[hung][1]

    def seq_map(recs, version):
        return [(o["kind"], o["seq"], o["nbytes"]) for r in recs
                for o in r["ops"] if o["version"] == version]
    survivor = next(r for r in range(W3_RANKS) if r != hung)
    replayed = [(o["version"], o["seq"]) for o in second["ops"]
                if o["replayed"]]
    if seq_map([second], 0) or seq_map([second], 1) != seq_map(
            lives[survivor], 1) or replayed != [(1, 0), (1, 1)] or any(
            o["replayed"] for r in range(W3_RANKS) for life in lives[r]
            if life is not second for o in life["ops"]):
        raise AssertionError(
            f"phase 20 GBDT: the relaunched rank's ops "
            f"{seq_map([second], 1)}"
            f" at version 1 (survivors' {seq_map(lives[survivor], 1)}), "
            f"replayed {replayed}")
    chunks = finals[0]["level_chunks"]
    b3 = {r: [life["launches"]["gbdt_hist"] for life in lives[r]]
          for r in range(W3_RANKS)}
    want_b3 = {r: [sum(map(sum, chunks))] for r in range(W3_RANKS)}
    want_b3[hung] = [sum(chunks[0]) + sum(chunks[1][:stopped_at + 1]),
                     sum(chunks[1])]
    if b3 != want_b3 or any(life["launches"]["kmeans_stats_dense"]
                            for recs in lives.values() for life in recs):
        raise AssertionError(f"phase 20 GBDT: B3 launches by rank and life "
                             f"{b3}, level chunks give {want_b3}")
    log(f"    GBDT: trees node for node and log-loss "
        f"{[round(v, 6) for v in losses]} bit for bit phase 17's float32 "
        f"kernel; the relaunched rank {hung} replayed {replayed} and "
        f"issued the survivors' version-1 ops; B3 launches by rank and "
        f"life {[b3[r] for r in range(W3_RANKS)]} (level chunks {chunks})")
    _hang_timeline("gbdt", result["gbdt"])
    _recovery_times("gbdt", lives)
    log(f"    phase 20 wall {time.perf_counter() - t0:.1f} s")
    return dict(kmeans_stats_dense=[b1[r] for r in range(W3_RANKS)],
                gbdt_hist=[b3[r] for r in range(W3_RANKS)])


def _hang_timeline(which, run):
    """stop -> the launcher's verdict or stall event -> its kill -> the
    relaunched life's process start, its first op and its first fresh
    op; and each survivor's LinkError -> resumed op, all on the
    monotonic clock and from the stop."""
    lives = run["lives"]
    hung = P20_RUNS[which][0]
    first, second = lives[hung]
    stop = first["t0"] + first["marks"]["stopped"]
    kinds = {"verdict": "heartbeat verdict", "stall": "stall watchdog"}
    notes = [(kinds[e[0]], e[1]) for e in run["events"] if e[0] in kinds]
    kill = next(e[1] for e in run["events"] if e[0] == "kill")
    ops = second["ops"]
    fresh = [o for o in ops if not o["replayed"]]
    parts = [f"{notes[0][0]} +{notes[0][1] - stop:.3f} s "
             f"({len(notes)} call(s))",
             f"kill +{kill - stop:.3f} s",
             f"relaunched process start +{second['t0'] - stop:.3f} s",
             f"its first op +{second['t0'] + ops[0]['issued'] - stop:.3f} s"]
    if fresh:
        parts.append(f"its first fresh op (v{fresh[0]['version']} seq "
                     f"{fresh[0]['seq']}) +"
                     f"{second['t0'] + fresh[0]['issued'] - stop:.3f} s")
    log(f"    {which} hang: rank {hung} stopped at v"
        f"{first['stopped'][0]} seq {first['stopped'][1]} -> "
        + " -> ".join(parts))
    for rank, recs in sorted(lives.items()):
        if rank == hung:
            continue
        for e in recs[0]["episodes"]:
            log(f"    {which} survivor rank {rank}: LinkError "
                f"+{recs[0]['t0'] + e['t_err'] - stop:.3f} s after the "
                f"stop -> {e['op']} v{e['version']} seq {e['seq']} resumed "
                f"+{recs[0]['t0'] + e['resumed'] - stop:.3f} s (recover "
                f"rendezvous {e['rendezvous']:.3f} s, serving "
                f"{e['serving'] * 1e3:.3f} ms)")


# ------------------------------------------- the durable tier at world 3
# Phase 21's kill-alls: every rank SIGKILLs itself once right after the
# commit of this version, once all three have committed it.
P21_KILL = {"kmeans": 2, "gbdt": 1}
P21_KEEP = 3                       # rabit_ckpt_keep's default
P21_MAX_RESTARTS = 3
# B1 launches by life: the first life runs iterations 1-2, the second,
# loading version 2 from disk, iteration 3
P21_B1_LIVES = [2, 1]


def fs_type(path):
    """The filesystem type (and mount point) that ``path`` sits on: the
    longest mount point in /proc/mounts that holds it."""
    path = os.path.realpath(path)
    best = ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            _dev, mnt, fstype = line.split()[:3]
            mnt = mnt.replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return f"{best[1]} (mounted at {best[0]})"


class _RegLog:
    """Times, on the monotonic clock, of every start/recover
    registration the port's tracker takes during one launch (it runs in
    this process, inside ``launch``)."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        from rabit_tpu_torch.tracker import tracker as tr

        self._cls, self._real = tr.JobState, tr.JobState.register
        real, events = self._real, self.events

        def register(job, sock, cmd, task_id, host, port):
            events.append((time.monotonic(), task_id, cmd))
            return real(job, sock, cmd, task_id, host, port)
        tr.JobState.register = register
        return self

    def __exit__(self, *exc):
        self._cls.register = self._real


def _check_store(which, root, final_version):
    """The store after a phase-21 job: every candidate blob CRC-valid,
    every manifest parses, the newest P21_KEEP versions and no other on
    each of the three writers, no tmp file left.  Returns the scan."""
    from rabit_tpu_torch.ckpt import CheckpointStore

    names = os.listdir(root)
    for name in (n for n in names if n.startswith("manifest")):
        with open(os.path.join(root, name)) as f:
            json.load(f)
    scan = CheckpointStore(root, rank=W3_RANKS).scan()
    per_writer = {}
    for e in scan:
        per_writer.setdefault(e["writer"], []).append(e["version"])
    want = list(range(final_version, max(final_version - P21_KEEP, 0), -1))
    if (not all(e["valid"] for e in scan)
            or sorted(per_writer) != list(range(W3_RANKS))
            or any(sorted(v, reverse=True) != want
                   for v in per_writer.values())
            or any(".tmp." in n for n in names)):
        raise AssertionError(f"phase 21 {which}: store {sorted(names)}, "
                             f"scan {scan}")
    return scan


def _check_lives(which, lives):
    """Two lives a rank: the first killed right after P21_KILL[which]'s
    commit, the second relaunched (same RABIT_NUM_TRIAL) and resumed at
    that version through the cold path, from its disk; nothing replayed.
    Returns the rank that served the disk version."""
    kill = P21_KILL[which]
    got = {r: len(lives.get(r, [])) for r in range(W3_RANKS)}
    if got != {r: 2 for r in range(W3_RANKS)}:
        raise AssertionError(f"phase 21 {which}: lives by rank {got}, "
                             f"want 2 each")
    roots = set()
    for rank, recs in sorted(lives.items()):
        first, second = recs
        cold = second["cold"] or {}
        if (first["engine"] != "PyRobustEngine" or first["done"]
                or first.get("sigkilled") != kill or first["relaunched"]
                or first.get("start_version") != 0
                or not second["done"] or "sigkilled" in second
                or not second["relaunched"]
                or (second["trial"], second["relaunch"]) != (0, 1)
                or second.get("start_version") != kill
                or cold.get("version") != kill
                or cold.get("disk_version") != kill
                or any(o["replayed"] for r in recs for o in r["ops"])):
            summary = [(r["trial"], r["relaunch"], r["done"],
                        r.get("sigkilled"), r["relaunched"],
                        r.get("start_version")) for r in recs]
            raise AssertionError(f"phase 21 {which} rank {rank}: lives "
                                 f"{summary}, cold load {cold}")
        roots.add(cold.get("root"))
    if len(roots) != 1 or None in roots:
        raise AssertionError(f"phase 21 {which}: served by {roots}")
    return roots.pop()


def phase21(torch, w3):
    """Phase 21: k-means and GBDT at world 3 over ``pyrobust`` with the
    durable tier, every rank killed once right after a commit, so the
    relaunched world resumes from disk (see ``_durable_probe``).
    Returns B1's and B3's launches by rank and life."""
    from rabit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = [_build.library_path(n) for n in ("kmeans_stats_dense",
                                             "histogram")]
    stamps = [p.stat().st_mtime_ns for p in libs]
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[21] the durable tier at world {W3_RANKS}: "
            f"launch_local.launch({W3_RANKS}, ..., ckpt_dir=..., "
            f"max_restarts={P21_MAX_RESTARTS}); every rank a writer, "
            f"rabit_ckpt_keep {P21_KEEP}; the store on {fs_type(tmp)}; "
            f"k-means dense16 {MAIN_ROWS} x 256, {W3_KM_ITERS} iterations, "
            f"heartbeat_sec={P20_HEARTBEAT_SEC}, every rank killed after "
            f"version {P21_KILL['kmeans']}'s commit; boosting.train "
            f"{GBDT_ROWS} x {GBDT_FEATURES}, {W3_GB_ROUNDS} rounds, float32 "
            f"kernel, every rank killed after version {P21_KILL['gbdt']}'s")
        for which in P21_KILL:
            store = os.path.join(tmp, "ckpt." + which)
            kw = dict(ckpt_dir=store, max_restarts=P21_MAX_RESTARTS)
            if which == "kmeans":
                kw["heartbeat_sec"] = P20_HEARTBEAT_SEC
            with _RegLog() as rl:
                code, secs = _launch_ranks("21", which, tmp, **kw)
            lives = _rank_lives(tmp, which)
            if code != 0:
                raise AssertionError(f"phase 21 {which}: the launcher "
                                     f"returned {code}")
            root = _check_lives(which, lives)
            scan = _check_store(which, store,
                                W3_KM_ITERS if which == "kmeans"
                                else W3_GB_ROUNDS)
            result[which] = dict(lives=lives, seconds=secs,
                                 regs=list(rl.events))
            log(f"    {which}: launcher returned 0 in {secs:.1f} s; two "
                f"lives a rank; the relaunched world loaded version "
                f"{P21_KILL[which]} from disk, served by rank {root}; store "
                f"valid ({len(scan)} blobs, {P21_KEEP} a writer)")
    if [p.stat().st_mtime_ns for p in libs] != stamps:
        raise AssertionError("phase 21: a rank process rebuilt a kernel")

    # (a) k-means
    lives = result["kmeans"]["lives"]
    want_cent = np.asarray(w3["centroids"], np.float32)
    oracle = np.asarray(w3["oracle_counts"])
    b1 = {}
    for rank, recs in sorted(lives.items()):
        cent = np.asarray(recs[-1]["centroids"], np.float32)
        if not np.array_equal(cent, want_cent):
            raise AssertionError(
                f"phase 21 k-means rank {rank}: final centroids off phase "
                f"17's by {float(np.abs(cent - want_cent).max())}")
        for r in recs:
            for op in (o for o in r["ops"] if "counts" in o):
                if op["counts"] != oracle[op["version"]].tolist():
                    raise AssertionError(
                        f"phase 21 k-means rank {rank}: counts at version "
                        f"{op['version']} off the oracle's")
        if recs[-1]["tiers"] != ["dense16"]:
            raise AssertionError(f"phase 21 k-means rank {rank}: staged "
                                 f"{recs[-1]['tiers']}")
        b1[rank] = [r["launches"]["kmeans_stats_dense"] for r in recs]
        if b1[rank] != P21_B1_LIVES or any(
                r["launches"]["kmeans_stats_ell"] for r in recs):
            raise AssertionError(f"phase 21 k-means rank {rank}: B1 "
                                 f"launches by life {b1[rank]}, want "
                                 f"{P21_B1_LIVES}")
    log(f"    k-means: final centroids on every rank bit for bit phase "
        f"17's; counts of every iteration each life ran equal the "
        f"oracle's; B1 launches by rank and life "
        f"{[b1[r] for r in range(W3_RANKS)]}")
    _durable_times("kmeans", result["kmeans"], w3["kmeans_walls"])

    # (b) GBDT
    lives = result["gbdt"]["lives"]
    finals = [lives[r][-1] for r in range(W3_RANKS)]
    trees = finals[0]["trees"]
    if any(f["trees"] != trees for f in finals) or \
            trees != w3["f32_trees"]:
        raise AssertionError("phase 21 GBDT: the trees differ from phase "
                             "17's float32-kernel trees")
    n = sum(f["rows"] for f in finals)
    losses = [sum(f["loss_sums"][i] for f in finals) / n
              for i in range(W3_GB_ROUNDS)]
    if losses != w3["f32_losses"]:
        raise AssertionError(f"phase 21 GBDT: log-loss {losses} vs phase "
                             f"17's {w3['f32_losses']}")
    second_ops = [[(o["kind"], o["version"], o["seq"], o["nbytes"])
                   for o in lives[r][1]["ops"]] for r in range(W3_RANKS)]
    if any(ops != second_ops[0] for ops in second_ops) or any(
            o[0] != "allreduce" or o[1] != P21_KILL["gbdt"]
            for o in second_ops[0]):
        raise AssertionError(f"phase 21 GBDT: the relaunched lives' ops "
                             f"{second_ops}")
    chunks = finals[0]["level_chunks"]
    b3 = {r: [life["launches"]["gbdt_hist"] for life in lives[r]]
          for r in range(W3_RANKS)}
    want_b3 = [sum(chunks[0]), sum(chunks[1])]
    if any(b3[r] != want_b3 for r in range(W3_RANKS)) or any(
            life["launches"]["kmeans_stats_dense"]
            for recs in lives.values() for life in recs):
        raise AssertionError(f"phase 21 GBDT: B3 launches by rank and life "
                             f"{b3}, level chunks give {want_b3}")
    log(f"    GBDT: trees node for node and log-loss "
        f"{[round(v, 6) for v in losses]} bit for bit phase 17's float32 "
        f"kernel; the relaunched lives issued only version-1 allreduces "
        f"(no cuts broadcast, no vote); B3 launches by rank and life "
        f"{[b3[r] for r in range(W3_RANKS)]} (level chunks {chunks})")
    _durable_times("gbdt", result["gbdt"], w3["f32_walls"])
    log(f"    phase 21 wall {time.perf_counter() - t0:.1f} s")
    return dict(kmeans_stats_dense=[b1[r] for r in range(W3_RANKS)],
                gbdt_hist=[b3[r] for r in range(W3_RANKS)])


def _durable_times(which, run, p17_walls):
    """Phase 21's times: each commit's persist on each writer; the last
    death -> every relaunch registered; each relaunch's start -> cold
    load -> first fresh op; the job against phase 17's."""
    lives = run["lives"]
    for rank, recs in sorted(lives.items()):
        for i, r in enumerate(recs):
            per = ", ".join(f"v{p['version']} {p['ms']:.3f} ms "
                            f"{p['bytes']} B" for p in r["persists"])
            log(f"      {which} rank {rank} life {i + 1}: persists {per}")
    deaths = sorted(recs[0]["t0"] + recs[0]["marks"]["killed"]
                    for recs in lives.values())
    regs = [(t, task, cmd) for t, task, cmd in run["regs"]
            if t > deaths[-1]]
    log(f"    {which}: the three deaths within "
        f"{(deaths[-1] - deaths[0]) * 1e3:.3f} ms; last death -> "
        + ", ".join(f"task {task} registered ({cmd}) +{t - deaths[-1]:.3f} s"
                    for t, task, cmd in regs)
        + " (the tracker's orphan GC needs 30 s of idleness)")
    for rank, recs in sorted(lives.items()):
        r = recs[1]
        c, m = r["cold"], r["marks"]
        fresh = [o for o in r["ops"] if not o["replayed"]]
        log(f"      {which} rank {rank} relaunch: start "
            f"+{r['t0'] - deaths[-1]:.3f} s after the last death; from its "
            f"start: torch {m['torch']:.3f} s, CUDA {m['cuda']:.3f} s, "
            f"registered (init) {m['init']:.3f} s, rows {m['data']:.3f} s, "
            f"cold load {c['start']:.3f} -> {c['end']:.3f} s ({c['ms']:.3f}"
            f" ms: disk read {c['disk_ms']:.3f} ms of v{c['disk_version']}, "
            f"{c['nbytes']} B served by rank {c['root']}), "
            f"{'staged' if which == 'kmeans' else 'binned'} "
            f"{m['staged']:.3f} s, first fresh op "
            f"{fresh[0]['issued'] if fresh else float('nan'):.3f} s, done "
            f"{m['end']:.3f} s")
    runs = [[round(r["marks"]["end" if "end" in r["marks"] else "killed"]
                   - r["marks"]["data"], 3) for r in recs]
            for _rank, recs in sorted(lives.items())]
    log(f"    {which}: the job {run['seconds']:.1f} s under the launcher "
        f"(process starts and the kill-all included); by rank, each "
        f"life's run from its rows to its end or its kill {runs} s; phase "
        f"17's run() by rank {[round(x, 3) for x in p17_walls]} s")


# --------------------------------------------------------------- phase 22
P22_ITERS = 4                      # k-means iterations: versions 1..4
P22_HEARTBEAT_SEC = 0.5
P22_KILL_VERSION = 1               # (a) rank 2 dies right after this commit
P22_HOLD_VERSION = 1               # (b) the joiner starts after this commit
# B1 launches by (epoch, world): (a) iteration 1 at world 3, 2-4 at world
# 2; (b) iterations 1-2 at world 2 (the grow lands at version 2's
# commit), 3-4 at world 3
P22_B1 = {"shrink": {"survivor": [[0, 3, 1], [1, 2, 3]],
                     "leaver": [[0, 3, 1]]},
          "grow": {"survivor": [[0, 2, 2], [1, 3, 2]],
                   "joiner": [[1, 3, 2]]}}


def elastic_picks(shards, k):
    """The global rows ``init_centroids`` seeds each centroid from when
    the rows are dealt out as ``shards`` (each rank's row ids, in
    order): each rank draws k rows of its own shard and then k roots
    from one generator of seed 0, and centroid i is root i's row i (as
    ``world3_picks``, for any shards)."""
    rows, roots = [], []
    for shard in shards:
        draw = np.random.default_rng(0)
        rows.append([int(draw.integers(len(shard))) for _ in range(k)])
        roots.append([int(draw.integers(len(shards))) for _ in range(k)])
    if any(rt != roots[0] for rt in roots):
        raise AssertionError("init_centroids' roots differ between shards")
    return [int(shards[roots[0][i]][rows[roots[0][i]][i]]) for i in range(k)]


def _gather_rows(data, rows):
    """Rows ``rows`` (ascending ids) of a SparseMat of rows with equal
    slot counts."""
    from rabit_tpu_torch.learn.data import SparseMat

    nnz = int(data.indptr[1] - data.indptr[0])
    rows = np.asarray(rows, np.int64)
    return SparseMat(indptr=np.arange(len(rows) + 1, dtype=np.int64) * nnz,
                     findex=data.findex.reshape(-1, nnz)[rows].reshape(-1),
                     fvalue=data.fvalue.reshape(-1, nnz)[rows].reshape(-1),
                     labels=data.labels[rows], feat_dim=data.feat_dim)


def elastic_rank(job, out_dir, task=None, port=None):
    """One rank process of phase 22 (``chip_smoke.py --phase22-rank
    shrink DIR`` under the port's launcher, or ``--phase22-grow TASK
    PORT DIR`` against the script's tracker): the elastic app loop of
    ``tests/workers/elastic_worker.py`` around ``kmeans.run`` on phase
    5's dense16 rows.  It re-shards with ``splitrows.rows_for_rank`` for
    its (rank, world), runs ``kmeans.run`` (which loads the committed
    version and stages its rows, dense16, B1), and on
    ``WorldChangedError`` does it again for the new world.  (a) The
    world-3 rank 2 SIGKILLs itself right after version 1's commit;
    (b) the first two ranks hold after version 1's commit while the
    file ``hold.grow`` exists.  Records (loads, rescales, every stats
    allreduce's row count, B1 launches by world, the times) go to DIR as
    ``JOB.TASK.json``, also just before the kill; (b) prints it too."""
    marks = {}
    import torch

    marks["torch"] = since_start()
    if not torch.cuda.is_available():
        raise RuntimeError("the phase-22 ranks run on the card")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda"] = since_start()
    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch import engine as engine_mod
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.learn import splitrows
    from rabit_tpu_torch.ops import kmeans_kernel as kk

    torch.backends.cuda.matmul.allow_tf32 = False
    params = {"rabit_timeout_sec": W3_TIMEOUT}
    if port is not None:
        params.update(rabit_tracker_uri="127.0.0.1", rabit_tracker_port=port,
                      rabit_task_id=task, rabit_world_size=2, rabit_elastic=1,
                      rabit_heartbeat_sec=P22_HEARTBEAT_SEC,
                      rabit_ckpt_dir=os.path.join(out_dir, "ckpt." + job))
    rabit_tpu_torch.init(**params)
    marks["init"] = since_start()
    eng = engine_mod.get_engine()
    task = task if task is not None else os.environ["RABIT_TASK_ID"]
    with open(os.path.join(out_dir, f"picks.{job}.json")) as f:
        picks = json.load(f)
    rec = dict(job=job, task=task, first=[eng.epoch, eng.world_size,
                                          eng.rank],
               engine=type(eng).__name__, marks=marks, loads=[],
               rescales=[], counts=[], b1=[], rows_s=[], stage_s=[],
               tiers=[], ell=0, done=False, t0=_STARTED[0], pid=os.getpid())
    path = os.path.join(out_dir, f"{job}.{task}.json")
    # (epoch, world, rank) of the world this life runs in, and B1's
    # count when it began
    world = [eng.epoch, eng.world_size, eng.rank,
             kk.LAUNCHES["kmeans_stats_dense"]]

    def close_world():
        now = kk.LAUNCHES["kmeans_stats_dense"]
        rec["b1"].append(world[:3] + [now - world[3]])
        world[:] = [eng.epoch, eng.world_size, eng.rank, now]

    def dump():
        rec["ell"] = kk.LAUNCHES["kmeans_stats_ell"]
        with open(path, "w") as f:
            json.dump(rec, f)

    real = {name: getattr(eng, name) for name in (
        "_allreduce_blocking", "checkpoint", "load_checkpoint")}

    def allreduce(buf, *a, **k):
        version = eng._version
        out = real["_allreduce_blocking"](buf, *a, **k)
        if buf.ndim == 2:
            # the stats' count column: every row counted once at any
            # world is the exact-partition proof
            rec["counts"].append([eng.epoch, eng.world_size, version, int(
                np.asarray(out[:, -1], np.float64).sum())])
        return out

    hold = os.path.join(out_dir, "hold." + job)

    def checkpoint(*a, **k):
        real["checkpoint"](*a, **k)
        if job == "shrink" and rec["first"][2] == 2 and \
                eng._version == P22_KILL_VERSION:
            close_world()
            rec["killed"] = eng._version
            marks["killed"] = since_start()
            dump()
            os.kill(os.getpid(), signal.SIGKILL)
        if job == "grow" and eng._version == P22_HOLD_VERSION and \
                os.path.exists(hold):
            marks["held"] = since_start()
            open(os.path.join(out_dir, f"held.{job}.{task}"), "w").close()
            deadline = time.monotonic() + W3_TIMEOUT
            while os.path.exists(hold) and time.monotonic() < deadline:
                time.sleep(0.01)
            marks["released"] = since_start()

    def load_checkpoint():
        out = real["load_checkpoint"]()
        rec["loads"].append([eng.epoch, eng.world_size, eng.rank, out[0],
                             since_start()])
        return out

    eng._allreduce_blocking = allreduce
    eng.checkpoint = checkpoint
    eng.load_checkpoint = load_checkpoint
    real_prepare = km.prepare_shard

    def dense16(*a, **k):
        t = time.perf_counter()
        staged = real_prepare(*a, budget=0, **k)    # as phase 17
        torch.cuda.synchronize()
        rec["tiers"].append(staged[0])
        rec["stage_s"].append(time.perf_counter() - t)
        return staged
    km.prepare_shard = dense16

    data = sparse_clusters(MAIN_ROWS, 256, 32, K, seed=7, picks=picks)
    marks["data"] = since_start()
    while True:
        try:
            t = time.perf_counter()
            rows = splitrows.rows_for_rank(MAIN_ROWS, eng.rank,
                                           eng.world_size)
            rec["rows_s"].append(time.perf_counter() - t)
            shard = _gather_rows(data, rows)
            del rows
            model = km.run(shard, K, P22_ITERS, compute_dtype="bfloat16")
            torch.cuda.synchronize()
            break
        except rabit_tpu_torch.WorldChangedError as e:
            close_world()
            rec["rescales"].append([e.old_world, e.new_world, e.epoch,
                                    eng.version_number, since_start()])
            shard = None
    close_world()
    marks["end"] = since_start()
    rec.update(done=True, version=eng.version_number,
               centroids=model.centroids.tolist())
    dump()
    rabit_tpu_torch.finalize()
    if port is not None:
        print(json.dumps(rec), flush=True)
    return 0


class _TrackerLog:
    """Times, on the monotonic clock, of the port's tracker's liveness
    events and of each completed round's epoch and world, for the
    trackers in this process (the launcher's, inside ``launch``, and the
    script's own)."""

    def __init__(self):
        self.live, self.rounds = [], []

    def __enter__(self):
        from rabit_tpu_torch.tracker import tracker as tr

        self._cls = tr.JobState
        self._real = (tr.JobState._emit_liveness, tr.JobState._finish_round)
        emit, finish = self._real
        live, rounds = self.live, self.rounds

        def emit_liveness(job, phase, task_id, **fields):
            live.append((time.monotonic(), phase, task_id))
            return emit(job, phase, task_id, **fields)

        def finish_round(job):
            before = job._epoch
            finish(job)
            if job._epoch != before:
                rounds.append((time.monotonic(), job._epoch, job.n_workers))
        tr.JobState._emit_liveness = emit_liveness
        tr.JobState._finish_round = finish_round
        return self

    def __exit__(self, *exc):
        self._cls._emit_liveness, self._cls._finish_round = self._real


def elastic_oracle(torch, km, picks):
    """Phase 5's plain device loop over all the rows, from the centroids
    ``init_centroids`` seeds from ``picks``, for P22_ITERS iterations."""
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
        raise AssertionError(f"phase 22 oracle: staged {shard[0]}")
    x16, v16 = shard[2]
    out = km.device_iterations(torch.from_numpy(model.centroids).cuda(),
                               x16, v16, P22_ITERS, use_kernel=False,
                               compute_dtype="bfloat16").cpu().numpy()
    del shard, x16, v16
    torch.cuda.empty_cache()
    return out


def _elastic_records(out_dir, job):
    recs = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(job + ".") and name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            recs[r["task"]] = r
    return recs


def _check_elastic(job, recs, oracle, want):
    """Phase 22's checks on one job's records: ``want`` maps each task's
    role to (first (epoch, world), rescales as (old, new, epoch,
    version), versions loaded).  Returns B1's launches by task."""
    finals = []
    b1 = {}
    for task, r in sorted(recs.items()):
        role = want["roles"][task]
        first, rescales, loads = want[role]
        if r["first"][:2] != first:
            raise AssertionError(f"phase 22 {job} task {task}: started at "
                                 f"(epoch, world) {r['first'][:2]}")
        if [x[:4] for x in r["rescales"]] != rescales:
            raise AssertionError(f"phase 22 {job} task {task}: rescales "
                                 f"{r['rescales']}, want {rescales}")
        if [x[3] for x in r["loads"]] != loads:
            raise AssertionError(f"phase 22 {job} task {task}: loaded "
                                 f"versions {[x[3] for x in r['loads']]}, "
                                 f"want {loads}")
        for (old, new, epoch, version, _at), load in zip(r["rescales"],
                                                         r["loads"][1:]):
            if load[:4] != [epoch, new, load[2], version]:
                raise AssertionError(f"phase 22 {job} task {task}: resumed "
                                     f"{load[:4]} after the rescale to "
                                     f"world {new} at version {version}")
        for epoch, world, version, rows in r["counts"]:
            if rows != MAIN_ROWS:
                raise AssertionError(
                    f"phase 22 {job} task {task}: the stats at version "
                    f"{version}, world {world} counted {rows} rows, not "
                    f"{MAIN_ROWS}")
        if set(r["tiers"]) != {"dense16"} or r["ell"]:
            raise AssertionError(f"phase 22 {job} task {task}: staged "
                                 f"{r['tiers']}, ELL launches {r['ell']}")
        if [[e, w, n] for e, w, _rank, n in r["b1"]] != P22_B1[job][role]:
            raise AssertionError(f"phase 22 {job} task {task}: B1 launches "
                                 f"by (epoch, world, rank) {r['b1']}, want "
                                 f"{P22_B1[job][role]}")
        b1[task] = r["b1"]
        if role == "leaver":
            if r.get("killed") != P22_KILL_VERSION or r["done"]:
                raise AssertionError(f"phase 22 {job} task {task}: did not "
                                     f"die after version {P22_KILL_VERSION}")
            continue
        if not r["done"] or r["version"] != P22_ITERS:
            raise AssertionError(f"phase 22 {job} task {task}: ended at "
                                 f"version {r.get('version')}")
        finals.append(np.asarray(r["centroids"], np.float32))
    if any(not np.array_equal(c, finals[0]) for c in finals):
        raise AssertionError(f"phase 22 {job}: the ranks' centroids differ")
    err = float(np.abs(finals[0] - oracle).max())
    if not (np.isfinite(finals[0]).all() and finals[0].shape == (K, 256)
            and err <= CENT_ATOL):
        raise AssertionError(f"phase 22 {job}: centroids off the plain loop "
                             f"by {err} (bar {CENT_ATOL})")
    return b1, err


def _elastic_times(job, recs):
    for task, r in sorted(recs.items()):
        m = r["marks"]
        log(f"      {job} task {task}: from its start, torch "
            f"{m['torch']:.3f} s, CUDA {m['cuda']:.3f} s, engine init "
            f"(admitted) {m['init']:.3f} s, its rows made {m['data']:.3f} s; "
            f"rows_for_rank over {MAIN_ROWS} rows "
            f"{[round(s, 3) for s in r['rows_s']]} s; staging (dense16) "
            f"{[round(s, 3) for s in r['stage_s']]} s; loads (epoch, world, "
            f"rank, version) {[x[:4] for x in r['loads']]}; B1 by (epoch, "
            f"world, rank) {r['b1']}; "
            + (f"killed {m['killed']:.3f} s" if "killed" in m
               else f"done {m['end']:.3f} s"))


def phase22(torch, km):
    """Phase 22: elastic k-means at world 3 <-> 2 over ``pyrobust``
    (see ``elastic_rank``).  (a) Shrink: ``launch_local.launch(3, ...,
    min_workers=2, max_restarts=0, ckpt_dir=..., heartbeat_sec=0.5)``;
    the world-3 rank 2 SIGKILLs itself after version 1's commit, the
    heartbeat EOF and the launcher's elastic leave shrink the world, the
    survivors resume from version 1 in halves.  (b) Grow: two rank
    processes against the port's ``Tracker(2, max_workers=3)``; after
    version 1's commit they hold until a third, started then, has
    parked; version 2's commit lands the grow and all three resume from
    version 2.  Returns B1's launches by job, rank and world."""
    import threading

    from rabit_tpu_torch.learn import splitrows

    t0 = time.perf_counter()
    log(f"[22] elastic k-means, dense16 {MAIN_ROWS} x 256 k={K}, "
        f"{P22_ITERS} iterations, heartbeat_sec={P22_HEARTBEAT_SEC}, "
        f"rows re-sharded by splitrows.rows_for_rank | nvidia-smi: "
        f"{smi_line()}")
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        shards3 = splitrows.shard_indices(MAIN_ROWS, 3)
        t_shards = time.perf_counter() - t
        picks = {"shrink": elastic_picks(shards3, K)}
        del shards3
        shards2 = splitrows.shard_indices(MAIN_ROWS, 2)
        picks["grow"] = elastic_picks(shards2, K)
        del shards2
        for job, p in picks.items():
            with open(os.path.join(tmp, f"picks.{job}.json"), "w") as f:
                json.dump(p, f)
        log(f"    shard_indices over {MAIN_ROWS} rows (the Python stream "
            f"rows_for_rank replays): {t_shards:.3f} s")

        # (a) shrink, under the launcher; the oracles meanwhile
        launched, oracle = {}, {}
        with _TrackerLog() as tl:
            th = threading.Thread(target=lambda: launched.update(
                out=_launch_ranks("22", "shrink", tmp, min_workers=2,
                                  max_restarts=0,
                                  ckpt_dir=os.path.join(tmp, "ckpt.shrink"),
                                  heartbeat_sec=P22_HEARTBEAT_SEC)),
                daemon=True)
            th.start()
            for job in ("shrink", "grow"):
                oracle[job] = elastic_oracle(torch, km, picks[job])
            th.join(W3_TIMEOUT + 90)
        if "out" not in launched:
            raise AssertionError("phase 22 shrink: the launch failed")
        code, secs = launched["out"]
        if code != 0:
            raise AssertionError(f"phase 22 shrink: the launcher returned "
                                 f"{code}")
        recs = _elastic_records(tmp, "shrink")
        roles = {task: ("leaver" if r["first"][2] == 2 else "survivor")
                 for task, r in recs.items()}
        if sorted(roles.values()) != ["leaver", "survivor", "survivor"]:
            raise AssertionError(f"phase 22 shrink: records {roles}")
        b1, err = _check_elastic("shrink", recs, oracle["shrink"], dict(
            roles=roles, survivor=([0, 3], [[3, 2, 1, P22_KILL_VERSION]],
                                   [0, P22_KILL_VERSION]),
            leaver=([0, 3], [], [0])))
        result["shrink"] = b1
        dead = next(r for r in recs.values() if "killed" in r)
        death = dead["t0"] + dead["marks"]["killed"]
        verdict = min(at for at, phase, task in tl.live
                      if phase == "lost" and task == dead["task"]
                      and at >= death)
        landed = min(at for at, epoch, world in tl.rounds
                     if (epoch, world) == (1, 2))
        inside = max(r["t0"] + r["rescales"][0][4]
                     for r in recs.values() if r["rescales"])
        log(f"    (a) shrink: launcher returned 0 in {secs:.1f} s; rank 2 "
            f"(task {dead['task']}) SIGKILLed after version "
            f"{P22_KILL_VERSION}'s commit; death -> tracker's verdict "
            f"+{verdict - death:.3f} s -> rescale round (epoch 1, world 2) "
            f"+{landed - death:.3f} s -> both survivors caught "
            f"WorldChangedError +{inside - death:.3f} s; both resumed from "
            f"version {P22_KILL_VERSION} in halves; every stats allreduce "
            f"counted {MAIN_ROWS} rows; centroids within {err:.3g} of the "
            f"plain loop; B1 by task and (epoch, world, rank) {b1}")
        _elastic_times("shrink", recs)

        # (b) grow, against the script's own tracker
        hold = os.path.join(tmp, "hold.grow")
        open(hold, "w").close()
        timeline = {}

        def grow(ctl):
            deadline = time.monotonic() + W3_TIMEOUT
            held = [os.path.join(tmp, f"held.grow.{t}") for t in "01"]
            while not all(os.path.exists(h) for h in held):
                if ctl.failed():
                    return   # the spawner reports the failed rank
                if time.monotonic() > deadline:
                    raise AssertionError("phase 22 grow: the two ranks "
                                         "never held after version 1")
                time.sleep(0.01)
            timeline["spawned"] = time.monotonic()
            ctl.spawn("2")
            job = ctl.trackers[0]._default_job()
            while "2" not in job._joiners:
                if ctl.failed():
                    return
                if time.monotonic() > deadline:
                    raise AssertionError("phase 22 grow: the joiner never "
                                         "parked")
                time.sleep(0.01)
            timeline["parked"] = time.monotonic()
            os.remove(hold)

        t = time.perf_counter()
        with _TrackerLog() as tl:
            _run_rank_processes("--phase22-grow", 1, "22", grow, nranks=2,
                                tracker_kw=dict(max_workers=3), args=[tmp])
        grow_secs = time.perf_counter() - t
        recs = _elastic_records(tmp, "grow")
        roles = {"0": "survivor", "1": "survivor", "2": "joiner"}
        if sorted(recs) != sorted(roles):
            raise AssertionError(f"phase 22 grow: records {sorted(recs)}")
        b1, err = _check_elastic("grow", recs, oracle["grow"], dict(
            roles=roles, survivor=([0, 2], [[2, 3, 1, 2]], [0, 2]),
            joiner=([1, 3], [], [2])))
        result["grow"] = b1
        joiner = recs["2"]
        landed = min(at for at, epoch, world in tl.rounds
                     if (epoch, world) == (1, 3))
        spawned = timeline["spawned"]
        held = [recs[t]["marks"]["released"] - recs[t]["marks"]["held"]
                for t in "01"]
        log(f"    (b) grow: {grow_secs:.1f} s; the survivors held after "
            f"version {P22_HOLD_VERSION} for {[round(h, 3) for h in held]} "
            f"s; joiner "
            f"spawned -> parked +{timeline['parked'] - spawned:.3f} s -> "
            f"rescale round (epoch 1, world 3) +{landed - spawned:.3f} s -> "
            f"admitted (its init returned) "
            f"+{joiner['t0'] + joiner['marks']['init'] - spawned:.3f} s; "
            f"its load_checkpoint was "
            f"served version {joiner['loads'][0][3]}; every stats "
            f"allreduce counted {MAIN_ROWS} rows; centroids bit-identical "
            f"on the three ranks and within {err:.3g} of the plain loop; "
            f"B1 by task and (epoch, world, rank) {b1}")
        _elastic_times("grow", recs)
    log(f"    phase 22 wall {time.perf_counter() - t0:.1f} s")
    return dict(kmeans_stats_dense=result)


# ------------------------------------------- the device plane at world 3
P23_ITERS = 4                      # k-means iterations: versions 1..4
P23_HEARTBEAT_SEC = 0.5
P23_KILL_VERSION = 1               # rank 1 dies entering iteration 2's op
P23_PATHS = {0: [["device", "host", "device", "device"]],
             1: [["device"], ["host", "device", "device"]],
             2: [["device", "host", "device", "device"]]}
# B1 launches by life: rank 1's first life computed iterations 1 and 2's
# stats (the kill comes at the allreduce, after B1), its second
# iterations 2-4
P23_B1_LIVES = {0: [4], 1: [2, 3], 2: [4]}
P23_STATS_BYTES = K * 257 * 4      # 65,792 B
P23_LEVEL_BYTES = 32 * GBDT_FEATURES * (GBDT_NBIN + 1) * 2 * 4  # 4,210,688 B
P23_STEADY_REPS = 20               # back-to-back ops a size and device


def device_plane_rank(which, out_dir):
    """One rank process of phase 23 (``chip_smoke.py --phase23-rank
    WHICH DIR``), started, and restarted after its SIGKILL, by the
    port's ``launch_local.launch``: ``rabit_engine="xla"`` over
    ``pyrobust``, phase 17's job on its third of phase 17's rows —
    ``kmeans.run`` on the dense16 tier (B1), ``P23_ITERS`` iterations,
    or ``boosting.train`` with the float32 kernel (B3).  Each tensor
    allreduce is timed between two synchronizes and recorded with its
    path (device plane or degraded host), each re-formation with its
    time; k-means' rank 1 SIGKILLs itself in its first life entering
    the device allreduce at version ``P23_KILL_VERSION``.  After
    k-means, each rank times ``P23_STEADY_REPS`` allreduces back to back
    at the stats' and the largest level's sizes, on CUDA and on CPU
    tensors.  A life writes its record to DIR (also just before the
    kill)."""
    marks = {}
    import torch

    marks["torch"] = since_start()
    if not torch.cuda.is_available():
        raise RuntimeError("the phase-23 ranks run on the card")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda"] = since_start()
    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch import engine as engine_mod
    from rabit_tpu_torch.learn import boosting as gb
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.ops import SUM
    from rabit_tpu_torch.ops import histogram_kernel as hk
    from rabit_tpu_torch.ops import kmeans_kernel as kk
    from rabit_tpu_torch.parallel.mesh import local_data_slice

    torch.backends.cuda.matmul.allow_tf32 = False
    rabit_tpu_torch.init(rabit_engine="xla", rabit_inner_engine="pyrobust",
                         rabit_timeout_sec=W3_TIMEOUT)
    marks["init"] = since_start()
    eng = engine_mod.get_engine()
    rank = eng.rank
    relaunch = int(os.environ["RABIT_RELAUNCH"])
    rec = dict(which=which, rank=rank, relaunch=relaunch,
               engine=type(eng).__name__, degraded_at_init=eng._degraded,
               plane=engine_mod.is_device_plane(), marks=marks, ops=[],
               reforms=[], tiers=[], centroids={}, done=False,
               t0=_STARTED[0])
    path = os.path.join(out_dir, f"{which}.{rank}.{relaunch}.json")

    def dump():
        rec["launches"] = dict(kk.LAUNCHES, **hk.LAUNCHES)
        rec["stats"] = dict(eng.path_stats)
        rec["epoch"] = eng.device_epoch
        with open(path, "w") as f:
            json.dump(rec, f)

    real = {name: getattr(eng, name) for name in (
        "allreduce", "_host_degrade", "_maybe_reform")}

    def allreduce(buf, op, prepare_fun=None):
        if not isinstance(buf, torch.Tensor):
            return real["allreduce"](buf, op, prepare_fun)
        version = eng.version_number
        if (which == "kmeans" and rank == 1 and relaunch == 0
                and version == P23_KILL_VERSION):
            marks["killed"] = since_start()
            dump()
            os.kill(os.getpid(), signal.SIGKILL)
        before = eng.path_stats["device_ops"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["allreduce"](buf, op, prepare_fun)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        op_rec = dict(version=version,
                      bytes=buf.numel() * buf.element_size(), ms=dt * 1e3,
                      on=out.device.type,
                      path=("device" if eng.path_stats["device_ops"] > before
                            else "host"))
        if which == "kmeans":
            op_rec["counts"] = out[:, -1].tolist()
        rec["ops"].append(op_rec)
        return out

    def host_degrade(*a, **k):
        marks.setdefault("degrade", since_start())
        return real["_host_degrade"](*a, **k)

    def maybe_reform():
        epoch, t = eng.device_epoch, time.perf_counter()
        real["_maybe_reform"]()
        if eng.device_epoch != epoch:
            rec["reforms"].append(dict(
                version=eng.version_number, epoch=eng.device_epoch,
                ms=(time.perf_counter() - t) * 1e3,
                degraded=eng._degraded, backend=eng.backend))
    eng.allreduce = allreduce
    eng._host_degrade = host_degrade
    eng._maybe_reform = maybe_reform
    if which == "kmeans":
        data = sparse_clusters(MAIN_ROWS, 256, 32, K, seed=7,
                               picks=world3_picks(MAIN_ROWS, K, W3_RANKS))
        shard = _shard_rows(data, local_data_slice(rank, W3_RANKS,
                                                   MAIN_ROWS))
        del data
        marks["data"] = since_start()
        real_prepare, real_ckpt = km.prepare_shard, rabit_tpu_torch.checkpoint

        def dense16(*a, **k):
            staged = real_prepare(*a, budget=0, **k)   # as phase 17
            torch.cuda.synchronize()
            rec["tiers"].append(staged[0])
            marks.setdefault("staged", since_start())
            return staged

        def checkpoint(model, *a, **k):
            if eng.version_number + 1 in (W3_KM_ITERS, P23_ITERS):
                rec["centroids"][eng.version_number + 1] = \
                    model.centroids.tolist()
            return real_ckpt(model, *a, **k)
        km.prepare_shard = dense16
        rabit_tpu_torch.checkpoint = checkpoint
        km.run(shard, K, P23_ITERS, compute_dtype="bfloat16")
        torch.cuda.synchronize()
        # the steady cost of one op, back to back (the first op of each
        # size absorbs the ranks' skew), on CUDA and on CPU tensors
        rec["steady"] = {}
        for nbytes in (P23_STATS_BYTES, P23_LEVEL_BYTES):
            for dev in ("cuda", "cpu"):
                x = torch.ones(nbytes // 4, device=dev)
                real["allreduce"](x, SUM)
                times = []
                for _ in range(P23_STEADY_REPS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    real["allreduce"](x, SUM)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
                rec["steady"][f"{dev} {nbytes}"] = times
    else:
        x_all, y_all = gbdt_data(GBDT_ROWS, GBDT_FEATURES, seed=11)
        s = local_data_slice(rank, W3_RANKS, GBDT_ROWS)
        x, y = np.ascontiguousarray(x_all[s]), np.ascontiguousarray(y_all[s])
        del x_all, y_all
        marks["data"] = since_start()
        bins, real_apply = [], gb.apply_cuts

        def keep_bins(*a, **k):
            bins.append(real_apply(*a, **k))
            marks["staged"] = since_start()
            return bins[-1]
        gb.apply_cuts = keep_bins
        model = gb.train(x, y, num_round=W3_GB_ROUNDS, max_depth=GBDT_DEPTH,
                         nbin=GBDT_NBIN, **W3_GB_KW["f32 kernel"])
        torch.cuda.synchronize()
        losses, _acc, _pred = round_losses(model, bins[0], y)
        chunk = hk.max_channels(GBDT_NBIN + 1, GBDT_FEATURES) // 2
        rec.update(rows=len(y), loss_sums=[v * len(y) for v in losses],
                   trees=[[dataclasses.astuple(n) for n in t]
                          for t in model.trees],
                   level_chunks=[level_chunk_list(t, GBDT_DEPTH, chunk)
                                 for t in model.trees])
    marks["end"] = since_start()
    rec["done"] = True
    dump()
    rabit_tpu_torch.finalize()
    return 0


def _p23_lives(out_dir, which):
    lives = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(which + "."):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            lives.setdefault(r["rank"], []).append(r)
    for recs in lives.values():
        recs.sort(key=lambda r: r["relaunch"])
    return lives


def _p23_kmeans(lives, w3, oracle):
    """Phase 23 (a)'s checks; returns the figures it prints."""
    if sorted(lives) != [0, 1, 2] or [len(lives[r]) for r in range(3)] != \
            [1, 2, 1]:
        raise AssertionError(f"phase 23 k-means: lives "
                             f"{ {r: len(v) for r, v in lives.items()} }")
    finals = []
    for rank, recs in sorted(lives.items()):
        for life, r in enumerate(recs):
            tag = f"phase 23 k-means rank {rank} life {life + 1}"
            paths = [o["path"] for o in r["ops"]]
            if paths != P23_PATHS[rank][life]:
                raise AssertionError(f"{tag}: paths {paths}")
            if any(o["bytes"] != P23_STATS_BYTES or o["on"] != "cuda"
                   for o in r["ops"]):
                raise AssertionError(f"{tag}: ops {r['ops']}")
            for o in r["ops"]:
                it = o["version"]
                if sum(o["counts"]) != MAIN_ROWS:
                    raise AssertionError(f"{tag}: iteration {it + 1} "
                                         f"counted {sum(o['counts'])} rows")
                if it < W3_KM_ITERS and o["counts"] != \
                        w3["oracle_counts"][it]:
                    raise AssertionError(f"{tag}: iteration {it + 1}'s "
                                         "counts differ from phase 17's")
            b1 = r["launches"]["kmeans_stats_dense"]
            if b1 != P23_B1_LIVES[rank][life] or \
                    r["launches"]["kmeans_stats_ell"]:
                raise AssertionError(f"{tag}: launches {r['launches']}")
            if not r["plane"]:
                raise AssertionError(f"{tag}: is_device_plane() was False")
            if r["done"]:
                finals.append(r)
                if r["degraded_at_init"] != (life > 0):
                    raise AssertionError(f"{tag}: degraded at init "
                                         f"{r['degraded_at_init']}")
                if r["stats"]["backend"] != "gloo" or r["epoch"] != 1 or \
                        r["tiers"] != ["dense16", "dense16"]:
                    raise AssertionError(
                        f"{tag}: backend {r['stats']['backend']}, epoch "
                        f"{r['epoch']}, tiers {r['tiers']} (the ranks share "
                        "the card: gloo; one reform; staged, re-staged once)")
                if [(f["version"], f["epoch"], f["degraded"],
                     f["backend"]) for f in r["reforms"]] != \
                        [(2, 1, False, "gloo")]:
                    raise AssertionError(f"{tag}: reforms {r['reforms']}")
                if r["stats"]["host_ops"] != 1:
                    raise AssertionError(f"{tag}: {r['stats']}")
    cents = [np.asarray(r["centroids"][str(P23_ITERS)], np.float32)
             for r in finals]
    if any(not np.array_equal(c, cents[0]) for c in cents):
        raise AssertionError("phase 23 k-means: final centroids differ "
                             "between the ranks")
    err = float(np.abs(cents[0] - oracle).max())
    if not (np.isfinite(cents[0]).all() and err <= CENT_ATOL):
        raise AssertionError(f"phase 23 k-means: centroids {err} off the "
                             f"plain loop (bar {CENT_ATOL})")
    v3 = np.asarray(finals[0]["centroids"][str(W3_KM_ITERS)], np.float32)
    p17 = np.asarray(w3["centroids"], np.float32)
    if not np.allclose(v3, p17, rtol=SUM_RTOL, atol=SUM_ATOL):
        raise AssertionError(f"phase 23 k-means: version-{W3_KM_ITERS} "
                             f"centroids off phase 17's host-plane run by "
                             f"{float(np.abs(v3 - p17).max())}")
    return err, float(np.abs(v3 - p17).max())


def phase23(torch, w3, km):
    """Phase 23: the device-plane engine at world 3.  The port's
    ``launch_local.launch(3, ...)`` with ``rabit_engine="xla"`` over
    ``pyrobust`` and ``heartbeat_sec=0.5`` (see ``device_plane_rank``);
    the three rank processes share the card, so the backend must be
    gloo on CUDA tensors.  (a) ``kmeans.run`` on phase 17's dense16
    thirds, ``P23_ITERS`` iterations, rank 1 SIGKILLed entering
    iteration 2's device allreduce, ``max_restarts=1``: survivors
    degrade, the relaunch comes up degraded, checkpoint 2 re-forms the
    plane (``device_epoch`` 1 on all three), k-means re-stages once and
    the later iterations ride the device plane; counts of every
    iteration sum to the rows, iterations 1-3 equal phase 17's;
    centroids within 1e-3 of the plain loop (run here meanwhile) and,
    at version 3, within the float32 sum bar of phase 17's.  (b)
    ``boosting.train`` on phase 17's thirds, 2 rounds, float32 kernel,
    no fault: one device allreduce a level, top three levels as phase
    17's, log-loss within 1e-4.  (c) The engine's NCCL `new_group` at
    world 1 on an in-process store, one allreduce of the (64, 257)
    stats: the only NCCL code one card can run.  Returns B1's and B3's
    launches."""
    import datetime
    import threading

    import torch.distributed as dist

    from rabit_tpu_torch.engine import xla
    from rabit_tpu_torch.learn.boosting import TreeNode

    t0 = time.perf_counter()
    log(f"[23] the device-plane engine (rabit_engine=xla over pyrobust) "
        f"at world {W3_RANKS} on one card: k-means dense16 {MAIN_ROWS} x "
        f"256 k={K}, {P23_ITERS} iterations, rank 1 SIGKILLed entering "
        f"iteration 2's device allreduce; boosting.train {GBDT_ROWS} x "
        f"{GBDT_FEATURES}, {W3_GB_ROUNDS} rounds, float32 kernel | "
        f"nvidia-smi: {smi_line()}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        launched = {}
        th = threading.Thread(target=lambda: launched.update(
            out=_launch_ranks("23", "kmeans", tmp, max_restarts=1,
                              heartbeat_sec=P23_HEARTBEAT_SEC)),
            daemon=True)
        th.start()
        t = time.perf_counter()
        oracle = elastic_oracle(torch, km,
                                world3_picks(MAIN_ROWS, K, W3_RANKS))
        t_oracle = time.perf_counter() - t
        th.join(W3_TIMEOUT + 90)
        if "out" not in launched or launched["out"][0] != 0:
            raise AssertionError(f"phase 23 k-means: the launch failed "
                                 f"({launched.get('out')})")
        km_secs = launched["out"][1]
        lives = _p23_lives(tmp, "kmeans")
        err, err17 = _p23_kmeans(lives, w3, oracle)
        dead = lives[1][0]
        death = dead["t0"] + dead["marks"]["killed"]
        degrade = [lives[r][0]["t0"] + lives[r][0]["marks"]["degrade"]
                   - death for r in (0, 2)]
        relaunch = lives[1][1]
        dev_ms = [o["ms"] for r in (0, 1, 2) for o in lives[r][-1]["ops"]
                  if o["path"] == "device"]
        host_ms = [o["ms"] for r in (0, 1, 2) for o in lives[r][-1]["ops"]
                   if o["path"] == "host"]
        ring17 = [t for rank_ms in w3["ring_stats_ms"] for t in rank_ms]
        reform_ms = [lives[r][-1]["reforms"][0]["ms"] for r in (0, 1, 2)]
        log(f"    (a) k-means: launcher returned 0 in {km_secs:.1f} s (the "
            f"plain loop meanwhile {t_oracle:.1f} s); backend gloo on CUDA "
            f"tensors (the ranks share the card); iteration 1 on the "
            f"device plane on every rank, the survivors degraded at "
            f"iteration 2, the relaunch came up degraded, checkpoint 2 "
            f"re-formed the plane (device_epoch 1 on all three, k-means "
            f"re-staged once), iterations 3-4 on the device plane; every "
            f"stats allreduce counted {MAIN_ROWS} rows, iterations 1-3 "
            f"phase 17's counts; centroids within {err:.3g} of the plain "
            f"loop, version 3 within {err17:.3g} of phase 17's; B1 by "
            f"rank and life "
            f"{ {r: [x['launches']['kmeans_stats_dense'] for x in v] for r, v in lives.items()} }")
        log(f"    (a) the ({K}, 257) float32 stats ({P23_STATS_BYTES} B): "
            f"device allreduce (gloo on CUDA tensors, synchronize to "
            f"synchronize) median {statistics.median(dev_ms):.3f} ms over "
            f"{len(dev_ms)} ops {[round(t, 3) for t in dev_ms]}, degraded "
            f"host op {[round(t, 3) for t in host_ms]} ms; phase 17's "
            f"host-plane allreduce median {statistics.median(ring17):.3f} ms "
            f"(PySocketEngine, its copy to the host apart)")
        steady = {key: statistics.median(
            t for r in (0, 1, 2) for t in lives[r][-1]["steady"][key])
            for key in lives[0][0]["steady"]}
        log(f"    (a) back to back, {P23_STEADY_REPS} ops a size after "
            f"k-means (median over the ranks): gloo on CUDA tensors "
            f"{steady[f'cuda {P23_STATS_BYTES}']:.3f} ms ({P23_STATS_BYTES}"
            f" B) and {steady[f'cuda {P23_LEVEL_BYTES}']:.3f} ms "
            f"({P23_LEVEL_BYTES} B); on CPU tensors "
            f"{steady[f'cpu {P23_STATS_BYTES}']:.3f} ms and "
            f"{steady[f'cpu {P23_LEVEL_BYTES}']:.3f} ms")
        log(f"    (a) rank 1 SIGKILLed -> survivors degraded +"
            f"{degrade[0]:.3f} s / +{degrade[1]:.3f} s; relaunch start -> "
            f"degraded registration (engine init returned) "
            f"{relaunch['marks']['init']:.3f} s (torch {relaunch['marks']['torch']:.3f}"
            f" s, CUDA {relaunch['marks']['cuda']:.3f} s of it); reform at "
            f"checkpoint 2 by rank {[round(t, 3) for t in reform_ms]} ms")
        out["kmeans_stats_dense"] = {
            str(r): [x["launches"]["kmeans_stats_dense"] for x in v]
            for r, v in lives.items()}
        out["stats_ms"] = dev_ms

        # (b) GBDT, no fault
        code, gb_secs = _launch_ranks("23", "gbdt", tmp,
                                      heartbeat_sec=P23_HEARTBEAT_SEC)
        if code != 0:
            raise AssertionError(f"phase 23 gbdt: the launcher returned "
                                 f"{code}")
        glives = _p23_lives(tmp, "gbdt")
        ranks = [glives[r][0] for r in range(W3_RANKS)]
        want_top = [top_levels([TreeNode(*n) for n in t], 3)
                    for t in w3["f32_trees"]]
        for g in ranks:
            tag = f"phase 23 gbdt rank {g['rank']}"
            levels = sum(sum(1 for c in lc if c) for lc in g["level_chunks"])
            paths = [o["path"] for o in g["ops"]]
            if paths != ["device"] * levels or g["stats"]["host_ops"] or \
                    g["stats"]["backend"] != "gloo":
                raise AssertionError(f"{tag}: {len(paths)} tensor allreduces "
                                     f"{set(paths)} for {levels} levels, "
                                     f"{g['stats']}")
            got = g["launches"]["gbdt_hist"]
            if got != sum(map(sum, g["level_chunks"])):
                raise AssertionError(f"{tag}: {got} B3 launches for level "
                                     f"chunks {g['level_chunks']}")
            top = [top_levels([TreeNode(*n) for n in t], 3)
                   for t in g["trees"]]
            if top != want_top:
                raise AssertionError(f"{tag}: top levels {top} vs phase "
                                     f"17's {want_top}")
        n = sum(g["rows"] for g in ranks)
        losses = [sum(g["loss_sums"][i] for g in ranks) / n
                  for i in range(W3_GB_ROUNDS)]
        rel = max(abs(a - b) / b for a, b in zip(losses, w3["f32_losses"]))
        if rel > 1e-4:
            raise AssertionError(f"phase 23 gbdt: log-loss {losses} vs phase "
                                 f"17's {w3['f32_losses']}")
        big = [[o["ms"] for o in g["ops"] if o["bytes"] == P23_LEVEL_BYTES]
               for g in ranks]
        log(f"    (b) GBDT: launcher returned 0 in {gb_secs:.1f} s; one "
            f"device allreduce a level on every rank, top three levels of "
            f"both trees phase 17's, log-loss by round "
            f"{[round(v, 6) for v in losses]} within {rel:.3g} relative; "
            f"B3 by rank {[g['launches']['gbdt_hist'] for g in ranks]}; "
            f"the largest level ({P23_LEVEL_BYTES} B) device allreduce by "
            f"rank {[[round(t, 3) for t in b] for b in big]} ms, phase 17's "
            f"host-plane one {[round(t, 3) for t in w3['f32_level_ms']]} ms")
        out["gbdt_hist"] = [g["launches"]["gbdt_hist"] for g in ranks]

    # (c) NCCL at world 1 on the card
    if xla.backend_for([xla.device_identity()]) != "nccl":
        raise AssertionError("phase 23 nccl: a card of its own is not nccl")
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          timeout=datetime.timedelta(seconds=60),
                          wait_for_workers=False)
    group = xla.new_group(dist.PrefixStore("p23/", store), 0, 1, "nccl",
                          datetime.timedelta(seconds=60))
    stats = torch.randn(K, 257, device="cuda")
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    x = stats.clone()
    group.allreduce([x], opts).wait()
    torch.cuda.synchronize()
    if not torch.equal(x, stats):
        raise AssertionError("phase 23 nccl: world-1 allreduce changed the "
                             "stats")
    nccl_ms = time_ms(torch, lambda: group.allreduce([x], opts).wait())
    group.abort()
    del group, store
    log(f"    (c) NCCL group from the engine's new_group at world 1: one "
        f"({K}, 257) allreduce returned its input; {nccl_ms:.4f} ms a "
        f"call (median of 5); multi-card NCCL stays unverified here")
    log(f"    phase 23 wall {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------- the linear learner and adopt/mixed modes
P24_DEVICE = "cuda"                # where phase 24 runs the learners
P24_FEATURES = 1 << 20             # a hashed feature space
P24_NNZ = 32                       # the ELL k-means shard's slots a row
P24_SEED = 24
P24_PARAMS = dict(objective="logistic", reg_L2="1", row_block="1024",
                  max_lbfgs_iter="10", silent="1")
P24_GROUP_SEC = 120                # the torch.distributed groups' timeout
P24_RAISE_SEC = 30.0               # death -> survivors' RuntimeError bar
P24_KILL_ITER = 2                  # rank 1 dies entering this iteration's
                                   # gradient allreduce
P24_DEATH_ROWS = MAIN_ROWS // 8    # the death comes at iteration 2: no
                                   # need for (a)'s full rows
P24_KM_ITERS = 4
# world 3 against world 1: f32 sums in another order (shards, then a
# float64 sum of three), so the objective within the float32 bar and the
# weights within the reference's own distributed bar
# (tests/test_learn_dist.py)
P24_OBJ_RTOL = SUM_RTOL
P24_W_TOL = dict(rtol=1e-3, atol=1e-3)


def linear_rows(n=MAIN_ROWS, nnz=P24_NNZ, nf=P24_FEATURES, seed=P24_SEED):
    """A SparseMat of n rows of nnz hashed features in [0, nf) with
    normal values, labelled from a planted logistic model (labels drawn
    from its probabilities), from ``seed``."""
    from rabit_tpu_torch.learn.data import SparseMat

    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(nf).astype(np.float32)
    idx = np.empty((n, nnz), np.int32)
    val = np.empty((n, nnz), np.float32)
    labels = np.empty(n, np.float32)
    block = 1 << 20
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        idx[lo:hi] = rng.integers(0, nf, (hi - lo, nnz), dtype=np.int32)
        val[lo:hi] = rng.standard_normal((hi - lo, nnz), np.float32)
        margin = (w_true[idx[lo:hi]] * val[lo:hi]).sum(1)
        labels[lo:hi] = rng.random(hi - lo) < 1.0 / (1.0 + np.exp(-margin))
    return SparseMat(indptr=np.arange(n + 1, dtype=np.int64) * nnz,
                     findex=idx.reshape(-1), fvalue=val.reshape(-1),
                     labels=labels, feat_dim=nf)


def _take_rows(data, rows):
    """Rows ``rows`` (any order) of a SparseMat of equal-length rows."""
    from rabit_tpu_torch.learn.data import SparseMat

    nnz = int(data.indptr[1] - data.indptr[0])
    rows = np.asarray(rows, np.int64)
    return SparseMat(indptr=np.arange(len(rows) + 1, dtype=np.int64) * nnz,
                     findex=data.findex.reshape(-1, nnz)[rows].reshape(-1),
                     fvalue=data.fvalue.reshape(-1, nnz)[rows].reshape(-1),
                     labels=data.labels[rows], feat_dim=data.feat_dim)


def _sync(torch):
    if P24_DEVICE == "cuda":
        torch.cuda.synchronize()


def linear_objective(data, device=P24_DEVICE):
    """Phase 24's objective on ``data``: P24_PARAMS on ``device``, with
    every eval, gradient and iteration timed on the host clock (each
    ends in a copy to the host, so the device has finished)."""
    from rabit_tpu_torch.learn.linear import LinearObjFunction

    obj = LinearObjFunction()
    obj.dtrain = data
    for k, v in dict(P24_PARAMS, linear_device=device).items():
        obj.set_param(k, v)
    obj.times = dict(eval=[], grad=[], iter=[])
    obj.objvals = []
    for name, key in (("eval", "eval"), ("calc_grad", "grad")):
        real = getattr(obj, name)

        def timed(w, real=real, key=key):
            t = time.perf_counter()
            out = real(w)
            obj.times[key].append(time.perf_counter() - t)
            return out
        setattr(obj, name, timed)
    real_iter, real_init = obj.lbfgs.update_one_iter, obj.lbfgs.init

    def init():
        real_init()
        obj.objvals.append(obj.lbfgs.old_objval)

    def update_one_iter():
        t = time.perf_counter()
        done = real_iter()
        obj.times["iter"].append(time.perf_counter() - t)
        obj.objvals.append(obj.lbfgs.new_objval if done
                           else obj.lbfgs.old_objval)
        return done
    obj.lbfgs.init, obj.lbfgs.update_one_iter = init, update_one_iter
    return obj


def linear_accuracy(torch, obj, weight):
    """Training accuracy of ``weight`` over the resident ELL blocks, and
    that of the constant base score (logit 0: every row predicted 0)."""
    from rabit_tpu_torch.learn import linear

    idx, val, labels, valid = obj._ell_blocks()
    nf = obj.model.num_feature
    base = float(np.float32(obj.model.base_score + weight[nf]))
    m = linear.margins(obj._wpad(weight, idx.device), base, idx, val)
    n = float(valid.sum())
    acc = float((((m > 0).float() == labels).float() * valid).sum()) / n
    return acc, float(((labels == 0).float() * valid).sum()) / n


def linear_rank(mode, out_dir):
    """One rank process of phase 24 (b) (``chip_smoke.py --phase24-linear
    MODE DIR``), under ``torchrun`` (``ok``) or as a plain process with
    MASTER_ADDR/MASTER_PORT (``death``): its own gloo group, then
    ``rabit_engine="xla"`` with no tracker, so adopt mode; (a)'s rows
    split by ``splitrows.rows_for_rank``.  In ``death`` mode rank 1
    SIGKILLs itself entering iteration P24_KILL_ITER's gradient
    allreduce and the survivors must raise RuntimeError.  Writes a JSON
    record to DIR."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch import engine as engine_mod
    from rabit_tpu_torch.learn import splitrows

    dist.init_process_group(
        "gloo", timeout=datetime.timedelta(seconds=P24_GROUP_SEC))
    rabit_tpu_torch.init(rabit_engine="xla")
    eng = engine_mod.get_engine()
    rank, world = eng.rank, eng.world_size
    rec = dict(mode=mode, rank=rank, world=world, dist_rank=dist.get_rank(),
               adopted=eng._adopted, no_host=eng._no_host_transport,
               plane=engine_mod.is_device_plane(), backend=eng.backend,
               grad_ms=[])
    data = linear_rows(n=P24_DEATH_ROWS if mode == "death" else MAIN_ROWS)
    shard = _take_rows(data, splitrows.rows_for_rank(data.num_row, rank,
                                                     world))
    del data
    rec["rows"] = shard.num_row
    obj = linear_objective(shard)
    real_ar = eng.allreduce

    def allreduce(buf, op, prepare_fun=None):
        grad = (isinstance(buf, np.ndarray)
                and buf.size == obj.lbfgs.num_dim)
        if (grad and mode == "death" and rank == 1
                and obj.lbfgs.num_iteration == P24_KILL_ITER - 1):
            with open(os.path.join(out_dir, "killed"), "w") as f:
                f.write(repr(time.monotonic()))
            os.kill(os.getpid(), signal.SIGKILL)
        t = time.perf_counter()
        out = real_ar(buf, op, prepare_fun)
        if grad:
            rec["grad_ms"].append((time.perf_counter() - t) * 1e3)
        return out
    eng.allreduce = allreduce
    path = os.path.join(out_dir, f"{mode}.{rank}.json")
    try:
        obj.lbfgs.run()
    except RuntimeError as e:
        if mode != "death":
            raise
        rec.update(raised=str(e), raised_at=time.monotonic(),
                   iteration=obj.lbfgs.num_iteration)
        with open(path, "w") as f:
            json.dump(rec, f)
        os._exit(0)                # the group is broken: skip its teardown
    rec.update(objvals=obj.objvals, times=obj.times,
               resident=sum(t.numel() * t.element_size()
                            for t in obj._ell_blocks()))
    if rank == 0:
        np.save(os.path.join(out_dir, f"{mode}.weight.npy"),
                obj.lbfgs.get_weight())
    with open(path, "w") as f:
        json.dump(rec, f)
    rabit_tpu_torch.finalize()
    dist.destroy_process_group()
    return 0


def kmeans_mixed_rank(out_dir):
    """One rank process of phase 24 (c) (``chip_smoke.py
    --phase24-kmeans DIR``) under ``torchrun`` with the port's tracker
    in RABIT_TRACKER_URI/PORT: its own gloo group, then
    ``rabit_engine="xla"`` over ``pyrobust``, so mixed mode (registered
    as ``dist.get_rank()``); ``kmeans.run`` on phase 17's dense16 third,
    P24_KM_ITERS iterations, each stats allreduce timed on the external
    group.  Writes a JSON record to DIR."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import rabit_tpu_torch
    from rabit_tpu_torch import engine as engine_mod
    from rabit_tpu_torch.learn import kmeans as km
    from rabit_tpu_torch.ops import kmeans_kernel as kk
    from rabit_tpu_torch.parallel.mesh import local_data_slice

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", timeout=datetime.timedelta(seconds=P24_GROUP_SEC))
    rabit_tpu_torch.init(rabit_engine="xla", rabit_inner_engine="pyrobust",
                         rabit_timeout_sec=W3_TIMEOUT)
    eng = engine_mod.get_engine()
    rank = eng.rank
    rec = dict(rank=rank, dist_rank=dist.get_rank(), adopted=eng._adopted,
               degraded=eng._degraded, plane=engine_mod.is_device_plane(),
               external=eng.group is dist.group.WORLD, ops=[], tiers=[],
               centroids={})
    data = sparse_clusters(MAIN_ROWS, 256, 32, K, seed=7,
                           picks=world3_picks(MAIN_ROWS, K, W3_RANKS))
    shard = _shard_rows(data, local_data_slice(rank, W3_RANKS, MAIN_ROWS))
    del data
    real_ar, real_prepare = eng.allreduce, km.prepare_shard
    real_ckpt = rabit_tpu_torch.checkpoint

    def allreduce(buf, op, prepare_fun=None):
        if not isinstance(buf, torch.Tensor):
            return real_ar(buf, op, prepare_fun)
        before = eng.path_stats["device_ops"]
        _sync(torch)
        t = time.perf_counter()
        out = real_ar(buf, op, prepare_fun)
        _sync(torch)
        rec["ops"].append(dict(
            version=eng.version_number, ms=(time.perf_counter() - t) * 1e3,
            on=out.device.type, counts=out[:, -1].tolist(),
            path=("device" if eng.path_stats["device_ops"] > before
                  else "host")))
        return out

    def dense16(*a, **k):
        staged = real_prepare(*a, budget=0, **k)     # as phase 17
        rec["tiers"].append(staged[0])
        return staged

    def checkpoint(model, *a, **k):
        rec["centroids"][eng.version_number + 1] = model.centroids.tolist()
        return real_ckpt(model, *a, **k)
    eng.allreduce = allreduce
    km.prepare_shard = dense16
    rabit_tpu_torch.checkpoint = checkpoint
    for key in kk.LAUNCHES:
        kk.LAUNCHES[key] = 0
    km.run(shard, K, P24_KM_ITERS, compute_dtype="bfloat16",
           device=P24_DEVICE)
    _sync(torch)
    rec.update(launches=dict(kk.LAUNCHES), stats=dict(eng.path_stats),
               backend=eng.backend)
    with open(os.path.join(out_dir, f"kmeans.{rank}.json"), "w") as f:
        json.dump(rec, f)
    rabit_tpu_torch.finalize()
    dist.destroy_process_group()
    return 0


def _torchrun(args, env_extra=None):
    """``torchrun --standalone --nproc_per_node W3_RANKS`` of this script
    with ``args``, no ``RABIT_`` variable but ``env_extra``; bounded by
    W3_TIMEOUT.  Returns seconds; raises with the output's end on a
    failure."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env.update(PYTHONPATH=ROOT, **(env_extra or {}))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(W3_RANKS), os.path.abspath(__file__)]
        + list(args), cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=W3_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(args)} failed "
                             f"({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-5000:]}")
    return time.perf_counter() - t0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _linear_death(tmp):
    """Phase 24 (b)'s death: three plain rank processes on one group
    (MASTER_ADDR/MASTER_PORT, so no agent tears the job down); returns
    the survivors' records and the death time."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env.update(PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(W3_RANKS))
    procs = []
    try:
        for r in range(W3_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--phase24-linear", "death", tmp], cwd=ROOT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        codes = [p.wait(timeout=W3_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [p.stderr.read()[-2000:] for p in procs]
    if codes != [0, -signal.SIGKILL, 0]:
        raise AssertionError(f"phase 24 (b) death: exit codes {codes} (want "
                             f"0, -SIGKILL, 0):\n" + "\n".join(errs))
    with open(os.path.join(tmp, "killed")) as f:
        killed = float(f.read())
    recs = []
    for r in (0, 2):
        with open(os.path.join(tmp, f"death.{r}.json")) as f:
            recs.append(json.load(f))
    return recs, killed


def phase24(torch, w3, p23):
    """Phase 24: the linear learner on the L-BFGS solver and the device
    plane's adopt and mixed modes.  (a) World 1, ``rabit_engine=empty``:
    logistic regression on ``linear_rows()`` (MAIN_ROWS x P24_NNZ in
    2^20 hashed features), P24_PARAMS; the first eval and gradient on
    the card against the CPU path at the same weights within the
    float32 bar, the objective falling every iteration, accuracy over
    0.5 points above the base score's; then the CLI on a small LibSVM
    file.  (b) The same under ``torchrun`` at world 3 in adopt mode
    (gloo; the ranks share the card), final weights and objective
    within P24_W_TOL / P24_OBJ_RTOL of (a)'s; then three plain processes
    where rank 1 SIGKILLs itself entering iteration 2's gradient
    allreduce and both survivors raise RuntimeError within
    P24_RAISE_SEC.  (c) ``kmeans.run`` on phase 17's dense16 thirds
    under the port's ``Tracker(3)`` (RABIT_TRACKER_PIN_RANKS=1) and
    torchrun's group, mixed mode: every stats allreduce on the external
    group counting MAIN_ROWS rows, iterations 1-3 phase 17's counts,
    version 3's centroids within the float32 bar of phase 17's; B1 by
    rank.  Returns B1's launches by rank."""
    from rabit_tpu_torch.learn import linear

    import rabit_tpu_torch

    t0 = time.perf_counter()
    log(f"[24] the linear learner (L-BFGS, logistic, reg_L2=1) on "
        f"{MAIN_ROWS} x {P24_NNZ} rows in {P24_FEATURES} hashed features, "
        f"{P24_PARAMS['max_lbfgs_iter']} iterations: world 1, then torchrun "
        f"world {W3_RANKS} in adopt mode and a rank's death; k-means under "
        f"a tracker and torchrun's group (mixed mode) | nvidia-smi: "
        f"{smi_line()}")
    # (a) world 1
    t = time.perf_counter()
    data = linear_rows()
    t_data = time.perf_counter() - t
    rabit_tpu_torch.init(rabit_engine="empty")
    try:
        obj = linear_objective(data)
        cpu = linear_objective(data, device="cpu")
        for o in (obj, cpu):
            o.model.num_feature = P24_FEATURES
            o.model.init_base_score()
        rng = np.random.default_rng(P24_SEED + 1)
        t = time.perf_counter()
        obj._ell_blocks()
        _sync(torch)
        t_stage = time.perf_counter() - t
        resident = sum(x.numel() * x.element_size() for x in obj._ell)
        errs = []
        for w in (np.zeros(P24_FEATURES + 1),
                  0.05 * rng.standard_normal(P24_FEATURES + 1)):
            e_dev, e_cpu = obj.eval(w), cpu.eval(w)
            g_dev, g_cpu = obj.calc_grad(w), cpu.calc_grad(w)
            if not (np.allclose(e_dev, e_cpu, rtol=SUM_RTOL, atol=SUM_ATOL)
                    and np.allclose(g_dev, g_cpu, rtol=SUM_RTOL,
                                    atol=SUM_ATOL)):
                raise AssertionError(
                    f"phase 24 (a): eval {e_dev} vs CPU {e_cpu}, gradient "
                    f"off by {float(np.abs(g_dev - g_cpu).max())}")
            errs.append((abs(e_dev - e_cpu) / abs(e_cpu),
                         float(np.abs(g_dev - g_cpu).max())))
        del cpu
        for key in obj.times:
            obj.times[key].clear()
        obj.model = linear.LinearModel()
        for k, v in P24_PARAMS.items():
            obj.model.set_param(k, v)
        t = time.perf_counter()
        obj.lbfgs.run()
        _sync(torch)
        t_run = time.perf_counter() - t
        weight = obj.lbfgs.get_weight()
        objvals = list(obj.objvals)
        if not (np.isfinite(weight).all() and weight.shape
                == (P24_FEATURES + 1,)) or any(
                    b >= a for a, b in zip(objvals, objvals[1:])):
            raise AssertionError(f"phase 24 (a): weights finite "
                                 f"{np.isfinite(weight).all()}, objective "
                                 f"by iteration {objvals}")
        acc, base_acc = linear_accuracy(torch, obj, weight)
        if not acc > base_acc + 0.005:
            raise AssertionError(f"phase 24 (a): accuracy {acc} vs the base "
                                 f"score's {base_acc}")
        times = {k: list(v) for k, v in obj.times.items()}
        del obj
    finally:
        rabit_tpu_torch.finalize()
    del data
    torch.cuda.empty_cache()
    log(f"    (a) world 1: data {t_data:.1f} s, ELL staged in {t_stage:.2f} s "
        f"({resident} B resident); first eval and gradient on the card vs "
        f"the CPU path at weights 0 and random: relative eval error, max "
        f"|gradient error| {[(f'{a:.3g}', f'{b:.3g}') for a, b in errs]}; "
        f"run() {t_run:.2f} s, {len(times['iter'])} iterations at "
        f"{[round(s, 3) for s in times['iter']]} s, {len(times['eval'])} "
        f"evals at median {statistics.median(times['eval']) * 1e3:.1f} ms, "
        f"{len(times['grad'])} gradients at median "
        f"{statistics.median(times['grad']) * 1e3:.1f} ms; objective "
        f"{[round(v, 1) for v in objvals]} falling; accuracy {acc:.4f} vs "
        f"the base score's {base_acc:.4f}")
    out = dict(linear_world1=dict(
        iter_s=times["iter"], eval_ms=[s * 1e3 for s in times["eval"]],
        grad_ms=[s * 1e3 for s in times["grad"]], resident=resident))
    with tempfile.TemporaryDirectory() as tmp:
        small = linear_rows(n=20000, nnz=16, nf=4096, seed=P24_SEED + 2)
        path = os.path.join(tmp, "train.libsvm")
        with open(path, "w") as f:
            for r in range(small.num_row):
                fi, fv = small.row(r)
                f.write(f"{small.labels[r]:g} " + " ".join(
                    f"{i}:{v:.6g}" for i, v in zip(fi, fv)) + "\n")
        model_out = os.path.join(tmp, "linear.model")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("RABIT_")}
        proc = subprocess.run(
            [sys.executable, "-m", "rabit_tpu_torch.learn.linear", path,
             "objective=logistic", "reg_L2=1", "max_lbfgs_iter=10",
             f"linear_device={P24_DEVICE}", f"model_out={model_out}"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(env, PYTHONPATH=ROOT))
        if proc.returncode != 0:
            raise AssertionError(f"phase 24 CLI failed ({proc.returncode}):"
                                 f"\n{proc.stdout}\n{proc.stderr}")
        model = linear.LinearModel()
        model.load(model_out)
        hits = float(((model.predict(small) > 0.5) == (small.labels > 0.5)
                      ).mean())
        base_hits = float((small.labels == 0).mean())
        if model.num_feature > 4096 or not np.isfinite(model.weight).all() \
                or not hits > base_hits + 0.005:
            raise AssertionError(f"phase 24 CLI model: num_feature "
                                 f"{model.num_feature}, accuracy {hits} vs "
                                 f"{base_hits}")
        log(f"    (a) CLI: python -m rabit_tpu_torch.learn.linear on 20000 "
            f"LibSVM rows -> a binf model of {model.num_feature} features, "
            f"accuracy {hits:.4f} vs {base_hits:.4f}; "
            f"{proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ''}")

        # (b) torchrun, adopt mode, world 3
        secs = _torchrun(["--phase24-linear", "ok", tmp])
        recs = []
        for r in range(W3_RANKS):
            with open(os.path.join(tmp, f"ok.{r}.json")) as f:
                recs.append(json.load(f))
        w3w = np.load(os.path.join(tmp, "ok.weight.npy"))
        for r, rec in enumerate(recs):
            if (rec["rank"], rec["world"], rec["dist_rank"]) != (r, W3_RANKS,
                                                                 r) or \
                    not (rec["adopted"] and rec["no_host"] and rec["plane"]) \
                    or rec["backend"] != "gloo":
                raise AssertionError(f"phase 24 (b) rank {r}: {rec}")
        if sum(rec["rows"] for rec in recs) != MAIN_ROWS or any(
                rec["objvals"] != recs[0]["objvals"] for rec in recs):
            raise AssertionError("phase 24 (b): rows or objectives differ "
                                 "between the ranks")
        werr = float(np.abs(w3w - weight).max())
        if len(recs[0]["objvals"]) != len(objvals) or not np.allclose(
                recs[0]["objvals"], objvals, rtol=P24_OBJ_RTOL) or \
                not np.allclose(w3w, weight, **P24_W_TOL):
            raise AssertionError(
                f"phase 24 (b): objective {recs[0]['objvals']} vs world 1's "
                f"{objvals}; weights off by {werr}")
        oerr = max(abs(a - b) / abs(b)
                   for a, b in zip(recs[0]["objvals"], objvals))
        grad_ms = [t for rec in recs for t in rec["grad_ms"]]
        log(f"    (b) torchrun world {W3_RANKS}, adopt mode (gloo, no "
            f"tracker): {secs:.1f} s; rows by rank "
            f"{[rec['rows'] for rec in recs]}; objective within {oerr:.3g} "
            f"relative of world 1's at every iteration, weights within "
            f"{werr:.3g}; iterations by rank 0 "
            f"{[round(s, 3) for s in recs[0]['times']['iter']]} s; the "
            f"gradient allreduce ({(P24_FEATURES + 1) * 8} B of float64 on "
            f"the group) median {statistics.median(grad_ms):.2f} ms over "
            f"{len(grad_ms)}")
        out["linear_world3"] = dict(
            iter_s=recs[0]["times"]["iter"], grad_allreduce_ms=grad_ms)
        survivors, killed = _linear_death(tmp)
        raise_s = [rec["raised_at"] - killed for rec in survivors]
        for rec in survivors:
            if "no host transport" not in rec["raised"] or \
                    rec["iteration"] != P24_KILL_ITER - 1:
                raise AssertionError(f"phase 24 (b) death: rank "
                                     f"{rec['rank']} {rec}")
        if not all(0 <= s < P24_RAISE_SEC for s in raise_s):
            raise AssertionError(f"phase 24 (b) death -> raise {raise_s} s "
                                 f"(bar {P24_RAISE_SEC} s)")
        log(f"    (b) rank 1 SIGKILLed entering iteration {P24_KILL_ITER}'s "
            f"gradient allreduce -> RuntimeError on ranks 0 and 2 after "
            f"{[round(s, 3) for s in raise_s]} s (no host transport in "
            f"adopt mode); both exited 0")
        out["linear_death_raise_s"] = raise_s

        # (c) k-means, tracker + torchrun's group: mixed mode
        from rabit_tpu_torch.tracker.tracker import Tracker

        pin = os.environ.get("RABIT_TRACKER_PIN_RANKS")
        os.environ["RABIT_TRACKER_PIN_RANKS"] = "1"
        tracker = Tracker(W3_RANKS, host="127.0.0.1", port=0)
        tracker.start()
        try:
            secs = _torchrun(["--phase24-kmeans", tmp], {
                "RABIT_TRACKER_URI": "127.0.0.1",
                "RABIT_TRACKER_PORT": str(tracker.port)})
            tracker.join(30)
        finally:
            tracker.stop()
            if pin is None:
                os.environ.pop("RABIT_TRACKER_PIN_RANKS")
            else:
                os.environ["RABIT_TRACKER_PIN_RANKS"] = pin
        kms = []
        for r in range(W3_RANKS):
            with open(os.path.join(tmp, f"kmeans.{r}.json")) as f:
                kms.append(json.load(f))
    for r, rec in enumerate(kms):
        tag = f"phase 24 (c) rank {r}"
        if (rec["rank"], rec["dist_rank"]) != (r, r) or not (
                rec["adopted"] and rec["plane"] and rec["external"]) or \
                rec["degraded"] or rec["backend"] != "gloo":
            raise AssertionError(f"{tag}: {rec}")
        if [o["path"] for o in rec["ops"]] != ["device"] * P24_KM_ITERS or \
                rec["stats"]["host_ops"] or rec["tiers"] != ["dense16"]:
            raise AssertionError(f"{tag}: ops {rec['ops']}, {rec['stats']}, "
                                 f"tiers {rec['tiers']}")
        for it, o in enumerate(rec["ops"]):
            if sum(o["counts"]) != MAIN_ROWS or (
                    it < W3_KM_ITERS and o["counts"]
                    != w3["oracle_counts"][it]):
                raise AssertionError(f"{tag}: iteration {it + 1} counted "
                                     f"{sum(o['counts'])} rows, or not phase "
                                     f"17's counts")
        if rec["launches"]["kmeans_stats_dense"] != P24_KM_ITERS:
            raise AssertionError(f"{tag}: launches {rec['launches']}")
    v3 = [np.asarray(rec["centroids"][str(W3_KM_ITERS)], np.float32)
          for rec in kms]
    p17 = np.asarray(w3["centroids"], np.float32)
    if any(not np.array_equal(c, v3[0]) for c in v3) or not np.allclose(
            v3[0], p17, rtol=SUM_RTOL, atol=SUM_ATOL):
        raise AssertionError(f"phase 24 (c): version-{W3_KM_ITERS} centroids "
                             f"off phase 17's by "
                             f"{float(np.abs(v3[0] - p17).max())}")
    ms = [o["ms"] for rec in kms for o in rec["ops"]]
    log(f"    (c) k-means under Tracker({W3_RANKS}) "
        f"(RABIT_TRACKER_PIN_RANKS=1) and torchrun's gloo group, mixed "
        f"mode: {secs:.1f} s; every rank registered as its dist rank, "
        f"{P24_KM_ITERS} stats allreduces on the external group (none "
        f"degraded), each counting {MAIN_ROWS} rows, iterations 1-3 phase "
        f"17's counts, version 3 within "
        f"{float(np.abs(v3[0] - p17).max()):.3g} of phase 17's; the "
        f"({K}, 257) stats op (synchronize to synchronize) median "
        f"{statistics.median(ms):.3f} ms {[round(t, 3) for t in ms]}, phase "
        f"23's on the engine's own group median "
        f"{statistics.median(p23['stats_ms']):.3f} ms; B1 by rank "
        f"{[rec['launches']['kmeans_stats_dense'] for rec in kms]}")
    out["mixed_stats_ms"] = ms
    out["kmeans_stats_dense"] = [rec["launches"]["kmeans_stats_dense"]
                                 for rec in kms]
    log(f"    phase 24 wall {time.perf_counter() - t0:.1f} s")
    return out


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

    # 19. recovery at world 3: the pyrobust engine under the launcher
    t0 = time.perf_counter()
    p19 = phase19(torch, w3)
    for line in lines:
        if line["name"] in p19:
            line["phase19_launches_by_rank_and_life"] = p19[line["name"]]
    log(f"    phase 19 took {time.perf_counter() - t0:.1f} s")

    # 20. liveness at world 3: hung ranks found by heartbeat and watchdog
    t0 = time.perf_counter()
    p20 = phase20(torch, w3)
    for line in lines:
        if line["name"] in p20:
            line["phase20_launches_by_rank_and_life"] = p20[line["name"]]
    log(f"    phase 20 took {time.perf_counter() - t0:.1f} s")

    # 21. the durable tier at world 3: every rank killed, resumed from disk
    t0 = time.perf_counter()
    p21 = phase21(torch, w3)
    for line in lines:
        if line["name"] in p21:
            line["phase21_launches_by_rank_and_life"] = p21[line["name"]]
    log(f"    phase 21 took {time.perf_counter() - t0:.1f} s")

    # 22. elastic membership: k-means shrinks from 3 ranks to 2 and grows
    # back to 3 at commit boundaries
    t0 = time.perf_counter()
    p22 = phase22(torch, km)
    for line in lines:
        if line["name"] in p22:
            line["phase22_launches_by_task_and_world"] = p22[line["name"]]
    log(f"    phase 22 took {time.perf_counter() - t0:.1f} s")

    # 23. the device-plane engine: k-means through a death and GBDT at
    # world 3 reducing CUDA tensors, and the NCCL new_group at world 1
    t0 = time.perf_counter()
    p23 = phase23(torch, w3, km)
    for line in lines:
        if line["name"] == "kmeans_stats_dense":
            line["phase23_launches_by_rank_and_life"] = \
                p23["kmeans_stats_dense"]
        if line["name"] == "gbdt_hist":
            line["phase23_launches_by_rank"] = p23["gbdt_hist"]
    log(f"    phase 23 took {time.perf_counter() - t0:.1f} s")

    # 24. the linear learner at world 1 and under torchrun (adopt mode),
    # and k-means under a tracker beside torchrun's group (mixed mode)
    t0 = time.perf_counter()
    p24 = phase24(torch, w3, p23)
    for line in lines:
        if line["name"] == "kmeans_stats_dense":
            line["phase24_launches_by_rank"] = p24["kmeans_stats_dense"]
    log(f"    phase 24 took {time.perf_counter() - t0:.1f} s")
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
    if sys.argv[1:2] in (["--phase19-rank"], ["--phase20-rank"],
                         ["--phase21-rank"]):
        sys.exit(robust_rank(sys.argv[1][7:9], sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--phase23-rank"]:
        sys.exit(device_plane_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--phase24-linear"]:
        sys.exit(linear_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--phase24-kmeans"]:
        sys.exit(kmeans_mixed_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--phase22-rank"]:
        sys.exit(elastic_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--phase22-grow"]:
        sys.exit(elastic_rank("grow", sys.argv[4], task=sys.argv[2],
                              port=int(sys.argv[3])))
    sys.exit(main())
