"""k-means and GBDT at world 3 over the pysocket engine, port against
rabit_tpu, on the CPU.

The api keeps one engine a process, so each world is three launched
processes: this file, run as a script, is the rank worker (below, under
``if __name__ == "__main__":``).  Three port ranks and three reference
ranks (its ``pysocket``; the ELL tier's Pallas kernel in interpret mode,
as its own tests run it) train on the same seeded shards: k-means on
the dense and the ell_fused tiers, then ``boosting.train``, then a
stream of per-node GBDT histograms issued through
``build_allreduce_async(..., fuse=True)`` as XGBoost issues them.  Each
rank reports every allreduce result it saw and its model; counts and
splits must be exact, float32 sums, centroids and leaf values within
the JAX tests' float32 bar, and all ranks of a world must agree.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_ref import REF_ENV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3
PROC_SEC = 120          # each rank process's time limit
F32_TOL = dict(rtol=1e-4, atol=1e-3)
KM_ROWS, KM_D, KM_NNZ, KM_K, KM_ITERS = 3 * 1024, 64, 6, 4, 4
GB_ROWS, GB_F, GB_NBIN, GB_DEPTH, GB_ROUNDS = 3 * 1000, 5, 16, 3, 3
RUNS = ("dense", "ell_fused", "gbdt", "stream")
STREAM_NODES = 8
STREAM_NBINS = (GB_NBIN, 2048)  # 680 B and 81,960 B a node: tree, ring


# ------------------------------------------------------------------ data
def kmeans_shard(rank):
    """This rank's contiguous third of clustered ELL rows (3/4 of each
    row's slots on its cluster's 8 signature features).  The row every
    centroid is seeded from — the draws ``init_centroids`` makes on
    each shard, and the root it broadcasts from — is given that
    centroid's cluster, so no cluster starts empty or shared and no
    assignment sits near a tie."""
    n, d, nnz, k = KM_ROWS, KM_D, KM_NNZ, KM_K
    per = n // WORLD
    rng = np.random.default_rng(0)
    sig = rng.permutation(d)[:8 * k].reshape(k, 8)
    label = rng.integers(0, k, n)
    draw = np.random.default_rng(0)          # init_centroids(seed=0)
    rows = [int(draw.integers(per)) for _ in range(k)]
    roots = [int(draw.integers(WORLD)) for _ in range(k)]
    picks = [roots[i] * per + rows[i] for i in range(k)]
    assert len(set(picks)) == k
    label[picks] = np.arange(k)
    n_sig = nnz * 3 // 4
    idx = np.empty((n, nnz), np.int32)
    idx[:, :n_sig] = sig[label[:, None], rng.integers(0, 8, (n, n_sig))]
    idx[:, n_sig:] = rng.integers(0, d, (n, nnz - n_sig))
    val = np.empty((n, nnz), np.float32)
    val[:, :n_sig] = 1.0 + rng.random((n, n_sig))
    val[:, n_sig:] = 0.2 * rng.random((n, nnz - n_sig))
    lo = rank * per
    return dict(indptr=np.arange(per + 1, dtype=np.int64) * nnz,
                findex=idx[lo:lo + per].reshape(-1),
                fvalue=val[lo:lo + per].reshape(-1),
                labels=np.zeros(per, np.float32), feat_dim=d)


def gbdt_shard(rank):
    """This rank's third of rows under a depth-2 planted tree whose leaf
    outcomes lie far apart, 10% NaN in feature 4."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (GB_ROWS, GB_F)).astype(np.float32)
    leaf = np.where(x[:, 0] < 0.1, np.where(x[:, 1] < -0.3, 0, 1),
                    np.where(x[:, 2] < 0.4, 2, 3))
    y = (rng.random(GB_ROWS) < np.array([0.08, 0.7, 0.35, 0.95])[leaf]
         ).astype(np.float32)
    x[rng.random(GB_ROWS) < 0.1, 4] = np.nan
    per = GB_ROWS // WORLD
    return x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]


# ---------------------------------------------------------------- worker
def _record(engine_mod):
    """Wrap the live engine's blocking allreduce body, which both
    packages' allreduce and allreduce_async run, to keep a copy of every
    result in issue order."""
    eng = engine_mod.get_engine()
    seen = []
    real = eng._allreduce_blocking

    def allreduce(buf, *a, **kw):
        out = real(buf, *a, **kw)
        seen.append(np.array(out).tolist())
        return out
    eng._allreduce_blocking = allreduce
    return seen


def _node_stream(pkg, engine_mod, hist, rank, kw):
    """Per-node histograms of one tree level at both widths, issued as a
    fused async stream and waited in issue order, then the same ones
    each through a blocking allreduce; with the wire ops (buckets) the
    engine's fused body ran."""
    eng = engine_mod.get_engine()
    real = eng._fused_allreduce_exec
    buckets = []

    def counted(items, *a, **k):
        buckets.append(len(items))
        return real(items, *a, **k)
    eng._fused_allreduce_exec = counted
    x, y = gbdt_shard(rank)
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(len(y), 0.25, np.float32)
    node = np.random.default_rng([7, rank]).integers(0, STREAM_NODES, len(y))
    out = {}
    for nbin in STREAM_NBINS:
        cuts = pkg.broadcast(hist.quantile_cuts(x, nbin)
                             if rank == 0 else None, 0)
        bins = hist.apply_cuts(x, cuts)
        rows = [node == j for j in range(STREAM_NODES)]
        handles = [hist.build_allreduce_async(bins[m], grad[m], hess[m],
                                              nbin + 1, fuse=True, **kw)
                   for m in rows]
        fused = [h.wait() for h in handles]
        solo = [hist.build_allreduce(bins[m], grad[m], hess[m], nbin + 1,
                                     **kw) for m in rows]
        out[nbin] = dict(fused=[np.asarray(f).tolist() for f in fused],
                         same=all(np.asarray(f).tobytes()
                                  == np.asarray(s).tobytes()
                                  for f, s in zip(fused, solo)))
    eng._fused_allreduce_exec = real
    return dict(out, buckets=buckets)


def _trees(model):
    return [[[n.feature, n.bin_threshold, n.left, n.right,
              bool(n.default_left), float(n.value)] for n in t]
            for t in model.trees]


def _worker(kind, task, ports):
    if kind == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import rabit_tpu as pkg
        from rabit_tpu import engine as engine_mod
        from rabit_tpu.learn import boosting as gb
        from rabit_tpu.learn import histogram as hist
        from rabit_tpu.learn import kmeans as km
        from rabit_tpu.learn.data import SparseMat
        from rabit_tpu.ops import kmeans_kernel as kk
        dev = {}
    else:
        import rabit_tpu_torch as pkg
        from rabit_tpu_torch import engine as engine_mod
        from rabit_tpu_torch.learn import boosting as gb
        from rabit_tpu_torch.learn import histogram as hist
        from rabit_tpu_torch.learn import kmeans as km
        from rabit_tpu_torch.learn.data import SparseMat
        dev = {"device": "cpu"}
    out = {}
    for run, port in zip(RUNS, ports):
        pkg.init(rabit_engine="pysocket", rabit_tracker_uri="127.0.0.1",
                 rabit_tracker_port=port, rabit_task_id=task,
                 rabit_world_size=WORLD, rabit_timeout_sec=60)
        seen = _record(engine_mod)
        rank = pkg.get_rank()
        result = {}
        patched = []
        if run == "ell_fused":
            # the ELL tier as each package's own tests force it: every
            # densify budget 0, and the accelerator's kernel path
            patched.append((km, "prepare_shard", functools.partial(
                km.prepare_shard, budget=0)))
            if kind == "jax":
                patched += [(jax, "default_backend", lambda: "tpu"),
                            (kk, "kmeans_ell_stats_fused", functools.partial(
                                kk.kmeans_ell_stats_fused, interpret=True))]
            else:
                patched.append((km, "_on_card", lambda device: True))
        if run in ("dense", "ell_fused"):
            staged = (patched[0][2] if patched else km.prepare_shard)

            def stage(*a, staged=staged, **k):
                shard = staged(*a, **k)
                result["tier"] = shard[0]
                return shard
            patched.append((km, "prepare_shard", stage))
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        if run == "stream":
            kw = {"use_pallas": False} if kind == "jax" else {}
            result.update(_node_stream(pkg, engine_mod, hist, rank, kw))
        elif run == "gbdt":
            x, y = gbdt_shard(rank)
            kw = {"use_pallas": False} if kind == "jax" else dev
            model = gb.train(x, y, num_round=GB_ROUNDS, max_depth=GB_DEPTH,
                             nbin=GB_NBIN, **kw)
            result.update(trees=_trees(model),
                          cuts=np.asarray(model.cuts).tolist(),
                          has_missing=bool(model.has_missing))
        else:
            model = km.run(SparseMat(**kmeans_shard(rank)), KM_K, KM_ITERS,
                           **dev)
            result["centroids"] = np.asarray(model.centroids).tolist()
        result.update(rank=rank, world=pkg.get_world_size(),
                      version=pkg.version_number(), allreduces=seen,
                      sched=engine_mod.get_engine()._op_sched)
        out[run] = result
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        pkg.finalize()
    print(json.dumps(out), flush=True)


# ------------------------------------------------------------------ test
def _launch(kind):
    """Three rank processes of one package, each under three trackers
    (one for each run) of the same package; returns the started
    processes and the trackers."""
    if kind == "jax":
        from rabit_tpu.tracker.tracker import Tracker
    else:
        from rabit_tpu_torch.tracker.tracker import Tracker
    trackers = [Tracker(WORLD, "127.0.0.1", 0) for _ in RUNS]
    for t in trackers:
        t.start()
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    if kind == "jax":
        env.update(REF_ENV)
    procs = [subprocess.Popen(
        [sys.executable, __file__, kind, str(i)]
        + [str(t.port) for t in trackers],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(WORLD)]
    return procs, trackers


def _collect(procs, trackers):
    results = []
    try:
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=PROC_SEC)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
                raise AssertionError(f"rank process timed out:\n{stderr}")
            assert p.returncode == 0, stderr
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in trackers:
            t.stop()
    return {r["dense"]["rank"]: r for r in results}


@pytest.fixture(scope="module")
def worlds():
    mp = pytest.MonkeyPatch()
    mp.setenv("RABIT_TRACKER_PIN_RANKS", "1")   # task id i is rank i
    try:
        launched = {kind: _launch(kind) for kind in ("torch", "jax")}
        yield {kind: _collect(*launched[kind]) for kind in launched}
    finally:
        mp.undo()


def _same_allreduces(got, want, counts_col):
    """Allreduce results in order: counts (the last column of a stats
    block) exact, every float32 sum within the bar."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        if counts_col and g.ndim == 2:
            np.testing.assert_array_equal(g[:, -1], w[:, -1])
        np.testing.assert_allclose(g, w, **F32_TOL)


@pytest.mark.parametrize("tier", ["dense", "ell_fused"])
def test_kmeans_world3_matches_jax(worlds, tier):
    port, ref = worlds["torch"], worlds["jax"]
    for rank in range(WORLD):
        g, w = port[rank][tier], ref[rank][tier]
        assert (g["rank"], g["world"]) == (rank, WORLD)
        assert g["tier"] == w["tier"] == tier
        assert g["version"] == w["version"] == KM_ITERS
        # feat_dim MAX, then one (k, d+1) stats allreduce per iteration
        assert len(g["allreduces"]) == 1 + KM_ITERS
        _same_allreduces(g["allreduces"], w["allreduces"], counts_col=True)
        np.testing.assert_allclose(g["centroids"], w["centroids"], **F32_TOL)
        # every rank of each world holds the same bits
        assert g["centroids"] == port[0][tier]["centroids"]
        assert w["centroids"] == ref[0][tier]["centroids"]
        assert g["sched"] == w["sched"] == "tree"   # 4 x 65 f32 < 64 KiB


def test_gbdt_world3_matches_jax(worlds):
    port, ref = worlds["torch"], worlds["jax"]
    for rank in range(WORLD):
        g, w = port[rank]["gbdt"], ref[rank]["gbdt"]
        assert g["version"] == w["version"] == GB_ROUNDS
        assert g["has_missing"] and w["has_missing"]
        np.testing.assert_array_equal(g["cuts"], w["cuts"])
        _same_allreduces(g["allreduces"], w["allreduces"], counts_col=False)
        assert len(g["trees"]) == len(w["trees"]) == GB_ROUNDS
        for tg, tw in zip(g["trees"], w["trees"]):
            assert [n[:5] for n in tg] == [n[:5] for n in tw]
            np.testing.assert_allclose([n[5] for n in tg],
                                       [n[5] for n in tw], **F32_TOL)
        assert g["trees"] == port[0]["gbdt"]["trees"]
        assert w["trees"] == ref[0]["gbdt"]["trees"]
    # the first tree splits its root on a planted feature
    assert port[0]["gbdt"]["trees"][0][0][0] in (0, 1, 2)


def test_gbdt_node_stream_fuses_like_jax(worlds):
    """Per-node histograms issued with ``fuse=True`` ride fused wire ops
    on every rank — the narrow ones one concatenated tree op, the wide
    ones (over the 64 KiB crossover) one segmented ring walk — bit for
    bit their blocking runs, the same on every rank, and within the
    float32 bar of the JAX package's stream (whose local builder sums
    in another order)."""
    port, ref = worlds["torch"], worlds["jax"]
    for rank in range(WORLD):
        g, w = port[rank]["stream"], ref[rank]["stream"]
        assert g["buckets"] == w["buckets"] == [STREAM_NODES] * 2
        for nbin in STREAM_NBINS:
            key = str(nbin)
            assert g[key]["same"] and w[key]["same"]
            assert g[key]["fused"] == port[0]["stream"][key]["fused"]
            np.testing.assert_allclose(g[key]["fused"], w[key]["fused"],
                                       **F32_TOL)
            got = np.asarray(g[key]["fused"])
            assert got.shape == (STREAM_NODES, GB_F, nbin + 1, 2)
            # every row lands in one node: the hessians add up to 0.25 n
            assert got[..., 1].sum() == pytest.approx(
                0.25 * GB_ROWS * GB_F, rel=1e-5)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], [int(p) for p in sys.argv[3:]])
