"""The device-plane engine through rank deaths, on the CPU.

The thread form of the reference's XLA death matrix
(``tests/test_xla_engine.py``, its worker ``tests/workers/xla_restart.py``
rewritten as a function on the engine): ranks are threads of this
process (the harness of ``tests/test_torch_xla.py``), a rank dies by
aborting its gloo group and closing its host links, and comes back as a
fresh engine with the next trial.  Each case checks, by rank and life,
which iterations rode the device plane and which the degraded host
path, ``device_epoch`` after the re-formations, ``path_stats``, and
every result against the fault-free run.

Then the apps: ``kmeans.run`` through a death and ``boosting.train``
on the device plane at world 3, against the port's fault-free run, its
host-plane run and one launch of the reference's own
``tests/workers/kmeans_run_xla.py``; and one real launched job of
three processes under the port's launcher, where a rank SIGKILLs
itself (this file, run as a script, is that job's worker).
"""
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

import rabit_tpu_torch
from rabit_tpu_torch.engine.robust import PyRobustEngine
from rabit_tpu_torch.learn import boosting as gb
from rabit_tpu_torch.learn import kmeans as km
from rabit_tpu_torch.learn.data import SparseMat, load_libsvm
from rabit_tpu_torch.ops import ReduceOp
from test_torch_pysocket_learn import (GB_DEPTH, GB_NBIN, KM_K, gbdt_shard,
                                       kmeans_shard)
from test_torch_xla import _env, die, per_thread, run_world  # noqa: F401
from torch_ref import REF_ENV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NITER = 4
WORLD = 3
F32_TOL = dict(rtol=1e-4, atol=1e-3)
KM_ITERS, GB_ROUNDS = 4, 2


# ------------------------------------------------------- the death matrix
def restart_body(plan):
    """``xla_restart.py`` as a body: ``plan`` maps a rank to the
    iteration its first life dies entering.  Each iteration reduces a
    tensor on the device plane (host-degraded after a death) and a
    numpy array on the host plane, then checkpoints the running sum."""
    def body(eng, trial, rec):
        world = eng.world_size
        version, blob, _ = eng.load_checkpoint()
        state = float(blob) if version else 0.0
        for it in range(version, NITER):
            if plan.get(eng.rank) == it and trial == 0:
                die(eng)
            before = eng.path_stats["device_ops"]
            out = eng.allreduce(torch.full((32,), float(eng.rank + it)),
                                ReduceOp.SUM)
            rec[("path", trial, it)] = ("device" if eng.path_stats[
                "device_ops"] > before else "host")
            expect = float(sum(r + it for r in range(world)))
            assert isinstance(out, torch.Tensor)
            assert torch.equal(out, torch.full((32,), expect))
            state += expect
            h = np.array([float(eng.rank == it)])
            eng.allreduce(h, ReduceOp.MAX)
            assert h[0] == (1.0 if it < world else 0.0)
            eng.checkpoint(repr(state).encode())
        rec["state"] = state
        rec[("epoch", trial)] = eng.device_epoch
        rec[("stats", trial)] = dict(eng.path_stats)
        if eng.device_epoch:
            # after a re-formation the plane carries tensors again
            before = eng.path_stats["device_ops"]
            out = eng.allreduce(torch.ones(8), ReduceOp.SUM)
            assert torch.equal(out, torch.full((8,), float(world)))
            rec["after_reform"] = eng.path_stats["device_ops"] - before
    return body


def _paths(rec, trial):
    return [rec[k] for k in sorted(k for k in rec
                                   if k[0] == "path" and k[1] == trial)]


D, H = "device", "host"
CASES = {
    # rank 1 dies entering iteration 2: the survivors' op degrades, the
    # relaunch comes up degraded, checkpoint 3 re-forms the plane
    "rank1": (dict(plan={1: 2}),
              {0: [([D, D, H, D], 1)], 1: [([D, D], None), ([H, D], 1)],
               2: [([D, D, H, D], 1)]}),
    # rank 0 dies: the tracker-hosted store keeps the plane recoverable
    "rank0": (dict(plan={0: 2}),
              {0: [([D, D], None), ([H, D], 1)], 1: [([D, D, H, D], 1)],
               2: [([D, D, H, D], 1)]}),
    # two deaths in different iterations: two re-formations; rank 2's
    # relaunch replays the first one's round (stale, an epoch of its
    # own) and joins the second
    "two_deaths": (dict(plan={1: 1, 2: 2}),
                   {0: [([D, H, H, D], 2)],
                    1: [([D], None), ([H, H, D], 2)],
                    2: [([D, H], None), ([H, D], 2)]}),
    # rabit_device_reform=0: degraded to the end, no re-formation
    "no_reform": (dict(plan={1: 2}, params={"rabit_device_reform": "0"}),
                  {0: [([D, D, H, H], 0)], 1: [([D, D], None), ([H, H], 0)],
                   2: [([D, D, H, H], 0)]}),
    # rank 1 dies in the formation window: the barrier aborts, every
    # rank starts degraded and the first boundary (load_checkpoint at
    # version 0) re-forms the plane
    "formation": (dict(plan={}, env={"RABIT_XLA_DIE_FORMATION": "1"}),
                  {0: [([D, D, D, D], 1)], 1: [([], None), ([D, D, D, D], 1)],
                   2: [([D, D, D, D], 1)]}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_death_matrix(case, monkeypatch):
    spec, want = CASES[case]
    clean, _ = run_world(WORLD, restart_body({}))
    for var, val in spec.get("env", {}).items():
        monkeypatch.setenv(var, val)
    got, lives = run_world(WORLD, restart_body(spec["plan"]),
                           params=spec.get("params"))
    assert lives == [len(want[r]) for r in range(WORLD)]
    total = float(sum(sum(r + it for r in range(WORLD))
                      for it in range(NITER)))
    for r in range(WORLD):
        assert clean[r]["state"] == got[r]["state"] == total
        assert _paths(clean[r], 0) == [D] * NITER
        for trial, (paths, epoch) in enumerate(want[r]):
            assert _paths(got[r], trial) == paths, (r, trial)
            assert got[r].get(("epoch", trial)) == epoch, (r, trial)
        last = len(want[r]) - 1
        stats = got[r][("stats", last)]
        assert stats["backend"] == ("gloo" if D in want[r][last][0]
                                    else None)
        assert stats["host_ops"] == want[r][last][0].count(H)
        assert stats["device_ops"] == want[r][last][0].count(D)
        assert got[r].get("after_reform", 1) == 1


# ---------------------------------------------------------- the apps
def _kmeans_body(proxy, plan=None):
    """``kmeans.run`` on this rank's shard (the dense tier on the CPU),
    recording every stats allreduce and the path it took; ``plan``
    kills rank r's first life entering its device allreduce of
    iteration ``plan[r]``."""
    def body(eng, trial, rec):
        proxy.set(eng)
        real = eng.allreduce

        def allreduce(buf, op, prepare_fun=None):
            if isinstance(buf, torch.Tensor):
                it = eng.version_number
                if plan and plan.get(eng.rank) == it and trial == 0:
                    die(eng)
                before = eng.path_stats["device_ops"]
                out = real(buf, op, prepare_fun)
                rec[("stats", it)] = out.numpy().copy()
                rec[("path", trial, it)] = (
                    D if eng.path_stats["device_ops"] > before else H)
                return out
            return real(buf, op, prepare_fun)
        eng.allreduce = allreduce
        sm = SparseMat(**kmeans_shard(eng.rank))
        model = km.run(sm, KM_K, KM_ITERS, device="cpu")
        rec["model"] = model.centroids.copy()
        rec[("epoch", trial)] = eng.device_epoch
    return body


def test_kmeans_through_a_death(per_thread):
    """Rank 1 dies entering iteration 2's device allreduce: every rank
    ends with the fault-free run's centroids within the float32 bar,
    the counts of every iteration exact, the degraded iteration on the
    host plane and the rest on the device plane, the shard re-staged
    once the plane re-forms."""
    staged = []
    real_prepare = km.prepare_shard

    def counting(*a, **k):
        staged.append(1)
        return real_prepare(*a, **k)
    km.prepare_shard = counting
    try:
        clean, _ = run_world(WORLD, _kmeans_body(per_thread))
        n_clean = len(staged)
        staged.clear()
        got, lives = run_world(WORLD, _kmeans_body(per_thread, {1: 2}))
    finally:
        km.prepare_shard = real_prepare
    assert n_clean == WORLD
    # each life stages once, and the survivors re-stage at the reform;
    # the relaunch's own life sees the reform after its first stage too
    assert lives == [1, 2, 1] and len(staged) == 4 + 3
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["model"], clean[r]["model"],
                                   **F32_TOL)
        for it in range(KM_ITERS):
            g, c = got[r][("stats", it)], clean[r][("stats", it)]
            np.testing.assert_array_equal(g[:, -1], c[:, -1])
            np.testing.assert_allclose(g, c, **F32_TOL)
    for r in (0, 2):
        assert _paths(got[r], 0) == [D, D, H, D]
        assert got[r][("epoch", 0)] == 1
    assert _paths(got[1], 0) == [D, D] and _paths(got[1], 1) == [H, D]
    assert got[1][("epoch", 1)] == 1


def _write_libsvm(tmp_path):
    """kmeans_shard's rows as one libsvm file a rank."""
    for r in range(WORLD):
        sm = SparseMat(**kmeans_shard(r))
        with open(tmp_path / f"data.{r}", "w") as f:
            for i in range(len(sm.indptr) - 1):
                lo, hi = sm.indptr[i], sm.indptr[i + 1]
                f.write("0 " + " ".join(
                    f"{int(j)}:{float(v):.6f}" for j, v in
                    zip(sm.findex[lo:hi], sm.fvalue[lo:hi])) + "\n")
    return str(tmp_path / "data.%d")


def test_kmeans_matches_the_reference_xla_worker(per_thread, tmp_path):
    """The reference's own ``kmeans_run_xla.py`` at world 3 (JAX's gloo
    device plane over the reference's pysocket) and the port's
    device-plane ``kmeans.run`` on threads, on the same libsvm shards:
    the same centroids within the float32 bar."""
    from rabit_tpu.tracker.launch_local import launch

    pattern = _write_libsvm(tmp_path)
    out = str(tmp_path / "ref")
    env = dict(REF_ENV, RABIT_INNER="pysocket", PYTHONPATH=ROOT)
    worker = os.path.join(ROOT, "tests", "workers", "kmeans_run_xla.py")
    code = launch(WORLD, [sys.executable, worker, pattern, str(KM_K),
                          str(KM_ITERS), out], extra_env=env)
    assert code == 0
    want = np.load(out + ".npy")

    def body(eng, trial, rec):
        per_thread.set(eng)
        data = load_libsvm(pattern, rank=eng.rank)
        model = km.run(data, KM_K, KM_ITERS, row_block=32, device="cpu")
        rec["model"] = model.centroids
        rec["stats"] = dict(eng.path_stats)

    got, _ = run_world(WORLD, body)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["model"], want, **F32_TOL)
        assert got[r]["stats"]["device_ops"] == KM_ITERS
        assert got[r]["stats"]["host_ops"] == 0


def _gbdt_body(proxy):
    def body(eng, trial, rec):
        proxy.set(eng)
        x, y = gbdt_shard(eng.rank)
        model = gb.train(x, y, num_round=GB_ROUNDS, max_depth=GB_DEPTH,
                         nbin=GB_NBIN, device="cpu")
        rec["trees"] = [[(n.feature, n.bin_threshold, n.left, n.right,
                          bool(n.default_left), float(n.value)) for n in t]
                        for t in model.trees]
        bins = gb.apply_cuts(x, model.cuts)
        margin = model.margin(bins)
        p = 1.0 / (1.0 + np.exp(-margin))
        rec["loss_sum"] = float(-np.sum(y * np.log(p)
                                        + (1 - y) * np.log(1 - p)))
        rec["stats"] = dict(getattr(eng, "path_stats", {}))
    return body


def _top(tree, levels):
    """The (feature, threshold) of the nodes of the top ``levels``."""
    out, frontier = [], [0]
    for _ in range(levels):
        nxt = []
        for i in frontier:
            n = tree[i]
            out.append(n[:2] if n[0] >= 0 else None)
            if n[0] >= 0:
                nxt += [n[2], n[3]]
        frontier = nxt
    return out


def test_gbdt_device_plane_matches_host_plane(per_thread):
    """``boosting.train`` at world 3 on the device plane (each level's
    histograms through one device allreduce) against the port's
    host-plane run over ``pyrobust``: the top three levels of every
    tree identical, the log-loss within 1e-4 relative."""
    dev, _ = run_world(WORLD, _gbdt_body(per_thread))
    host, _ = run_world(WORLD, _gbdt_body(per_thread), engine=PyRobustEngine)
    loss = {k: sum(r["loss_sum"] for r in recs) / (len(gbdt_shard(0)[1])
                                                   * WORLD)
            for k, recs in (("dev", dev), ("host", host))}
    for r in range(WORLD):
        assert dev[r]["trees"] == dev[0]["trees"]
        for t_dev, t_host in zip(dev[r]["trees"], host[r]["trees"]):
            assert _top(t_dev, 3) == _top(t_host, 3)
        stats = dev[r]["stats"]
        levels = sum(_levels(t, 0) for t in dev[r]["trees"])
        assert stats["host_ops"] == 0 and stats["device_ops"] == levels
    assert abs(loss["dev"] - loss["host"]) / loss["host"] <= 1e-4


def _levels(tree, i):
    """The levels ``train()`` built histograms for under node ``i``
    (one device allreduce each): every level down to the deepest
    split's children, at most ``GB_DEPTH``."""
    n = tree[i]
    if n[0] < 0:
        return 1
    return min(GB_DEPTH, 1 + max(_levels(tree, n[2]), _levels(tree, n[3])))


# ------------------------------------------------- one real launched job
def test_launched_kmeans_survives_a_sigkill(per_thread, tmp_path):
    """Three processes under the port's launcher, ``rabit_engine=xla``
    over ``pyrobust``; rank 1 SIGKILLs itself entering iteration 2's
    device allreduce and is relaunched (``max_restarts=1``).  Every
    rank ends with the centroids of the fault-free thread run within
    the float32 bar, the relaunch came up degraded and the plane was
    re-formed."""
    from rabit_tpu_torch.tracker.launch_local import launch

    env = {"PYTHONPATH": ROOT + os.pathsep + os.path.join(ROOT, "tests"),
           "RABIT_TRACKER_PIN_RANKS": "1"}
    code = launch(WORLD, [sys.executable, os.path.abspath(__file__),
                          str(tmp_path)],
                  extra_env=env, max_restarts=1, heartbeat_sec=0.5)
    assert code == 0
    recs = {}
    for name in sorted(os.listdir(tmp_path)):
        with open(tmp_path / name) as f:
            rec = json.load(f)
        recs[(rec["rank"], rec["life"])] = rec
    assert sorted(recs) == [(0, 0), (1, 1), (2, 0)]
    clean, _ = run_world(WORLD, _kmeans_body(per_thread))
    for rec in recs.values():
        np.testing.assert_allclose(np.asarray(rec["centroids"], np.float32),
                                   clean[rec["rank"]]["model"], **F32_TOL)
        assert rec["epoch"] == 1 and rec["backend"] == "gloo"
    assert recs[(1, 1)]["paths"] == [H, D]
    assert recs[(0, 0)]["paths"] == [D, D, H, D]


def _worker(out_dir):
    """The launched job's rank: k-means on its shard, rank 1's first
    life SIGKILLs itself entering iteration 2's device allreduce."""
    from rabit_tpu_torch import engine as engine_mod

    life = int(os.environ.get("RABIT_RELAUNCH", "0"))
    rabit_tpu_torch.init(rabit_engine="xla")
    eng = engine_mod.get_engine()
    real = eng.allreduce
    paths = []

    def allreduce(buf, op, prepare_fun=None):
        if isinstance(buf, torch.Tensor):
            if eng.rank == 1 and life == 0 and eng.version_number == 2:
                os.kill(os.getpid(), signal.SIGKILL)
            before = eng.path_stats["device_ops"]
            out = real(buf, op, prepare_fun)
            paths.append(D if eng.path_stats["device_ops"] > before else H)
            return out
        return real(buf, op, prepare_fun)
    eng.allreduce = allreduce
    model = km.run(SparseMat(**kmeans_shard(eng.rank)), KM_K, KM_ITERS,
                   device="cpu")
    with open(os.path.join(out_dir, f"rank{eng.rank}.json"), "w") as f:
        json.dump(dict(rank=eng.rank, life=life, paths=paths,
                       epoch=eng.device_epoch,
                       backend=eng.path_stats["backend"],
                       centroids=model.centroids.tolist()), f)
    rabit_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
