"""The linear learner and its L-BFGS solver, the port against rabit_tpu,
on the CPU.

The same seeded numpy inputs go through :mod:`rabit_tpu.learn` and
:mod:`rabit_tpu_torch.learn` (``linear_device=cpu``): ``eval`` and
``calc_grad`` at several weights for both losses, with ragged rows
(slot padding), a row count off the row block (row padding) and
features past ``num_feature``, within the JAX tests' float32 bar
(``rtol=1e-4, atol=1e-3``); the solver's objective at every iteration
and its final weights on the reference's quadratic (float64 on the host
on both sides: ``rtol=1e-12``) and on logistic regression with L1
(OWL-QN; the objective's float32 device sums differ in order:
``rtol=1e-5`` for the objective, ``atol=1e-3`` for the weights); model
files byte for byte both ways; ``convert.linear_from_jax``; the CLI.
Worlds of three rank threads under the port's pysocket and pyrobust
engines train on row shards and must match a world-1 run on all rows
within the reference's own distributed bar (``rtol=atol=1e-3``,
``tests/test_learn_dist.py``), and a pyrobust world through one death
resumes from the solver's (global, local) checkpoint bit for bit with
its fault-free run.  ``api.allreduce``'s ``codec`` keyword is accepted
on every port engine and changes no byte.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rabit_tpu
from rabit_tpu.learn import lbfgs as jlbfgs
from rabit_tpu.learn import linear as jlinear
from rabit_tpu.learn.data import SparseMat as JSparseMat
import rabit_tpu_torch
from rabit_tpu_torch import convert
from rabit_tpu_torch import engine as engine_mod
from rabit_tpu_torch.learn import lbfgs, linear
from rabit_tpu_torch.learn.data import SparseMat
from test_torch_pysocket import _run_world as socket_world
from test_torch_robust import _PerThread, _mock
from test_torch_robust import _run_world as robust_world
from test_torch_xla import run_world as xla_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-4, atol=1e-3)
HOST_RTOL = 1e-12        # float64 host math, the same ops on both sides
OBJ_RTOL = 1e-5          # objective values of float32 device sums
W_ATOL = 1e-3            # final weights after float32 objectives
DIST_TOL = dict(rtol=1e-3, atol=1e-3)
WORLD = 3
DIST_PARAMS = dict(objective="logistic", reg_L2="0.1", max_lbfgs_iter="25",
                   silent="1", row_block="64")


@pytest.fixture
def engines():
    """World-of-one engines in both packages."""
    for pkg in (rabit_tpu, rabit_tpu_torch):
        if pkg.initialized():
            pkg.finalize()
    rabit_tpu.init(rabit_engine="empty")
    rabit_tpu_torch.init(rabit_engine="empty")
    yield
    for pkg in (rabit_tpu, rabit_tpu_torch):
        if pkg.initialized():
            pkg.finalize()


@pytest.fixture
def pinned(monkeypatch):
    """Ranks pinned to task ids; nothing of the caller's environment
    reaches the engines."""
    monkeypatch.setenv("RABIT_TRACKER_PIN_RANKS", "1")
    for var in ("RABIT_TRACKER_SHUFFLE", "RABIT_TRACKER_GROUPS",
                "RABIT_TIMEOUT_SEC", "RABIT_MOCK", "RABIT_NUM_TRIAL",
                "RABIT_RELAUNCH", "RABIT_TRACKER_URI", "RABIT_TRACKER_PORT",
                "RABIT_TASK_ID", "RABIT_CKPT_DIR", "RABIT_ELASTIC"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def per_thread(monkeypatch):
    proxy = _PerThread()
    monkeypatch.setattr(engine_mod, "_engine", proxy)
    return proxy


# ------------------------------------------------------------------ data
def _csr(seed, n=500, d=12, ragged=False, noisy=True):
    """Seeded rows: a CSR dict, the dense matrix and logistic labels from
    a planted model (noisy labels keep the optimum well conditioned).
    ``ragged`` drops about a third of the entries, so rows differ in
    length (slot padding) and some are empty."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    p = 1.0 / (1.0 + np.exp(-(x @ w)))
    y = (p > (rng.random(n) if noisy else 0.5)).astype(np.float32)
    keep = rng.random((n, d)) > 0.35 if ragged else np.ones((n, d), bool)
    x = np.where(keep, x, 0.0).astype(np.float32)
    rows, cols = np.nonzero(keep)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int64)
    csr = dict(indptr=indptr, findex=cols.astype(np.int32),
               fvalue=x[rows, cols].astype(np.float32), labels=y,
               feat_dim=d)
    return csr, x, y


def _pair(csr, **params):
    """The reference's objective and the port's on the same rows."""
    objs = []
    for mod, sm, extra in ((jlinear, JSparseMat, {}),
                           (linear, SparseMat, {"linear_device": "cpu"})):
        obj = mod.LinearObjFunction()
        obj.dtrain = sm(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                           for k, v in csr.items()})
        for k, v in {**params, **extra}.items():
            obj.set_param(k, str(v))
        objs.append(obj)
    return objs


def _write_libsvm(path, x, y):
    with open(path, "w") as f:
        for row, lab in zip(x, y):
            f.write(f"{lab:g} " + " ".join(f"{j}:{v:.6g}"
                                            for j, v in enumerate(row)
                                            if v != 0.0) + "\n")


# -------------------------------------------------------- eval and grad
@pytest.mark.parametrize("objective", ["linear", "logistic"])
@pytest.mark.parametrize("case", ["full", "ragged", "out_of_range"])
def test_eval_and_grad_match_reference(engines, objective, case):
    """Both losses at three weights each: the row count is no multiple
    of the row block, ragged rows pad their slots, and with
    ``num_feature`` below the data's width the features past it route
    to the zero slot; rank 0 adds the L2 term."""
    csr, _x, _y = _csr(3, ragged=case != "full")
    nf = csr["feat_dim"] - (3 if case == "out_of_range" else 0)
    objs = _pair(csr, objective=objective, reg_L2=0.5, row_block=64)
    for obj in objs:
        obj.model.num_feature = nf
        if objective == "logistic":
            obj.model.init_base_score()
    rng = np.random.default_rng(5)
    for w in (np.zeros(nf + 1), 0.1 * rng.standard_normal(nf + 1),
              3.0 * rng.standard_normal(nf + 1)):
        ref, port = (o.eval(w.copy()) for o in objs)
        np.testing.assert_allclose(port, ref, **F32_TOL)
        gref, gport = (o.calc_grad(w.copy()) for o in objs)
        assert gport.dtype == np.float64 and gport.shape == (nf + 1,)
        np.testing.assert_allclose(gport, gref, **F32_TOL)


def test_ell_blocks_stay_resident(engines):
    """The blocks are staged once, int32 and float32, and the solver's
    evaluations reuse them."""
    csr, _x, _y = _csr(4, n=130, ragged=True)
    obj = _pair(csr, row_block=64)[1]
    obj.model.num_feature = csr["feat_dim"]
    blocks = obj._ell_blocks()
    slots = int(np.diff(csr["indptr"]).max())
    assert [tuple(b.shape) for b in blocks] == [
        (3, 64, slots), (3, 64, slots), (3, 64), (3, 64)]
    assert blocks[0].dtype == torch.int32 and blocks[1].dtype == torch.float32
    obj.eval(np.zeros(csr["feat_dim"] + 1))
    assert obj._ell_blocks() is blocks
    assert int(blocks[0].max()) == csr["feat_dim"] + 1  # the zero slot


def test_cuda_without_a_card_is_an_error(engines):
    if torch.cuda.is_available():
        pytest.skip("this test holds the CPU-only behaviour")
    csr, _x, _y = _csr(4, n=10)
    obj = linear.LinearObjFunction()
    obj.dtrain = SparseMat(**csr)
    obj.model.num_feature = csr["feat_dim"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        obj.eval(np.zeros(csr["feat_dim"] + 1))
    with pytest.raises(Exception, match="linear_device"):
        obj.set_param("linear_device", "tpu")


# --------------------------------------------------------------- solver
class _Quadratic:
    """f(w) = 0.5 ||w - t||^2, the reference's test objective."""

    def __init__(self, target):
        self.target = target

    def eval(self, w):
        return 0.5 * float((w - self.target) @ (w - self.target))

    def calc_grad(self, w):
        return w - self.target

    def init_num_dim(self):
        return len(self.target)

    def init_model(self, w):
        w[:] = 0.0

    def save_state(self):
        return None

    def load_state(self, state):
        pass


def _trace(solver):
    """``run()``, with the objective after every iteration."""
    solver.init()
    vals = [solver.old_objval]
    while solver.num_iteration < solver.max_lbfgs_iter:
        done = solver.update_one_iter()
        vals.append(solver.new_objval if done else solver.old_objval)
        if done:
            break
    return vals, solver.get_weight()


def test_lbfgs_quadratic_matches_reference(engines):
    target = np.random.default_rng(0).standard_normal(32)
    got = []
    for mod in (jlbfgs, lbfgs):
        solver = mod.LBFGSSolver(_Quadratic(target))
        solver.silent = 1
        solver.lbfgs_stop_tol = 1e-10
        got.append(_trace(solver) + (solver.num_iteration,))
    (rvals, rw, rit), (vals, w, it) = got
    assert it == rit and len(vals) == len(rvals)
    np.testing.assert_allclose(vals, rvals, rtol=HOST_RTOL, atol=1e-300)
    np.testing.assert_allclose(w, rw, rtol=HOST_RTOL, atol=1e-14)
    np.testing.assert_allclose(w, target, atol=1e-4)


def test_lbfgs_l1_sparsity_matches_reference(engines):
    """OWL-QN: the irrelevant features go to exact zero, as in the
    reference's test, iteration for iteration beside the reference."""
    rng = np.random.default_rng(0)
    n, d = 400, 12
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_true = np.zeros(d)
    w_true[:3] = [2.0, -3.0, 1.5]
    y = (1 / (1 + np.exp(-(x @ w_true))) > 0.5).astype(np.float32)
    csr = dict(indptr=np.arange(n + 1, dtype=np.int64) * d,
               findex=np.tile(np.arange(d, dtype=np.int32), n),
               fvalue=x.reshape(-1), labels=y, feat_dim=d)
    got = []
    for obj in _pair(csr, objective="logistic", reg_L1=2.0,
                     max_lbfgs_iter=60, silent=1, row_block=128):
        got.append(_trace(obj.lbfgs) + (obj.lbfgs.num_iteration,))
    (rvals, rw, rit), (vals, w, it) = got
    assert it == rit and len(vals) == len(rvals)
    np.testing.assert_allclose(vals, rvals, rtol=OBJ_RTOL)
    np.testing.assert_allclose(w, rw, atol=W_ATOL)
    assert abs(w[0]) > 0.1 and abs(w[1]) > 0.1
    assert np.sum(w[3:d] == 0.0) >= 5
    assert ((w == 0.0) == (rw == 0.0)).all()


def test_logistic_train_matches_reference(engines, tmp_path):
    """``run()`` end to end: the objective falls every iteration, the
    weights and accuracy match the reference's."""
    csr, x, y = _csr(7, n=240, d=10)
    got = []
    for obj in _pair(csr, model_out=tmp_path / "m", **DIST_PARAMS):
        vals, w = _trace(obj.lbfgs)
        obj.model.weight = np.asarray(w, np.float64)
        got.append((vals, w, obj.predict()))
    (rvals, rw, rpred), (vals, w, pred) = got
    assert all(b < a for a, b in zip(vals, vals[1:]))
    np.testing.assert_allclose(vals, rvals, rtol=OBJ_RTOL)
    np.testing.assert_allclose(w, rw, atol=W_ATOL)
    assert ((pred > 0.5) == (rpred > 0.5)).mean() > 0.99
    np.testing.assert_allclose(pred, rpred, atol=1e-3)


# ----------------------------------------------------------- model IO
def _model(mod, seed, nf=9, loss=1):
    m = mod.LinearModel()
    m.num_feature, m.loss_type = nf, loss
    rng = np.random.default_rng(seed)
    m.base_score = float(rng.standard_normal())
    m.weight = rng.standard_normal(nf + 1)
    return m


@pytest.mark.parametrize("b64", [False, True])
def test_model_files_byte_for_byte(tmp_path, b64):
    """The port's file is the reference's, byte for byte, and each
    package loads the other's."""
    for loss in (0, 1):
        ref, port = _model(jlinear, loss, loss=loss), _model(linear, loss,
                                                             loss=loss)
        ref.save(str(tmp_path / "ref"), b64)
        port.save(str(tmp_path / "port"), b64)
        raw = (tmp_path / "port").read_bytes()
        assert raw == (tmp_path / "ref").read_bytes()
        assert raw.startswith(b"bs64\t" if b64 else b"binf")
        for mod, name in ((linear, "ref"), (jlinear, "port")):
            back = mod.LinearModel()
            back.load(str(tmp_path / name))
            assert (back.num_feature, back.loss_type) == (9, loss)
            assert back.base_score == np.float32(ref.base_score)
            np.testing.assert_array_equal(
                back.weight, ref.weight.astype(np.float32))


def test_model_file_rejects_a_bad_header(tmp_path):
    (tmp_path / "bad").write_bytes(b"nope" + bytes(80))
    with pytest.raises(Exception, match="invalid model file"):
        linear.LinearModel().load(str(tmp_path / "bad"))


def test_linear_from_jax(engines, tmp_path):
    """A trained JAX model carried over predicts what it predicts and
    saves the same bytes; bad parts raise."""
    csr, _x, _y = _csr(9, n=150, d=8)
    ref = _pair(csr, **DIST_PARAMS)[0]
    ref.lbfgs.run()
    ref.model.weight = np.asarray(ref.lbfgs.get_weight(), np.float64)
    jm = ref.model
    port = convert.linear_from_jax(np.asarray(jm.weight), jm.base_score,
                                   jm.num_feature, jm.loss_type)
    assert isinstance(port, linear.LinearModel)
    np.testing.assert_allclose(port.predict(SparseMat(**csr)),
                               jm.predict(JSparseMat(**csr)), rtol=1e-12)
    port.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "ref"))
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    w = np.asarray(jm.weight)
    with pytest.raises(TypeError):
        convert.linear_from_jax(w.astype(np.int64), 0.0, jm.num_feature, 1)
    for args in ((w[:-1], 0.0, jm.num_feature, 1), (w, 0.0, -1, 1),
                 (w, 0.0, jm.num_feature, 2),
                 (w, float("nan"), jm.num_feature, 1)):
        with pytest.raises(ValueError):
            convert.linear_from_jax(*args)


def test_cli_train_and_pred(engines, tmp_path):
    """``python -m rabit_tpu_torch.learn.linear`` trains what the
    reference's CLI trains; ``task=pred`` writes one prediction a row."""
    _csr_, x, y = _csr(11, n=200, d=6)
    data = tmp_path / "train.libsvm"
    _write_libsvm(data, x, y)
    args = ["objective=logistic", "reg_L2=0.1", "max_lbfgs_iter=20",
            "silent=1", "row_block=64"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.learn.linear", str(data)]
        + args + ["linear_device=cpu", f"model_out={tmp_path / 'port'}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rabit_tpu.finalize()
    assert jlinear.main(["linear", str(data)] + args
                        + [f"model_out={tmp_path / 'ref'}"]) == 0
    rabit_tpu.init(rabit_engine="empty")
    port, ref = linear.LinearModel(), jlinear.LinearModel()
    port.load(str(tmp_path / "port"))
    ref.load(str(tmp_path / "ref"))
    assert (port.num_feature, port.loss_type, port.base_score) == (
        ref.num_feature, ref.loss_type, ref.base_score)
    np.testing.assert_allclose(port.weight, ref.weight, atol=W_ATOL)
    rabit_tpu_torch.finalize()
    assert linear.main(["linear", str(data), "task=pred", "linear_device=cpu",
                        f"model_in={tmp_path / 'port'}",
                        f"name_pred={tmp_path / 'pred.txt'}"]) == 0
    rabit_tpu_torch.init(rabit_engine="empty")
    pred = np.loadtxt(tmp_path / "pred.txt")
    assert pred.shape == (200,)
    np.testing.assert_allclose(pred, ref.predict(JSparseMat(**_csr_)),
                               atol=1e-3)


# ------------------------------------------------------------ world 3
def _shard(csr, rank, world):
    """Rank ``rank``'s contiguous rows of a CSR dict."""
    n = len(csr["indptr"]) - 1
    lo, hi = rank * n // world, (rank + 1) * n // world
    a, b = csr["indptr"][lo], csr["indptr"][hi]
    return dict(indptr=csr["indptr"][lo:hi + 1] - a,
                findex=csr["findex"][a:b], fvalue=csr["fvalue"][a:b],
                labels=csr["labels"][lo:hi], feat_dim=csr["feat_dim"])


def _train(csr, rank, world):
    obj = linear.LinearObjFunction()
    obj.dtrain = SparseMat(**_shard(csr, rank, world))
    for k, v in {**DIST_PARAMS, "linear_device": "cpu"}.items():
        obj.set_param(k, v)
    obj.lbfgs.run()
    return obj.lbfgs.get_weight()


def _world1(csr, per_thread):
    """All rows at world 1, on this thread's empty engine."""
    eng = engine_mod._make_engine("empty")
    eng.init({})
    per_thread.set(eng)
    return _train(csr, 0, 1)


def test_world3_pysocket_matches_world1(pinned, per_thread):
    csr, _x, _y = _csr(7, n=240, d=10)

    def body(eng, kind):
        per_thread.set(eng)
        return _train(csr, eng.rank, WORLD)
    out = socket_world(["torch"] * WORLD, body)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(out[r], out[0])
    np.testing.assert_allclose(out[0], _world1(csr, per_thread), **DIST_TOL)


def test_world3_pyrobust_death_resumes_from_the_solver_checkpoint(
        pinned, per_thread):
    """Rank 1 dies entering iteration 3's gradient allreduce (version 2,
    seqno 0); its relaunch restores the solver's global state and its
    history shard from the checkpoint and the world ends bit for bit
    where the fault-free world does, which matches world 1."""
    csr, _x, _y = _csr(7, n=240, d=10)

    def body(eng, kind, trial, rec):
        per_thread.set(eng)
        w = _train(csr, eng.rank, WORLD)
        rec["w"] = w.tolist()
        rec["version"] = eng.version_number
    clean, clean_lives = robust_world(["torch"] * WORLD, body)
    got, lives = robust_world(["torch"] * WORLD, body, mock=[(1, 2, 0, 0)])
    assert clean_lives == [1, 1, 1] and lives == [1, 2, 1]
    for r in range(WORLD):
        assert got[r] == clean[r], r
    np.testing.assert_allclose(clean[0]["w"], _world1(csr, per_thread), **DIST_TOL)


# ---------------------------------------------------------------- codec
def _codec_body(eng, rank):
    """Each op twice, ``codec=True`` and ``codec=False``: the same
    bytes, which are the numpy sum."""
    out = []
    for dtype in (np.float64, np.float32, np.int64):
        a = (np.arange(7) * (rank + 1.5)).astype(dtype)
        got = [rabit_tpu_torch.allreduce(a.copy(), rabit_tpu_torch.SUM,
                                         codec=c).tobytes()
               for c in (True, False)]
        assert got[0] == got[1]
        out.append(got[0])
    return out


def _codec_want(world):
    return [sum((np.arange(7) * (r + 1.5)).astype(dtype)
                for r in range(world)).astype(dtype).tobytes()
            for dtype in (np.float64, np.float32, np.int64)]


@pytest.mark.parametrize("engine", ["empty", "pysocket", "pyrobust", "xla"])
def test_allreduce_codec_keyword(engine, pinned, per_thread):
    if engine == "empty":
        eng = engine_mod._make_engine("empty")
        eng.init({})
        per_thread.set(eng)
        assert _codec_body(eng, 0) == _codec_want(1)
        return
    got = {}

    def body(eng, *rest):
        per_thread.set(eng)
        got[eng.rank] = _codec_body(eng, eng.rank)
        if engine == "xla":
            t = torch.arange(4.0) + eng.rank
            assert torch.equal(
                rabit_tpu_torch.allreduce(t, rabit_tpu_torch.SUM,
                                          codec=False),
                torch.arange(4.0) * WORLD + 3)
    if engine == "pysocket":
        socket_world(["torch"] * WORLD, body)
    elif engine == "pyrobust":
        robust_world(["torch"] * WORLD, body)
    else:
        xla_world(WORLD, body)
    assert got == {r: _codec_want(WORLD) for r in range(WORLD)}
