"""The port's API, engine layer, op registry and package boundary against
the JAX package's, on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rabit_tpu
import rabit_tpu_torch
from rabit_tpu.ops import reduce_ops as jops
from rabit_tpu.utils import serial as jserial
from rabit_tpu_torch.ops import reduce_ops as tops
from rabit_tpu_torch.utils import RabitError
from rabit_tpu_torch.utils import serial as tserial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def engines():
    for pkg in (rabit_tpu, rabit_tpu_torch):
        if pkg.initialized():
            pkg.finalize()
        pkg.init(rabit_engine="empty")
    yield
    for pkg in (rabit_tpu, rabit_tpu_torch):
        pkg.finalize()


# --------------------------------------------------------- empty engine
def test_identity_and_world(engines):
    for pkg in (rabit_tpu, rabit_tpu_torch):
        assert pkg.get_rank() == 0 and pkg.get_world_size() == 1
        assert not pkg.is_distributed() and pkg.device_epoch() == 0
    assert (rabit_tpu_torch.get_processor_name()
            == rabit_tpu.get_processor_name())


def test_allreduce_is_identity(engines):
    called = []
    a = np.arange(6, dtype=np.float32)
    out = rabit_tpu_torch.allreduce(a, rabit_tpu_torch.SUM,
                                    prepare_fun=lambda: called.append(1))
    assert out is a and called == [1]
    np.testing.assert_array_equal(
        out, rabit_tpu.allreduce(np.arange(6, dtype=np.float32)))
    t = torch.arange(4.0)
    assert rabit_tpu_torch.allreduce(t, rabit_tpu_torch.MAX) is t
    assert rabit_tpu_torch.allreduce(3.5) == rabit_tpu.allreduce(3.5)
    np.testing.assert_array_equal(rabit_tpu_torch.allreduce([1, 2]),
                                  rabit_tpu.allreduce([1, 2]))


def test_allreduce_async_is_a_resolved_identity(engines):
    """The empty engine runs the op at issue time and hands back a
    resolved handle, as the JAX package's does."""
    called = []
    a = np.arange(5, dtype=np.int32)
    h = rabit_tpu_torch.allreduce_async(a, rabit_tpu_torch.MAX,
                                        prepare_fun=lambda: called.append(1),
                                        fuse=False)
    assert h.done() and called == [1]
    assert h.wait() is a and h.wait(timeout=0) is a
    want = rabit_tpu.allreduce_async(np.arange(5, dtype=np.int32),
                                     rabit_tpu.MAX, fuse=False).wait()
    np.testing.assert_array_equal(h.wait(), want)
    with pytest.raises(RabitError, match="C-contiguous numpy"):
        rabit_tpu_torch.allreduce_async(np.zeros((4, 4))[:, ::2])
    with pytest.raises(RabitError, match="C-contiguous numpy"):
        rabit_tpu_torch.allreduce_async(torch.zeros(3))


@pytest.mark.parametrize("name", [
    "allgather_async", "allreduce_many", "allreduce_custom",
    "lazy_checkpoint", "AsyncOrderError", "AsyncPumpError"])
def test_api_names_match_jax(name):
    """The async, custom-reduction and lazy-checkpoint names of the JAX
    package's API are the port's too, exported alike."""
    assert name in rabit_tpu.__all__ and name in rabit_tpu_torch.__all__
    ours, theirs = getattr(rabit_tpu_torch, name), getattr(rabit_tpu, name)
    if isinstance(theirs, type):
        assert isinstance(ours, type) and issubclass(ours, RuntimeError)
        assert ours.__mro__[1].__name__ == theirs.__mro__[1].__name__
    else:
        import inspect

        assert (list(inspect.signature(ours).parameters)
                == list(inspect.signature(theirs).parameters))


def test_async_custom_and_many_at_world_one(engines):
    """On the empty engine the new calls are identities with resolved
    handles, as the JAX package's are."""
    for pkg in (rabit_tpu, rabit_tpu_torch):
        h = pkg.allgather_async(np.arange(3))
        assert h.done() and h.wait().shape == (1, 3)
        arrays = [np.arange(4.0), np.ones(2, np.int64)]
        many = pkg.allreduce_many(arrays)
        assert all(m is a for m, a in zip(many, arrays))
        a = np.arange(6.0).reshape(3, 2)
        assert pkg.allreduce_custom(a, np.add) is a
        with pytest.raises(Exception, match="C-contiguous"):
            pkg.allreduce_custom(np.zeros((4, 4))[:, ::2], np.add)
        with pytest.raises(Exception, match="at least one array"):
            pkg.allreduce_many([])


def test_broadcast_and_allgather(engines):
    obj = {"a": [1, 2], "b": "x"}
    assert rabit_tpu_torch.broadcast(obj, 0) == rabit_tpu.broadcast(obj, 0)
    with pytest.raises(RabitError, match="invalid root"):
        rabit_tpu_torch.broadcast(obj, 1)
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = rabit_tpu_torch.allgather(a)
    np.testing.assert_array_equal(got, rabit_tpu.allgather(a))
    assert got.shape == (1, 2, 3)
    t = torch.arange(6).reshape(2, 3)
    gt = rabit_tpu_torch.allgather(t)
    assert isinstance(gt, torch.Tensor) and gt.shape == (1, 2, 3)
    assert torch.equal(gt[0], t)


def test_checkpoints_and_versions(engines):
    for pkg in (rabit_tpu, rabit_tpu_torch):
        assert pkg.load_checkpoint() == (0, None)
        pkg.checkpoint({"w": [1.0]})
        pkg.checkpoint({"w": [2.0]}, local_model=b"raw")
        assert pkg.version_number() == 2
    assert (rabit_tpu_torch.load_checkpoint(with_local=True)
            == rabit_tpu.load_checkpoint(with_local=True)
            == (2, {"w": [2.0]}, b"raw"))


class _Counter(tserial.Serializable):
    def __init__(self, v=0):
        self.v = v

    def save(self, stream):
        stream.write_u64(self.v)

    def load(self, stream):
        self.v = stream.read_u64()


def test_serialization_tags_match_jax(engines):
    for model in (b"bytes", {"k": 1}, [1, 2.5]):
        blob = tserial.serialize_model(model)
        assert blob == jserial.serialize_model(model)
        assert tserial.deserialize_model(blob) == model
    blob = tserial.serialize_model(_Counter(7))
    assert blob[:1] == b"S"
    assert tserial.deserialize_model(blob, _Counter()).v == 7
    with pytest.raises(RabitError, match="Serializable"):
        tserial.deserialize_model(blob)
    with pytest.raises(RabitError, match="not saved from a Serializable"):
        tserial.deserialize_model(tserial.serialize_model(b"x"), _Counter())
    rabit_tpu_torch.checkpoint(_Counter(9))
    version, restored = rabit_tpu_torch.load_checkpoint(
        into_global=_Counter())
    assert version == 1 and restored.v == 9


# ------------------------------------------------------------ engines
@pytest.mark.parametrize("name", ["pyrobust", "native", "xla",
                                  "mock", "mpi", "bogus"])
def test_unported_engines_raise(name):
    with pytest.raises(NotImplementedError,
                       match=f"engine '{name}' is not ported"):
        rabit_tpu_torch.init(rabit_engine=name)
    assert not rabit_tpu_torch.initialized()


def test_tracker_autodetect_raises(monkeypatch):
    monkeypatch.setenv("RABIT_TRACKER_URI", "127.0.0.1")
    with pytest.raises(NotImplementedError, match="not ported"):
        rabit_tpu_torch.init()
    assert not rabit_tpu_torch.initialized()


def test_init_twice_and_uninitialised():
    rabit_tpu_torch.init(["rabit_engine=empty"])
    try:
        with pytest.raises(RabitError, match="already initialised"):
            rabit_tpu_torch.init(rabit_engine="empty")
    finally:
        rabit_tpu_torch.finalize()
    with pytest.raises(RabitError, match="not initialised"):
        rabit_tpu_torch.get_rank()


# --------------------------------------------------------- op registry
def test_codes_match_jax():
    assert {o.name: int(o) for o in tops.ReduceOp} == {
        o.name: int(o) for o in jops.ReduceOp}
    assert {t.name: int(t) for t in tops.DataType} == {
        t.name: int(t) for t in jops.DataType}
    for name in ("int8", "uint8", "int32", "uint32", "int64", "uint64",
                 "float32", "float64", "float16"):
        code = tops.dtype_to_enum(getattr(torch, name))
        assert code == jops.dtype_to_enum(np.dtype(name))
        assert tops.dtype_to_enum(np.dtype(name)) == code
    assert tops.dtype_to_enum(torch.bfloat16) == jops.DataType.BFLOAT16
    with pytest.raises(TypeError):
        tops.dtype_to_enum(torch.complex64)


_INTS = ["int8", "uint8", "int32", "uint32", "int64", "uint64"]
_FLOATS = ["float16", "float32", "float64"]
_ARITH = [tops.MAX, tops.MIN, tops.SUM, tops.PROD]
_BITS = [tops.BITOR, tops.BITAND, tops.BITXOR]
_CASES = ([(op, dt) for op in _ARITH for dt in _INTS + _FLOATS]
          + [(op, dt) for op in _BITS for dt in _INTS])


@pytest.mark.parametrize("op,dtype", _CASES,
                         ids=[f"{o.name}-{d}" for o, d in _CASES])
def test_apply_op_pairwise_matches_numpy(op, dtype):
    rng = np.random.default_rng(int(op) * 31 + len(dtype))
    info = (np.iinfo(dtype) if dtype in _INTS else None)
    if info is not None:
        # the full range: unsigned values past the signed maximum and
        # sums that wrap
        a = rng.integers(info.min, info.max, 64, dtype=dtype, endpoint=True)
        b = rng.integers(info.min, info.max, 64, dtype=dtype, endpoint=True)
    else:
        a = (rng.standard_normal(64) * 10).astype(dtype)
        b = (rng.standard_normal(64) * 10).astype(dtype)
    with np.errstate(over="ignore"):
        want = jops.apply_op_numpy(op, a.copy(), b)
        assert np.array_equal(tops.apply_op_numpy(op, a.copy(), b), want)
    got = tops.apply_op_pairwise(op, torch.from_numpy(a.copy()),
                                 torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", _ARITH, ids=[o.name for o in _ARITH])
def test_apply_op_pairwise_bfloat16(op):
    """bfloat16 has no numpy type here: hold it against numpy float32 on
    bf16-exact inputs, rounded back to bfloat16."""
    rng = np.random.default_rng(int(op))
    a = torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 10
                         ).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 10
                         ).to(torch.bfloat16)
    want = jops.apply_op_numpy(op, a.float().numpy(), b.float().numpy())
    got = tops.apply_op_pairwise(op, a, b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(want).to(torch.bfloat16))


# --------------------------------------------------- package boundary
_ISOLATION = r"""
import importlib, pkgutil, sys
sys.path.insert(0, ROOT)
import rabit_tpu_torch
for m in pkgutil.walk_packages(rabit_tpu_torch.__path__, "rabit_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "triton"
       or k.startswith("triton.")
       or (k.startswith("rabit_tpu") and not k.startswith("rabit_tpu_torch"))]
print("BAD", bad)
print("MODULES", sorted(k for k in sys.modules
                        if k.startswith("rabit_tpu_torch")))
"""


def test_port_imports_no_jax_and_nothing_of_rabit_tpu():
    """Importing every module of the port, and chip_smoke.py, loads no
    jax, no triton and no module of the JAX package."""
    code = _ISOLATION.replace("ROOT", repr(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    for mod in ("rabit_tpu_torch.learn.kmeans", "rabit_tpu_torch.convert",
                "rabit_tpu_torch.ops.kmeans_kernel",
                "rabit_tpu_torch.ops._build",
                "rabit_tpu_torch.ops.histogram_kernel",
                "rabit_tpu_torch.learn.histogram",
                "rabit_tpu_torch.learn.boosting",
                "rabit_tpu_torch.utils.device",
                "rabit_tpu_torch.parallel.mesh",
                "rabit_tpu_torch.parallel.collectives",
                "rabit_tpu_torch.ops.ring_allreduce",
                "rabit_tpu_torch.tools.ici_bench",
                "rabit_tpu_torch.tools.kernel_experiments",
                "rabit_tpu_torch.tools.stats_ab",
                "rabit_tpu_torch.tracker.protocol",
                "rabit_tpu_torch.tracker.tracker",
                "rabit_tpu_torch.transport.base",
                "rabit_tpu_torch.transport.framing",
                "rabit_tpu_torch.transport.tcp",
                "rabit_tpu_torch.transport.factory",
                "rabit_tpu_torch.sched.topo", "rabit_tpu_torch.sched.tuner",
                "rabit_tpu_torch.engine.pysocket",
                "rabit_tpu_torch.transport.pump",
                "rabit_tpu_torch.sched.base", "rabit_tpu_torch.sched.tree",
                "rabit_tpu_torch.sched.ring", "rabit_tpu_torch.sched.halving",
                "rabit_tpu_torch.sched.hier",
                "rabit_tpu_torch.utils.units", "rabit_tpu_torch.utils.net"):
        assert f"'{mod}'" in proc.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA (hidden here even where a card exists) the smoke
    script exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
