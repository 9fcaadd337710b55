"""The port's collective micro-benchmark (``tools/speed_test.py``) and its
sweep runner (``tools/speed_runner.py``) on the CPU, against the JAX
package's (``rabit_tpu.tools.speed_test``, ``speed_runner``).

World 1 runs in this process (the counterpart of
``tests/test_speed_tool.py``'s first case); one world-3 job of the
``pysocket`` engine under the port's launcher runs once for the module
(a few seconds), and its rank 0's printed lines and results file are
checked.  The device leg runs on CPU tensors (``RABIT_TORCH_CPU=1``),
the tests' way to ask for the CPU.  The runner's command lines are
recorded with ``subprocess.run`` replaced; nothing is launched there.
"""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import rabit_tpu_torch
from rabit_tpu.tools import speed_runner as jrunner
from rabit_tpu_torch.tools import speed_runner, speed_test

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"allreduce_max", "allreduce_sum", "broadcast"}
LINE = re.compile(r"^(allreduce_max|allreduce_sum|broadcast): "
                  r"(\d+\.\d+) \+/- (\d+\.\d+) sec, (\d+\.\d+) MB/s"
                  r"(, bus (\d+\.\d+) GB/s)?$")


@pytest.fixture
def port_engine(request):
    name = getattr(request, "param", "empty")
    if rabit_tpu_torch.initialized():
        rabit_tpu_torch.finalize()
    rabit_tpu_torch.init(rabit_engine=name)
    yield name
    rabit_tpu_torch.finalize()


@pytest.fixture(scope="module")
def reference_keys():
    """The reference's result keys at world 1."""
    import rabit_tpu
    from rabit_tpu.tools.speed_test import run

    if rabit_tpu.initialized():
        rabit_tpu.finalize()
    rabit_tpu.init(rabit_engine="empty")
    try:
        results = run(ndata=100, nrep=2)
    finally:
        rabit_tpu.finalize()
    return {name: set(r) for name, r in results.items()}


def _sane(results, nbytes):
    assert set(results) == KEYS
    for name, r in results.items():
        assert r["sec_mean"] > 0.0 and r["sec_std"] >= 0.0
        assert r["mbps"] == pytest.approx(nbytes / r["sec_mean"] / 1e6)
        if "bus_gbps" in r:             # world 1: the bytes over the time
            assert r["bus_gbps"] == pytest.approx(r["mbps"] / 1e3)


@pytest.mark.parametrize("port_engine", ["empty", "xla"], indirect=True)
def test_world1_numpy_leg_has_the_reference_keys(port_engine,
                                                 reference_keys):
    results = speed_test.run(ndata=1000, nrep=3)
    assert {n: set(r) for n, r in results.items()} == reference_keys
    _sane(results, 4000)


@pytest.mark.parametrize("port_engine", ["empty", "xla"], indirect=True)
def test_world1_device_leg_on_cpu_tensors(port_engine, monkeypatch,
                                          reference_keys):
    monkeypatch.setenv("RABIT_TORCH_CPU", "1")
    assert speed_test.leg_device() == torch.device("cpu")
    results = speed_test.run(ndata=2048, nrep=3, device=True)
    assert {n: set(r) for n, r in results.items()} == reference_keys
    _sane(results, 8192)


def test_device_leg_without_a_card_raises(port_engine, monkeypatch):
    monkeypatch.delenv("RABIT_TORCH_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        speed_test.run(ndata=16, nrep=1, device=True)


def test_checkpoint_every_commits(port_engine):
    """RABIT_SPEED_CHECKPOINT's mode: a commit every k ops of each
    allreduce loop."""
    speed_test.run(ndata=64, nrep=6, checkpoint_every=2)
    assert rabit_tpu_torch.version_number() == 6


# ------------------------------------------------------------ world 3
@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    """One job of three ``pysocket`` ranks under the port's launcher;
    the launcher's output (rank 0's tracker prints) and the results file
    that RABIT_OBS_DIR names."""
    obs = tmp_path_factory.mktemp("obs")
    env = {k: v for k, v in os.environ.items() if not k.startswith("RABIT_")}
    env.update(PYTHONPATH=ROOT, RABIT_ENGINE="pysocket",
               RABIT_OBS_DIR=str(obs))
    proc = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launch_local",
         "-n", "3", "--", sys.executable, "-m",
         "rabit_tpu_torch.tools.speed_test", "5000", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = {}
    for line in proc.stdout.splitlines():
        m = LINE.match(line.strip())
        if m:
            assert m.group(1) not in lines, "a line printed twice"
            lines[m.group(1)] = m
    with open(obs / "speed_results.json") as f:
        return lines, json.load(f), proc.stderr


@pytest.mark.parametrize("name", sorted(KEYS))
def test_world3_rank0_prints_each_line_once(world3, name):
    """Rank 0's line is its results, as the reference formats them; the
    rates follow from the mean time (20,000 B a call), the bus rate at
    2(n-1)/n of the bytes rate."""
    lines, dump, _ = world3
    r = dump["results"][name]
    want = ("%s: %.6f +/- %.6f sec, %.2f MB/s"
            % (name, r["sec_mean"], r["sec_std"], r["mbps"]))
    if name == "broadcast":
        assert "bus_gbps" not in r
    else:
        want += ", bus %.3f GB/s" % r["bus_gbps"]
        assert r["bus_gbps"] == pytest.approx(4 / 3 * r["mbps"] / 1e3)
    assert lines[name].group(0) == want
    assert r["sec_mean"] > 0 and \
        r["mbps"] == pytest.approx(20000 / r["sec_mean"] / 1e6)


def test_world3_results_file(world3):
    _, dump, stderr = world3
    assert (dump["ndata"], dump["nrep"], dump["device"], dump["world"]) == \
        (5000, 4, False, 3)
    assert set(dump["results"]) == KEYS
    assert "speed_results.json only" in stderr   # the engines' obs: A8


# ------------------------------------------------------------ the runner
@pytest.fixture
def recorded(monkeypatch):
    calls = []

    class Done:
        returncode = 0

    def run(cmd, env=None, **kw):
        calls.append((cmd, env))
        return Done()
    monkeypatch.setattr(subprocess, "run", run)
    return calls


def test_runner_builds_the_reference_command_lines(recorded, monkeypatch):
    """The same grid, engines and order as the reference's runner, each
    cell the port's launcher over the port's speed_test."""
    monkeypatch.delenv("RABIT_GLOBAL_REPLICA", raising=False)
    assert speed_runner.GRID == jrunner.GRID
    assert speed_runner.main(["--workers", "3", "--engines",
                              "pysocket,xla"]) == 0
    want = [[c.replace("rabit_tpu.", "rabit_tpu_torch.") for c in
             [sys.executable, "-m", "rabit_tpu.tracker.launch_local", "-n",
              "3", "--", sys.executable, "-m", "rabit_tpu.tools.speed_test",
              str(n), str(r)]] for _ in ("pysocket", "xla")
            for n, r in jrunner.GRID]
    assert [cmd for cmd, _ in recorded] == want
    assert [env["RABIT_ENGINE"] for _, env in recorded] == \
        ["pysocket"] * 3 + ["xla"] * 3


def test_runner_replica_and_a_failed_cell(recorded, monkeypatch):
    monkeypatch.delenv("RABIT_GLOBAL_REPLICA", raising=False)

    class Failed:
        returncode = 3
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, env=None, **kw: recorded.append(
                            (cmd, env)) or Failed())
    assert speed_runner.main(["--engines", "pysocket", "--replica",
                              "1"]) == 3
    assert len(recorded) == 1                 # stops at the failed cell
    assert recorded[0][1]["RABIT_GLOBAL_REPLICA"] == "1"
    assert recorded[0][0][4] == "4"           # --workers defaults to 4


@pytest.mark.parametrize("argv", [[], ["--engines", "native"],
                                  ["--engines", "pysocket,mpi"],
                                  ["--engines", "mpi_allreduce"]])
def test_runner_refuses_the_native_and_mpi_legs(recorded, argv):
    """Before anything is launched, and by name."""
    with pytest.raises(NotImplementedError, match="A8k"):
        speed_runner.main(argv)
    assert recorded == []


def test_speed_tools_import_nothing_of_jax():
    for mod in (speed_test, speed_runner):
        src = open(mod.__file__).read()
        assert not re.search(r"^\s*(import|from)\s+(jax|rabit_tpu)\b", src,
                             re.M)
