"""The port's keepalive launcher with real worker processes, on the CPU.

``rabit_tpu_torch.tracker.launch_local`` starts the port's tracker and
three worker processes of this file (run as a script, the bodies are
under ``if __name__ == "__main__":``), which join through the tracker
URI alone, so ``rabit_tpu_torch.init()`` picks the fault-tolerant
``pyrobust`` engine.  A worker dies at a ``RABIT_MOCK`` kill-point
(exit 254) and is restarted with ``RABIT_NUM_TRIAL`` one higher, or
kills itself with SIGKILL and is relaunched within ``max_restarts``; a
worker that exits with another code aborts the job.  Each life writes
what it saw to a file of its own, which the tests read.  The same
workers run under ``rabit_tpu``'s launcher too, and the port's must
give each rank the same lives, environment and results.
"""
import json
import os
import random
import re
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3
NITER = 3
CKPT = 1 << 20


# ---------------------------------------------------------------- worker
def _worker(mode: str, out_dir: str) -> int:
    """``model_recover``'s iteration (a MAX allreduce, a broadcast, a SUM
    allreduce, a checkpoint), NITER times, through the port's api.
    ``mode`` "sigkill": rank 1's first life kills itself with SIGKILL
    after its first checkpoint; "fail": rank 2 exits with code 3 there;
    "sigstop": rank 1 stops itself with SIGSTOP once, behind a marker
    file beside ``out_dir``, after iteration 1's MAX allreduce."""
    import numpy as np

    import rabit_tpu_torch as rt
    from rabit_tpu_torch import engine as engine_mod

    rt.init()
    eng = engine_mod.get_engine()
    rank, world = rt.get_rank(), rt.get_world_size()
    trial = os.environ["RABIT_NUM_TRIAL"]
    relaunch = os.environ["RABIT_RELAUNCH"]
    version, model = rt.load_checkpoint()
    start = model["iter"] if model is not None else 0
    assert version == start, (version, model)
    seen = {}
    for it in range(start, NITER):
        a = np.arange(100, dtype=np.float32) + rank + it
        rt.allreduce(a, rt.MAX)
        assert (a == np.arange(100, dtype=np.float32) + world - 1 + it).all()
        marker = out_dir + ".stopped"
        if mode == "sigstop" and rank == 1 and it == 1 \
                and not os.path.exists(marker):
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGSTOP)  # hung until killed
        obj = rt.broadcast({"iter": it} if rank == it % world else None,
                           it % world)
        assert obj == {"iter": it}, obj
        b = np.full(100, rank + 1.0)
        rt.allreduce(b, rt.SUM)
        assert (b == world * (world + 1) / 2).all()
        seen[it] = [float(a[0]), float(b[0])]
        rt.checkpoint({"iter": it + 1})
        if it == 0 and relaunch == "0":
            if mode == "sigkill" and rank == 1:
                os.kill(os.getpid(), signal.SIGKILL)
            if mode == "fail" and rank == 2:
                return 3
    with open(os.path.join(out_dir, f"{rank}.{trial}.{relaunch}.json"),
              "w") as f:
        json.dump(dict(engine=type(eng).__name__, start=start, seen=seen,
                       job=eng._job_id, version=rt.version_number(),
                       relaunched=eng.was_relaunched), f)
    rt.finalize()
    return 0


# ------------------------------------------------------------------ test
def _cmd(mode):
    return [sys.executable, os.path.abspath(__file__), "worker", mode]


@pytest.fixture
def out(tmp_path, monkeypatch):
    """Workers find this repository and the result directory in their
    environment; no RABIT_ variable leaks in from outside."""
    for var in [v for v in os.environ if v.startswith("RABIT_")]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("PYTHONPATH", ROOT)
    return tmp_path


def _lives(out_dir):
    """{rank: [(trial, relaunch, record)]} of the lives that finished."""
    got = {}
    for name in sorted(os.listdir(out_dir)):
        rank, trial, relaunch, _ = name.split(".")
        with open(os.path.join(out_dir, name)) as f:
            got.setdefault(int(rank), []).append(
                (int(trial), int(relaunch), json.load(f)))
    return got


def _check_finished(got, restarted, job="default"):
    """Every rank finished once on pyrobust at version NITER, under
    ``job``, with the fault-free values; ``restarted`` maps a rank to
    the (trial, relaunch) of its finishing life and the iteration it
    resumed at."""
    assert sorted(got) == list(range(WORLD))
    for rank, lives in got.items():
        assert len(lives) == 1, lives
        trial, relaunch, rec = lives[0]
        want = restarted.get(rank, (0, 0, 0))
        assert (trial, relaunch, rec["start"]) == want, (rank, rec)
        assert rec["engine"] == "PyRobustEngine"
        assert rec["job"] == job
        assert rec["version"] == NITER
        assert rec["relaunched"] == (rank in restarted)
        assert rec["seen"] == {str(it): [WORLD - 1.0 + it,
                                         WORLD * (WORLD + 1) / 2]
                               for it in range(want[2], NITER)}


def _both_launchers(out, mode, **kw):
    """Run the same workers under the port's launcher, then under
    ``rabit_tpu``'s (its tracker serves the port's engines as it serves
    its own), and return the port's lives once every rank's lives,
    trial and relaunch counts, records and the return code agree."""
    from rabit_tpu.tracker.launch_local import launch as ref_launch
    from rabit_tpu_torch.tracker.launch_local import launch

    got = {}
    for name, run in (("port", launch), ("ref", ref_launch)):
        d = out / name
        d.mkdir()
        code = run(WORLD, _cmd(mode) + [str(d)], **kw)
        got[name] = (code, _lives(d))
    assert got["port"] == got["ref"]
    code, lives = got["port"]
    assert code == 0
    return lives


def test_one_kill_point_death(out):
    """Rank 1 dies entering version 1's broadcast; its second life
    resumes at iteration 1 from the survivors' checkpoint, as under the
    reference's launcher."""
    lives = _both_launchers(out, "model",
                            extra_env={"RABIT_MOCK": "1,1,1,0"})
    _check_finished(lives, {1: (1, 1, 1)})


def test_two_kill_point_deaths(out):
    """Rank 0 dies at v0 before the broadcast, then rank 2 at version
    2's commit: the survivors commit first and serve it version 3.  The
    workers, relaunches included, register under a named tenant."""
    from rabit_tpu_torch.tracker.launch_local import launch

    code = launch(WORLD, _cmd("model") + [str(out)], job="tenant-x",
                  extra_env={"RABIT_MOCK": f"0,0,1,0;2,2,{CKPT},0"})
    assert code == 0
    _check_finished(_lives(out), {0: (1, 1, 0), 2: (1, 1, 3)},
                    job="tenant-x")


def test_sigkill_is_relaunched_within_max_restarts(out):
    """A worker killed by a signal is relaunched (``RABIT_RELAUNCH`` 1,
    ``RABIT_NUM_TRIAL`` still 0) and resumes from version 1, as under
    the reference's launcher."""
    lives = _both_launchers(out, "sigkill", max_restarts=1,
                            restart_backoff_ms=10)
    _check_finished(lives, {1: (0, 1, 1)})


def test_exit_classes_and_backoff_match_reference():
    """The restart code, which exits count as deaths, and the
    supervisor's backoff (same seed, same draws) are the reference's."""
    from rabit_tpu.tracker import launch_local as ref
    from rabit_tpu_torch.tracker import launch_local as port

    assert port.RESTART_EXIT_CODE == ref.RESTART_EXIT_CODE == 254
    for code in (-15, -9, -6, -2, -1, 0, 1, 2, 3, 124, 137, 143, 254, 255):
        assert port.is_dead_exit(code) is ref.is_dead_exit(code), code
    for seed in (0, 7):
        draws = {}
        for name, mod in (("port", port), ("ref", ref)):
            random.seed(seed)
            draws[name] = [mod.restart_delay_ms(n, base)
                           for base in (10.0, 250.0) for n in range(1, 9)]
        assert draws["port"] == draws["ref"]


def test_permanent_failure_aborts_the_job(out):
    """A deliberate non-zero exit is not restarted: the job stops, the
    other workers are terminated and its code is returned, in seconds
    (not the 600 s barrier floor)."""
    from rabit_tpu_torch.tracker.launch_local import launch

    t0 = time.monotonic()
    code = launch(WORLD, _cmd("fail") + [str(out)], max_restarts=2,
                  restart_backoff_ms=10)
    assert code == 3
    assert time.monotonic() - t0 < 60
    assert not os.listdir(out)


def test_cli_runs_the_job_through_a_death(out):
    """The CLI with ``--job``: the tracker admits the named tenant and
    every life, the relaunched one too, registers under it."""
    proc = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launch_local",
         "-n", str(WORLD), "--max-trials", "2", "--job", "tenant-y", "-v",
         "--"]
        + _cmd("model") + [str(out)],
        cwd=ROOT, env=dict(os.environ, RABIT_MOCK="2,0,0,0"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the kill-point names rank 2; the launcher names the worker (task
    # id), whose rank the tracker drew
    assert "[rank2] pyrobust: killed at kill-point v=0 seq=0 trial=0" \
        in proc.stderr
    assert re.search(r"worker \d hit a kill-point; restart #1", proc.stderr)
    assert "tracker: job 'tenant-y' admitted (world 3)" in proc.stderr
    _check_finished(_lives(out), {2: (1, 1, 0)}, job="tenant-y")


def _cli_bounded(args, env, limit):
    """The port's launcher CLI in a session of its own, killed whole
    (a stopped worker too) if it outlives ``limit`` seconds."""
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launch_local"]
        + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _out, err = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the launch outlived its {limit} s limit")
    return proc.returncode, err, time.monotonic() - t0


def test_sigstop_rank_is_evicted_by_heartbeat(out):
    """``tests/test_ckpt.py``'s heartbeat case: rank 1 stops itself
    (SIGSTOP) with the default 600 s link timeout, so only the
    heartbeat can free the survivors.  The tracker's verdict kills it,
    its next life (same ``RABIT_NUM_TRIAL``, ``RABIT_RELAUNCH`` 1)
    resumes from version 1, and the job ends well under a minute."""
    code, err, secs = _cli_bounded(
        ["-n", str(WORLD), "--heartbeat", "0.3", "--"]
        + _cmd("sigstop") + [str(out)], dict(os.environ), 90)
    assert code == 0, err[-3000:]
    assert os.path.exists(f"{out}.stopped")
    assert secs < 60, secs
    assert re.search(r"heartbeat: worker \d declared dead; killing for "
                     r"restart", err), err[-3000:]
    assert re.search(r"task '\d' declared dead by the heartbeat sweep",
                     err)
    _check_finished(_lives(out), {1: (0, 1, 1)})


def test_sigstop_rank_is_replaced_by_watchdog(out):
    """``tests/test_recovery.py``'s watchdog case: with a 3 s link
    timeout the survivors error out of the op and park in the recover
    round, which the stopped rank never joins; the 2 s stall watchdog
    names it and the launcher kills it for a free restart."""
    code, err, secs = _cli_bounded(
        ["-n", str(WORLD), "--watchdog", "2", "--"]
        + _cmd("sigstop") + [str(out)],
        dict(os.environ, RABIT_TIMEOUT_SEC="3"), 90)
    assert code == 0, err[-3000:]
    assert os.path.exists(f"{out}.stopped")
    assert secs < 60, secs
    assert re.search(r"watchdog: worker \d is hung; killing for restart",
                     err), err[-3000:]
    _check_finished(_lives(out), {1: (0, 1, 1)})


@pytest.mark.parametrize("flag,key", [("--watchdog", "watchdog_sec"),
                                      ("--heartbeat", "heartbeat_sec")])
def test_liveness_flags_are_served(flag, key, monkeypatch):
    """``--watchdog``/``--heartbeat`` reach ``launch`` as seconds."""
    from rabit_tpu_torch.tracker import launch_local

    seen = {}
    monkeypatch.setattr(launch_local, "launch",
                        lambda *a, **kw: seen.update(kw) or 0)
    with pytest.raises(SystemExit) as err:
        launch_local.main(["-n", "2", flag, "1.5", "python", "w.py"])
    assert err.value.code == 0
    assert seen[key] == 1.5


@pytest.mark.parametrize("key", ["watchdog_sec", "heartbeat_sec"])
def test_liveness_launch_options_are_served(key, out):
    """``launch`` takes both options; ``heartbeat_sec`` reaches the
    workers as ``RABIT_HEARTBEAT_SEC``.  The workers exit at once with a
    code that says what they saw, which ends the job with it."""
    from rabit_tpu_torch.tracker.launch_local import launch

    check = ("import os, sys; sys.exit(7 if os.environ.get("
             "'RABIT_HEARTBEAT_SEC') == '1.5' else 5)")
    code = launch(2, [sys.executable, "-c", check], **{key: 1.5})
    assert code == (7 if key == "heartbeat_sec" else 5)


def test_ckpt_dir_flag_is_served(monkeypatch):
    """``--ckpt-dir`` reaches ``launch`` as given."""
    from rabit_tpu_torch.tracker import launch_local

    seen = {}
    monkeypatch.setattr(launch_local, "launch",
                        lambda *a, **kw: seen.update(kw) or 0)
    with pytest.raises(SystemExit) as err:
        launch_local.main(["-n", "2", "--ckpt-dir", "/d/{rank}", "python",
                           "w.py"])
    assert err.value.code == 0
    assert seen["ckpt_dir"] == "/d/{rank}"


def test_ckpt_dir_launch_option_is_served(out):
    """``ckpt_dir`` reaches the workers as ``RABIT_CKPT_DIR``; they exit
    at once with a code that says what they saw."""
    from rabit_tpu_torch.tracker.launch_local import launch

    check = ("import os, sys; sys.exit(7 if os.environ.get("
             "'RABIT_CKPT_DIR') == '/d/{rank}' else 5)")
    assert launch(2, [sys.executable, "-c", check],
                  ckpt_dir="/d/{rank}") == 7


@pytest.mark.parametrize("flag,item", [
    ("--obs-dir", "A8"), ("--obs-port", "A8"), ("--trace-dir", "A8")])
def test_refused_flags(flag, item, capsys):
    from rabit_tpu_torch.tracker import launch_local

    with pytest.raises(SystemExit) as err:
        launch_local.main(["-n", "2", flag, "1", "python", "w.py"])
    assert err.value.code == 2
    assert f"{flag} is not ported to rabit_tpu_torch yet (ROADMAP {item})" \
        in capsys.readouterr().err


@pytest.mark.parametrize("key,item", [
    ("obs_dir", "A8"), ("obs_port", "A8"), ("trace_dir", "A8")])
def test_refused_launch_options(key, item):
    """Each raises before a tracker or a worker starts."""
    from rabit_tpu_torch.tracker.launch_local import launch

    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        launch(2, ["false"], **{key: 1})


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        sys.exit(_worker(sys.argv[2], sys.argv[3]))
