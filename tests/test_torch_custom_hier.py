"""The port's custom reductions, hierarchical schedule, schedule switching
and lazy checkpoints against rabit_tpu's, on threads in one process.

``allreduce_custom`` folds a Python reducer up the binary tree in chunks
of rows; ``rabit_sched=hier`` reduces into each host group's leader,
rings the leaders and fans the result back out, over the groups the
tracker hands out (forced here with ``RABIT_TRACKER_GROUPS``, one group
id per rank).  A port world and a reference world run the same seeded
inputs and must give the same bits; mixed worlds put port and reference
ranks in one job.  The engines run as in ``tests/test_torch_pysocket.py``,
whose world runner and size/dtype/op ladder this file uses.
"""
import numpy as np
import pytest

import rabit_tpu
import rabit_tpu_torch
from rabit_tpu_torch.utils import RabitError
from test_torch_async import _stream
from test_torch_pysocket import (CONFIGS, OPCODES, OVER, SIZES,  # noqa: F401
                                 _env, _inputs, _ladder, _run_world)

REDUCERS = {"maximum": lambda dst, src: np.maximum(dst, src, out=dst),
            "add": lambda dst, src: np.add(dst, src, out=dst)}
CUSTOM_SHAPES = [(1000,), (300, 17), (5, 3, 4)]


def _custom(reducer):
    def body(eng, kind):
        codes = OPCODES[kind]
        out = {}
        for shape in CUSTOM_SHAPES:
            rng = np.random.default_rng([eng.rank, *shape])
            a = rng.standard_normal(shape).astype(np.float32)
            out[shape] = eng.allreduce_custom(a.copy(), REDUCERS[reducer])
            # the same payload as a tree SUM, forced for this op only
            eng.set_schedule("tree")
            out[shape, "tree"] = eng.allreduce(a.copy(), codes.SUM)
            eng.set_schedule("static")
        return out
    return body


@pytest.mark.parametrize("reducer", sorted(REDUCERS))
@pytest.mark.parametrize("world", [2, 3, 4, 5])
def test_allreduce_custom_matches_reference(world, reducer):
    """(n,), (n, m) and (n, m, p) rows, chunked by a 1 KiB reduce buffer:
    the reference's bits on every rank; ``np.add`` on float32 equals a
    forced-tree SUM bit for bit; ``np.maximum`` equals the exact
    maximum."""
    params = [dict(CONFIGS[r % len(CONFIGS)], rabit_reduce_buffer=1024)
              for r in range(world)]
    got = _run_world(["torch"] * world, _custom(reducer), params)
    want = _run_world(["jax"] * world, _custom(reducer), params)
    for shape in CUSTOM_SHAPES:
        inputs = [np.random.default_rng([r, *shape]).standard_normal(
            shape).astype(np.float32) for r in range(world)]
        for rank in range(world):
            g = got[rank][shape]
            assert g.shape == shape and g.dtype == np.float32
            assert g.tobytes() == want[rank][shape].tobytes()
            assert g.tobytes() == got[0][shape].tobytes()
            if reducer == "add":
                assert g.tobytes() == got[rank][shape, "tree"].tobytes()
            else:
                np.testing.assert_array_equal(g, np.max(inputs, axis=0))


def _raising(eng, kind):
    def reducer(dst, src):
        raise ValueError("reducer refused")
    try:
        eng.allreduce_custom(np.ones((40, 2)), reducer)
    except ValueError as e:
        return "reducer", str(e)
    except OSError as e:
        return "link", type(e).__name__
    return "none", ""


@pytest.mark.parametrize("world", [2, 3])
def test_allreduce_custom_reducer_error_surfaces(world):
    """A reducer that raises surfaces its error on every rank that
    merges (those with tree children); the leaves see their link close,
    in the port as in the reference."""
    params = [{"rabit_timeout_sec": 10}] * world
    for kind in ("torch", "jax"):
        got = _run_world([kind] * world, _raising, params)
        assert got[0] == ("reducer", "reducer refused"), kind
        for rank in range(1, world):
            assert got[rank][0] == "link", (kind, got[rank])


def test_allreduce_custom_at_world_one():
    calls = []

    def body(eng, kind):
        a = np.arange(6.0).reshape(3, 2)
        out = eng.allreduce_custom(a, lambda d, s: calls.append(kind),
                                   prepare_fun=lambda: a.__iadd__(1))
        return out is a, out.tolist()

    for kind in ("torch", "jax"):
        assert _run_world([kind], body)[0] == (
            True, (np.arange(6.0).reshape(3, 2) + 1).tolist())
    assert calls == []


# ------------------------------------------------------------ hierarchical
GROUPS = ["0,0,1", "0,0,1,1", "0,1,0,1,2", "0,0,0,1,1,2"]


@pytest.mark.parametrize("groups", GROUPS)
def test_hier_bit_parity(groups, monkeypatch):
    """Forced ``hier`` over the tracker's groups (a singleton group in
    the first and last shapes, interleaved groups in the third): the
    reference's bits at every size, dtype and op, with mixed pipeline
    configs; every non-empty payload rides hier; integer sums exact."""
    monkeypatch.setenv("RABIT_TRACKER_GROUPS", groups)
    world = len(groups.split(","))
    params = [dict(CONFIGS[r % len(CONFIGS)], rabit_sched="hier")
              for r in range(world)]
    got = _run_world(["torch"] * world, _ladder, params)
    want = _run_world(["jax"] * world, _ladder, params)
    for rank in range(world):
        res, rode = got[rank]
        assert rode == want[rank][1]
        for key, a in res.items():
            assert a.tobytes() == want[rank][0][key].tobytes(), key
            assert a.tobytes() == got[0][0][key].tobytes(), key
    assert {s for (size, _d), s in got[0][1].items() if size} == {"hier"}
    for size in SIZES + [OVER]:
        exact = sum(_inputs(r, size, np.int64, "SUM") for r in range(world))
        np.testing.assert_array_equal(got[0][0][size, "int64", "SUM"], exact)


@pytest.mark.parametrize("tracker", ["torch", "jax"])
def test_hier_mixed_world(tracker, monkeypatch):
    """Port and reference ranks in one ``hier`` world of 4 over two
    groups, under either tracker, with the bits of an all-reference
    world."""
    monkeypatch.setenv("RABIT_TRACKER_GROUPS", "0,1,0,1")
    params = [{"rabit_sched": "hier"}] * 4
    mixed = _run_world(["jax", "torch", "torch", "jax"], _ladder, params,
                       tracker=tracker)
    ref = _run_world(["jax"] * 4, _ladder, params, tracker="jax")
    for rank in range(4):
        assert mixed[rank][1] == ref[rank][1]
        for key, a in ref[rank][0].items():
            assert a.tobytes() == mixed[rank][0][key].tobytes(), key


def test_hier_single_group_falls_back_to_static(monkeypatch):
    """With one group ``hier`` does not apply, so every payload takes the
    static crossover, with the static world's bits."""
    monkeypatch.setenv("RABIT_TRACKER_GROUPS", "0,0,0")
    hier = _run_world(["torch"] * 3, _ladder, [{"rabit_sched": "hier"}] * 3)
    static = _run_world(["torch"] * 3, _ladder)
    for rank in range(3):
        assert hier[rank][1] == static[rank][1]
        assert set(hier[rank][1].values()) == {None, "tree", "ring"}
        for key, a in static[rank][0].items():
            assert a.tobytes() == hier[rank][0][key].tobytes(), key


def test_hier_async_stream(monkeypatch):
    """An async stream under ``hier``: each bucket concatenates and rides
    the hierarchical schedule, with the reference's bits."""
    monkeypatch.setenv("RABIT_TRACKER_GROUPS", "0,0,1,1")
    params = [{"rabit_sched": "hier"}] * 4
    got = _run_world(["torch"] * 4, _stream, params)
    want = _run_world(["jax"] * 4, _stream, params)
    for rank in range(4):
        for (gt, g), (wt, w) in zip(got[rank][0], want[rank][0]):
            assert gt == wt and g.tobytes() == w.tobytes()


# ---------------------------------------------------- schedule switching
SWITCHES = ["static", "tree", "ring", "halving", "static"]


def _switching(eng, kind):
    codes = OPCODES[kind]
    out = []
    for name in SWITCHES:
        eng.set_schedule(name)
        for size in (5, OVER):
            a = _inputs(eng.rank, size, np.float64, "SUM")
            eng.allreduce(a, codes.SUM)
            out.append((name, size, eng._op_sched, a.tobytes()))
    return out


@pytest.mark.parametrize("kinds", [["torch"] * 3, ["jax", "torch", "torch"]],
                         ids=["port", "mixed"])
def test_set_schedule_between_collectives(kinds):
    """Every rank switches the schedule between collectives; each op
    rides the schedule just set, with the reference's bits."""
    got = _run_world(kinds, _switching)
    want = _run_world(["jax"] * 3, _switching)
    assert got == want
    rode = [(name, size, sched) for name, size, sched, _b in got[0]]
    assert rode == [("static", 5, "tree"), ("static", OVER, "ring"),
                    ("tree", 5, "tree"), ("tree", OVER, "tree"),
                    ("ring", 5, "ring"), ("ring", OVER, "ring"),
                    ("halving", 5, "halving"), ("halving", OVER, "halving"),
                    ("static", 5, "tree"), ("static", OVER, "ring")]


def test_set_schedule_refuses_bad_names():
    from rabit_tpu_torch.engine.pysocket import PySocketEngine

    eng = PySocketEngine()
    eng.set_schedule("hier")
    assert eng._sched_name == "hier"
    with pytest.raises(RabitError, match="schedule must be one of"):
        eng.set_schedule("bogus")
    for name in ("auto", "swing", "synth"):
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            eng.set_schedule(name)
    assert eng._sched_name == "hier"


# ------------------------------------------------------- lazy checkpoints
def test_lazy_checkpoint_on_empty():
    for pkg in (rabit_tpu, rabit_tpu_torch):
        if pkg.initialized():
            pkg.finalize()
        pkg.init(rabit_engine="empty")
    try:
        for pkg in (rabit_tpu, rabit_tpu_torch):
            pkg.lazy_checkpoint({"w": [1.5]})
            pkg.lazy_checkpoint([3, 4])
        assert (rabit_tpu_torch.load_checkpoint()
                == rabit_tpu.load_checkpoint() == (2, [3, 4]))
    finally:
        for pkg in (rabit_tpu, rabit_tpu_torch):
            pkg.finalize()


def _lazy(eng, kind):
    calls = []

    def blob():
        calls.append(eng.rank)
        return b"lazy%d" % eng.rank
    eng.checkpoint(None, b"local", lazy_global=blob)
    first = eng.load_checkpoint()
    eng.checkpoint(b"eager", lazy_global=blob)
    return first, eng.load_checkpoint(), calls


def test_lazy_checkpoint_on_pysocket():
    """A lazy global on the pysocket engine serializes at commit (there
    is no recovery to defer to) and an eager one wins over it, as in
    the reference."""
    got = _run_world(["torch"] * 2, _lazy)
    assert got == _run_world(["jax"] * 2, _lazy)
    for rank in range(2):
        assert got[rank] == ((1, b"lazy%d" % rank, b"local"),
                             (2, b"eager", None), [rank])
