"""Public user-facing API (counterpart of :mod:`rabit_tpu.api`).

numpy arrays are reduced in place; ``torch.Tensor`` inputs go to the
engine as they are (where the JAX package routes ``jax.Array``), so an
engine with a device data plane can keep them on the card.  Python
objects use pickle for broadcast and checkpoints.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Optional

import numpy as np
import torch

from rabit_tpu_torch import engine as _engine_mod
from rabit_tpu_torch.ops import SUM, ReduceOp
from rabit_tpu_torch.utils.checks import check
from rabit_tpu_torch.utils.serial import deserialize_model, serialize_model


def init(args: Optional[list[str]] = None, **params: Any) -> None:
    """Initialise the framework.

    ``args`` accepts ``name=value`` strings; keyword params win on
    conflict.  Environment variables prefixed ``RABIT_`` are read as
    defaults.  ``rabit_engine`` names the engine (only ``empty`` is
    ported).
    """
    merged: dict[str, Any] = {}
    for key, val in os.environ.items():
        if key.startswith("RABIT_"):
            merged[key.lower()] = val
    for a in args or []:
        if "=" in a:
            k, v = a.split("=", 1)
            merged[k] = v
    merged.update(params)
    _engine_mod.init(merged)


def finalize() -> None:
    _engine_mod.finalize()


def initialized() -> bool:
    return _engine_mod.initialized()


def get_rank() -> int:
    return _engine_mod.get_engine().rank


def get_world_size() -> int:
    return _engine_mod.get_engine().world_size


def get_processor_name() -> str:
    return _engine_mod.get_engine().host


def is_distributed() -> bool:
    return _engine_mod.get_engine().is_distributed()


def tracker_print(msg: str) -> None:
    _engine_mod.get_engine().tracker_print(str(msg))


def allreduce(data, op: ReduceOp = SUM,
              prepare_fun: Optional[Callable[[], None]] = None):
    """Allreduce an array across all ranks.

    numpy input is reduced **in place** and returned; a tensor input is
    handed to the engine and its result returned.  ``prepare_fun`` is
    the lazy-preparation hook, skipped when a cached result is replayed.
    """
    eng = _engine_mod.get_engine()
    if isinstance(data, np.ndarray):
        check(data.flags.c_contiguous, "allreduce: array must be C-contiguous")
        return eng.allreduce(data, op, prepare_fun)
    if isinstance(data, torch.Tensor):
        return eng.allreduce(data, op, prepare_fun)
    arr = np.asarray(data)
    scalar = arr.ndim == 0
    arr = np.atleast_1d(arr).copy()
    out = eng.allreduce(arr, op, prepare_fun)
    return out[0] if scalar else out


def allreduce_async(data: np.ndarray, op: ReduceOp = SUM,
                    prepare_fun: Optional[Callable[[], None]] = None,
                    fuse: bool = True):
    """Issue an allreduce without blocking; returns a
    :class:`~rabit_tpu_torch.engine.interface.CollectiveHandle` whose
    ``wait()`` yields the reduced array (the in-place semantics of
    :func:`allreduce`).  ``fuse=False`` asks an engine that buckets small
    ops to dispatch this one at once; engines without an async path run
    the op at issue time and return a resolved handle.
    """
    eng = _engine_mod.get_engine()
    check(isinstance(data, np.ndarray) and data.flags.c_contiguous,
          "allreduce_async: need a C-contiguous numpy array")
    return eng.allreduce_async(data, op, prepare_fun, fuse=fuse)


def broadcast(data: Any, root: int) -> Any:
    """Broadcast a picklable object from ``root`` to all ranks."""
    eng = _engine_mod.get_engine()
    check(0 <= root < eng.world_size, "broadcast: invalid root %d", root)
    payload = pickle.dumps(data) if eng.rank == root else None
    return pickle.loads(eng.broadcast(payload, root))


def allgather(data):
    """Gather each rank's array; shape (world, *data.shape).  Tensors go
    to the engine as they are, everything else through numpy."""
    eng = _engine_mod.get_engine()
    if isinstance(data, torch.Tensor):
        return eng.allgather(data)
    return eng.allgather(np.ascontiguousarray(data))


def load_checkpoint(with_local: bool = False, into_global: Any = None,
                    into_local: Any = None):
    """``(version, global_model)`` (plus ``local_model`` when
    ``with_local``) of the latest checkpoint; version 0 is a fresh start.
    Models checkpointed through a :class:`Serializable` are restored
    into ``into_global``/``into_local``."""
    eng = _engine_mod.get_engine()
    version, g, l = eng.load_checkpoint()
    gobj = (deserialize_model(g, into_global)
            if (g is not None and version > 0) else None)
    if with_local:
        lobj = (deserialize_model(l, into_local)
                if (l is not None and version > 0) else None)
        return version, gobj, lobj
    return version, gobj


def checkpoint(global_model: Any, local_model: Any = None) -> None:
    """Commit a checkpoint of the model(s); bumps the version."""
    _engine_mod.get_engine().checkpoint(
        serialize_model(global_model),
        serialize_model(local_model) if local_model is not None else None)


def version_number() -> int:
    return _engine_mod.get_engine().version_number


def device_epoch() -> int:
    """Device-plane epoch: engines without a device plane report 0."""
    return getattr(_engine_mod.get_engine(), "device_epoch", 0)
