"""Engine layer (counterpart of :mod:`rabit_tpu.engine`).

Only the ``empty`` engine (world of one) is ported so far.  Every other
engine name, and the tracker-URI autodetect that would pick a networked
engine, raises :class:`NotImplementedError` rather than running on a
different engine than the one asked for.
"""
from __future__ import annotations

import os

from rabit_tpu_torch.engine.interface import Engine
from rabit_tpu_torch.utils.checks import check

_engine: Engine | None = None


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"engine {name!r} is not ported to rabit_tpu_torch yet")


def _make_engine(name: str) -> Engine:
    if name == "empty":
        from rabit_tpu_torch.engine.empty import EmptyEngine

        return EmptyEngine()
    raise _not_ported(name)


def _autodetect(params: dict) -> str:
    """No engine named: a configured tracker would select a networked
    engine (not ported yet), otherwise ``empty``."""
    if "rabit_tracker_uri" in params or "RABIT_TRACKER_URI" in os.environ:
        raise _not_ported("pyrobust")
    return "empty"


def init(params: dict | None = None) -> Engine:
    """Create and initialise the global engine singleton."""
    global _engine
    check(_engine is None, "engine already initialised; call finalize() first")
    params = dict(params or {})
    name = params.pop("rabit_engine", None) or _autodetect(params)
    eng = _make_engine(name)
    eng.init(params)
    _engine = eng
    return eng


def get_engine() -> Engine:
    check(_engine is not None,
          "rabit_tpu_torch is not initialised; call init() first")
    return _engine


def initialized() -> bool:
    return _engine is not None


def is_device_plane() -> bool:
    """True when the active engine reduces tensors over a device data
    plane.  No such engine is ported yet, so always False."""
    return False


def finalize() -> None:
    global _engine
    if _engine is not None:
        _engine.shutdown()
        _engine = None
