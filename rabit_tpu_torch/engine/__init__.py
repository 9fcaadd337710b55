"""Engine layer (counterpart of :mod:`rabit_tpu.engine`).

Ported so far: ``empty`` (world of one), ``pysocket`` (pure-Python
TCP, non-fault-tolerant), ``pyrobust`` (the same links with
checkpoint/replay recovery) and ``xla`` (tensors on a
``torch.distributed`` device plane, a host engine for the control
plane; :mod:`rabit_tpu_torch.engine.xla`).  Every other engine name raises
:class:`NotImplementedError` rather than running on a different engine
than the one asked for.  With no engine named, a tracker URI selects
``pyrobust``, as the reference does when its native library is absent,
so that fault tolerance never silently disappears (the native engines
are not ported, ROADMAP A8); otherwise ``empty``.
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
    if name == "pysocket":
        from rabit_tpu_torch.engine.pysocket import PySocketEngine

        return PySocketEngine()
    if name == "pyrobust":
        from rabit_tpu_torch.engine.robust import PyRobustEngine

        return PyRobustEngine()
    if name == "xla":
        from rabit_tpu_torch.engine.xla import XLAEngine

        return XLAEngine()
    raise _not_ported(name)


def _autodetect(params: dict) -> str:
    """No engine named: a configured tracker selects the fault-tolerant
    ``pyrobust`` (the reference's pick without its native library),
    otherwise ``empty``."""
    if "rabit_tracker_uri" in params or "RABIT_TRACKER_URI" in os.environ:
        return "pyrobust"
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
    """True when the active engine reduces tensors over the device data
    plane (the xla engine in a multi-process world): apps keep such
    payloads on their device instead of converting to numpy."""
    if _engine is None or not _engine.is_distributed():
        return False
    from rabit_tpu_torch.engine.xla import XLAEngine

    return isinstance(_engine, XLAEngine)


def finalize() -> None:
    global _engine
    if _engine is not None:
        _engine.shutdown()
        _engine = None
