"""Error checking and logging helpers.

PyTorch-port counterpart of :mod:`rabit_tpu.utils.checks` (its own copy:
the port imports nothing of the JAX package).  A failed check raises
:class:`RabitError` instead of exiting the process.
"""
from __future__ import annotations

import os
import sys
from typing import NoReturn


class RabitError(RuntimeError):
    """Fatal error raised by the framework's check helpers."""


def error(fmt: str, *args) -> NoReturn:
    raise RabitError((fmt % args) if args else fmt)


def check(cond: bool, fmt: str = "check failed", *args) -> None:
    """User-facing invariant check."""
    if not cond:
        error(fmt, *args)


def log(fmt: str, *args) -> None:
    """Printf-style logging to stderr, tagged by ``RABIT_TPU_LOG_TAG``."""
    msg = (fmt % args) if args else fmt
    tag = os.environ.get("RABIT_TPU_LOG_TAG", "")
    if tag:
        msg = f"[{tag}] {msg}"
    print(msg, file=sys.stderr, flush=True)
