"""Single-process no-op engine (counterpart of
:class:`rabit_tpu.engine.empty.EmptyEngine`): world size 1, collectives
are identities on numpy arrays and tensors alike, checkpoints are kept
in memory."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rabit_tpu_torch.engine.interface import Engine
from rabit_tpu_torch.ops import ReduceOp
from rabit_tpu_torch.utils.checks import check


class EmptyEngine(Engine):
    def __init__(self) -> None:
        self._version = 0
        self._global: Optional[bytes] = None
        self._local: Optional[bytes] = None

    def init(self, params: dict) -> None:
        pass

    def shutdown(self) -> None:
        pass

    @property
    def rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1

    def allreduce(self, buf, op: ReduceOp,
                  prepare_fun: Optional[Callable[[], None]] = None):
        if prepare_fun is not None:
            prepare_fun()
        return buf

    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        check(root == 0, "EmptyEngine: root must be 0 in a world of 1")
        check(data is not None, "EmptyEngine: root rank must supply data")
        return data

    def allgather(self, buf):
        if isinstance(buf, torch.Tensor):
            return buf.unsqueeze(0).clone()
        return np.stack([buf])

    def load_checkpoint(self) -> tuple[int, Optional[bytes], Optional[bytes]]:
        return (self._version, self._global, self._local)

    def checkpoint(self, global_model: Optional[bytes],
                   local_model: Optional[bytes] = None,
                   lazy_global: Optional[Callable[[], bytes]] = None
                   ) -> None:
        if global_model is None and lazy_global is not None:
            global_model = lazy_global()
        self._global = global_model
        self._local = local_model
        self._version += 1

    @property
    def version_number(self) -> int:
        return self._version
