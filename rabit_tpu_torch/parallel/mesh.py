"""Meshes of logical ranks.

Counterpart of :mod:`rabit_tpu.parallel.mesh`.  A JAX mesh is a grid of
chips; here a mesh is a grid of logical ranks, each named by the device
its tensor lives on.  Devices may repeat: until a machine with several
cards is at hand, every rank of a mesh lives on the one card, and the
port's collectives (:mod:`rabit_tpu_torch.parallel.collectives`) take
one tensor per rank.  A ``NamedSharding`` (``replicated``,
``sharded_batch``) has no counterpart: a list of per-rank tensors is the
sharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "dp"


@dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of ``torch.device``, one per rank,
    shaped by the axis sizes; ``axis_names`` name its axes."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def rank_devices(self) -> list:
        """Every rank's device, in rank order (row-major over the axes)."""
        return list(self.devices.reshape(-1))


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over ``devices`` (default: every CUDA device, one
    rank each).

    With no ``axis_sizes``, all ranks go onto one data-parallel axis, as
    in the JAX package.  Pass the same device several times for several
    logical ranks on one card.
    """
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices "
                               "(e.g. ['cpu'] * 8) for logical ranks")
        devices = [f"cuda:{i}" for i in range(count)]
    devs = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = (len(devs),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != len(devs):
        raise ValueError(
            f"mesh axes {tuple(axis_sizes)} do not cover {len(devs)} devices")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(tuple(axis_sizes)), tuple(axis_names))


def local_data_slice(rank: int, world: int, n: int) -> slice:
    """The contiguous row range rank owns under even sharding.

    Ranges are balanced to within one row: the first ``n % world`` ranks
    get one extra.
    """
    base, extra = divmod(n, world)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (1 if rank < extra else 0))
