"""Reduction operator and data-type registry.

PyTorch-port counterpart of :mod:`rabit_tpu.ops.reduce_ops`: the same
wire-stable op and dtype codes, the host-side numpy reducer, and a torch
reducer for tensors.  The collective lowering (``apply_op_jax``) has its
counterpart in the device-engine slice.
"""
from __future__ import annotations

import enum
from typing import Callable

import numpy as np
import torch


class ReduceOp(enum.IntEnum):
    """Wire/ABI-stable reduction op codes."""

    MAX = 0
    MIN = 1
    SUM = 2
    PROD = 3
    BITOR = 4
    BITAND = 5
    BITXOR = 6


MAX = ReduceOp.MAX
MIN = ReduceOp.MIN
SUM = ReduceOp.SUM
PROD = ReduceOp.PROD
BITOR = ReduceOp.BITOR
BITAND = ReduceOp.BITAND
BITXOR = ReduceOp.BITXOR


class DataType(enum.IntEnum):
    """Wire/ABI-stable dtype codes."""

    INT8 = 0
    UINT8 = 1
    INT32 = 2
    UINT32 = 3
    INT64 = 4
    UINT64 = 5
    FLOAT32 = 6
    FLOAT64 = 7
    BFLOAT16 = 8
    FLOAT16 = 9


_NAME_TO_ENUM: dict[str, DataType] = {
    "int8": DataType.INT8,
    "uint8": DataType.UINT8,
    "int32": DataType.INT32,
    "uint32": DataType.UINT32,
    "int64": DataType.INT64,
    "uint64": DataType.UINT64,
    "float32": DataType.FLOAT32,
    "float64": DataType.FLOAT64,
    "bfloat16": DataType.BFLOAT16,
    "float16": DataType.FLOAT16,
}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def as_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from itself or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return getattr(torch, dtype)
    raise TypeError(f"not a torch dtype: {dtype!r}")


def dtype_to_enum(dtype) -> DataType:
    """Map a torch or numpy dtype (or its name) to the wire enum."""
    name = _dtype_name(dtype)
    if name not in _NAME_TO_ENUM:
        raise TypeError(f"unsupported allreduce dtype: {name}")
    return _NAME_TO_ENUM[name]


_NUMPY_FNS: dict[ReduceOp, Callable] = {
    ReduceOp.MAX: np.maximum,
    ReduceOp.MIN: np.minimum,
    ReduceOp.SUM: np.add,
    ReduceOp.PROD: np.multiply,
    ReduceOp.BITOR: np.bitwise_or,
    ReduceOp.BITAND: np.bitwise_and,
    ReduceOp.BITXOR: np.bitwise_xor,
}


def apply_op_numpy(op: ReduceOp, dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """dst = dst OP src, elementwise, in place when possible."""
    fn = _NUMPY_FNS[ReduceOp(op)]
    return fn(dst, src, out=dst) if dst.flags.writeable else fn(dst, src)


_TORCH_FNS: dict[ReduceOp, Callable] = {
    ReduceOp.MAX: torch.maximum,
    ReduceOp.MIN: torch.minimum,
    ReduceOp.SUM: torch.add,
    ReduceOp.PROD: torch.mul,
    ReduceOp.BITOR: torch.bitwise_or,
    ReduceOp.BITAND: torch.bitwise_and,
    ReduceOp.BITXOR: torch.bitwise_xor,
}

# torch implements only mul and the bitwise ops on its wide unsigned
# types; the rest run on the same-width signed view.  Two's-complement
# addition gives the unsigned bits, and flipping the sign bit maps the
# unsigned order onto the signed one for max/min.
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def apply_op_pairwise(op: ReduceOp, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a OP b`` on tensors (a new tensor)."""
    op = ReduceOp(op)
    signed = _SIGNED_VIEW.get(a.dtype)
    if signed is None or op in (ReduceOp.PROD, ReduceOp.BITOR,
                                ReduceOp.BITAND, ReduceOp.BITXOR):
        return _TORCH_FNS[op](a, b)
    sa, sb = a.view(signed), b.view(signed)
    if op == ReduceOp.SUM:
        return (sa + sb).view(a.dtype)
    flip = torch.iinfo(signed).min
    out = _TORCH_FNS[op](sa ^ flip, sb ^ flip) ^ flip
    return out.view(a.dtype)
