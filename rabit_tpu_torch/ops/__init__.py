"""Reduction operators, dtype tables and the k-means stats kernels."""
from rabit_tpu_torch.ops.reduce_ops import (
    BITAND,
    BITOR,
    BITXOR,
    MAX,
    MIN,
    PROD,
    SUM,
    DataType,
    ReduceOp,
    apply_op_numpy,
    apply_op_pairwise,
    dtype_to_enum,
)

__all__ = [
    "ReduceOp", "MAX", "MIN", "SUM", "PROD", "BITOR", "BITAND", "BITXOR",
    "DataType", "dtype_to_enum",
    "apply_op_numpy", "apply_op_pairwise",
]
