"""Utility layer: checks, logging, checkpoint serialization."""
from rabit_tpu_torch.utils.checks import RabitError, check, error, log
from rabit_tpu_torch.utils.serial import (
    MemoryBufferStream,
    Serializable,
    Stream,
    deserialize_model,
    serialize_model,
)

__all__ = [
    "RabitError", "check", "error", "log",
    "Stream", "MemoryBufferStream", "Serializable",
    "serialize_model", "deserialize_model",
]
