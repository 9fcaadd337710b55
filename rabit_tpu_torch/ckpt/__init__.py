"""rabit_tpu_torch.ckpt — the durable checkpoint tier.

PyTorch-port counterpart of :mod:`rabit_tpu.ckpt`.  On-disk versioned
checkpoints below the robust engine's in-memory replicas: elected
writer ranks persist every committed version to ``rabit_ckpt_dir``
(atomic tmp+fsync+rename, CRC32-stamped blobs, per-writer
``manifest.json``, bounded ``rabit_ckpt_keep`` retention), and the
checkpoint-load path cold-resumes from the newest valid on-disk version
when NO live rank holds one — a kill-all-ranks restart resumes at the
last committed version instead of version 0.
"""
from rabit_tpu_torch.ckpt.store import (CheckpointSkewError, CheckpointStore,
                                        DiskCheckpoint, expand_dir,
                                        pack_blob, unpack_blob)

__all__ = [
    "CheckpointSkewError",
    "CheckpointStore",
    "DiskCheckpoint",
    "expand_dir",
    "pack_blob",
    "unpack_blob",
]
