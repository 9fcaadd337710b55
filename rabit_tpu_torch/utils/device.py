"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device, app: str) -> torch.device:
    """None means the card.  Asking for CUDA without one is an error,
    never a quiet move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"rabit_tpu_torch {app} runs on a CUDA device "
                           "and none is available; pass device='cpu' to "
                           "run on the CPU")
    return dev
