"""Device resolution for the port's entry points.

Every entry point (`LLMServer`, `ServingEngine`, `launch/serve.py`)
runs on CUDA unless the caller names another device.  Without a GPU and
without an explicit device it raises: the port never carries on quietly
on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
