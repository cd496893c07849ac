"""Device selection for the package's entry points.

Every entry point runs on the GPU unless the caller names another
device. A request for CUDA on a host without a card raises: nothing
falls back to the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
