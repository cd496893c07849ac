"""Device selection for the package's entry points.

Every entry point runs on the GPU unless the caller names another
device. A request for CUDA on a host without a card raises: nothing
falls back to the CPU behind the caller's back.

Float32 means float32: the entry points (`cli.main`, `Trainer`,
`InferenceEngine`) call `disable_tf32` before they build a float32
model, so cuDNN's convolutions and cuBLAS's matmuls on the card compute
in float32 as the JAX reference does, and not in TF32, PyTorch's
default for cuDNN.
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


def disable_tf32() -> None:
    """Turn off TF32 in cuDNN's convolutions and cuBLAS's matmuls
    (`torch.backends.cudnn.allow_tf32`,
    `torch.backends.cuda.matmul.allow_tf32`). Never turns them on."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
