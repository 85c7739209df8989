"""Device choice for the port's entry points.

Everything runs on the GPU unless the caller names another device: the
CPU is used only when asked for (`device="cpu"`, as the tests do), never
as a silent fallback when CUDA is missing.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when it is None.

    Raises RuntimeError when CUDA is needed but absent, so a machine
    without a card fails loudly instead of quietly simulating on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
