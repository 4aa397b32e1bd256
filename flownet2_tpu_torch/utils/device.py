"""Device resolution for the port's entry points.

``None`` means the CUDA device.  A machine without one raises: an entry
point never moves to the CPU on its own, the caller asks for it by name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device on a machine without one raises
    ``RuntimeError``; anything else is returned as a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch ops on the CPU")
    return dev
