"""Model zoo of the port.  This slice carries FlowNet2 inference; the
FlowNet2C/S/SD/CS/CSS wrappers come with a later slice."""

from __future__ import annotations

import torch

from ..nn.layers import init_weights
from ..utils.device import resolve_device
from .flownet2 import FlowNet2, normalize_pair  # noqa: F401
from .flownet_c import FlowNetC  # noqa: F401
from .flownet_s import FlowNetS  # noqa: F401
from .flownet_sd import FlowNetFusion, FlowNetSD  # noqa: F401

MODELS = {"FlowNet2": FlowNet2}


def get_model(name: str, device: str | torch.device | None = None,
              seed: int = 0, **kwargs) -> torch.nn.Module:
    """Build a registered model by name in eval mode on ``device`` (None:
    the CUDA device, which must exist), with the reference's init drawn
    from a generator seeded with ``seed``."""
    try:
        cls = MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODELS)}") from None
    dev = resolve_device(device)
    model = cls(**kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
