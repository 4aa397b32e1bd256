"""Model zoo of the port: FlowNet2 and the FlowNet2C, 2S, 2SD, 2CS and 2CSS
wrappers, for inference and training."""

from __future__ import annotations

import torch

from ..nn.layers import init_weights
from ..utils.device import resolve_device
from .flownet2 import (FlowNet2, FlowNet2C, FlowNet2CS,  # noqa: F401
                       FlowNet2CSS, FlowNet2S, FlowNet2SD, normalize_pair)
from .flownet_c import FlowNetC  # noqa: F401
from .flownet_s import FlowNetS  # noqa: F401
from .flownet_sd import FlowNetFusion, FlowNetSD  # noqa: F401

MODELS = {cls.__name__: cls for cls in (FlowNet2, FlowNet2C, FlowNet2S,
                                        FlowNet2SD, FlowNet2CS, FlowNet2CSS)}


def get_model(name: str, device: str | torch.device | None = None,
              seed: int = 0, dtype: torch.dtype | None = None,
              **kwargs) -> torch.nn.Module:
    """Build a registered model by name in eval mode on ``device`` (None:
    the CUDA device, which must exist), with the reference's init drawn
    from a generator seeded with ``seed``.  ``dtype=torch.bfloat16`` is the
    JAX package's bf16 model: float32 parameters, the frames cast once
    after normalisation, bfloat16 convolutions, glue and warps, bfloat16
    flow out; it serves inference and the train step alike.
    ``dtype=torch.float16`` is its fp16 model, built the same way (the
    command line's ``--precision fp16``, which trains it with a static loss
    scale and skips non-finite updates).  With ``batch_norm=True`` the
    BatchNorm layers normalise in float32 and return the compute dtype."""
    try:
        cls = MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODELS)}") from None
    dev = resolve_device(device)
    model = cls(dtype=dtype, **kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
