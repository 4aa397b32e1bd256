"""Channel-wise L2 norm, forward (counterpart of flownet2_tpu/ops/channelnorm.py).

Plain PyTorch: an elementwise square and a reduction over the channel axis,
which the JAX package also left to the compiler rather than to a kernel.
NCHW in, ``(B, 1, H, W)`` out.
"""

from __future__ import annotations

import torch


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum_c x^2), keeping a singleton channel axis."""
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


def channel_norm_multi(*xs: torch.Tensor) -> torch.Tensor:
    """``cat([channel_norm(x) for x in xs], 1)``: one ``(B, N, H, W)``
    tensor of the N inputs' norms."""
    return torch.cat([channel_norm(x) for x in xs], dim=1)
