"""Flow upsampling and the loss's pooling (counterpart of
flownet2_tpu/ops/upsample.py), NCHW.

The reference upsamples with ``nn.Upsample(scale_factor=4)``: bilinear
(align_corners=False) after FlowNetC and the first FlowNetS, nearest after
the second FlowNetS and FlowNetSD.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def upsample_nearest(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """NCHW average pool with stride == window (torch ``AvgPool2d(k, k)``),
    as the MultiScale loss pools its target."""
    return F.avg_pool2d(x, window, window)
