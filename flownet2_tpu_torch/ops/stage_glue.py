"""The FlowNet2 cascade's glue between stages, NCHW, forward only.

Counterpart of the plain compositions in flownet2_tpu/ops/stage_glue.py
(``_plain_glue`` and ``_plain_fusion_glue``); the channel-major VJPs and
packed layouts there are TPU layout work and are not ported.
"""

from __future__ import annotations

import torch

from .channelnorm import channel_norm, channel_norm_multi
from .resample2d import resample2d, resample2d_multi


def stage_glue(x: torch.Tensor, x2: torch.Tensor, flow: torch.Tensor,
               div_flow: float) -> torch.Tensor:
    """cat([x, warp(x2, flow), flow/div_flow, ||x[:, :3] - warp||]).

    x: (B, 6, H, W) the stacked frame pair; x2: (B, 3, H, W); flow
    (B, 2, H, W).  Returns the next stage's 12-channel input.
    """
    resampled = resample2d(x2, flow)
    norm = channel_norm(x[:, :3] - resampled)
    return torch.cat([x, resampled, flow / div_flow, norm], dim=1)


def fusion_glue(x1: torch.Tensor, x2: torch.Tensor, sd_flow: torch.Tensor,
                s2_flow: torch.Tensor) -> torch.Tensor:
    """FlowNetFusion's 11-channel input:

        cat([x1, sd_flow, s2_flow, ||sd_flow||, ||s2_flow||,
             ||x1 - warp(x2, sd_flow)||, ||x1 - warp(x2, s2_flow)||])

    Both warps of x2 are one two-flow ``resample2d_multi`` call.
    """
    warps = resample2d_multi(x2, torch.stack([sd_flow, s2_flow], dim=1))
    norms = channel_norm_multi(sd_flow, s2_flow, x1 - warps[:, 0],
                               x1 - warps[:, 1])
    return torch.cat([x1, sd_flow, s2_flow, norms], dim=1)
