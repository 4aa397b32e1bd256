"""The FlowNet2 cascade's glue between stages, NCHW.

Counterpart of flownet2_tpu/ops/stage_glue.py: the plain compositions
(``_plain_glue``, ``_plain_fusion_glue``) under autograd.  The JAX
package's channel-major VJPs and packed layouts are TPU layout work and
are not ported.

Where no gradient is wanted (``torch.no_grad``, ``torch.inference_mode``,
or inputs that need none) both glues warp through the generic op: K2 on
CUDA, one launch per stage glue and one two-flow launch per fusion glue.
Where one is, they take ``TRAIN_WARP``: ``"grad_flow"``, the generic op,
whose backward is K4 (one launch per glue, two flows in one for the fusion
glue), or ``"tangents"``, K3 in the forward (likewise) and the elementwise
contraction with its saved tangents in the backward, the JAX package's
training route.  Both give the same gradient.  chip_smoke.py times both;
the K4 route measured the faster on the H100 (PERF.md), so it is the
default.
"""

from __future__ import annotations

import torch

from .channelnorm import channel_norm, channel_norm_multi
from .resample2d import resample2d_multi, resample2d_tangents

TRAIN_WARP = "grad_flow"


def _warp(x2: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """x2 (B, C, H, W) warped by F flows (B, F, 2, H, W) -> (B, F, C, H, W)."""
    if (TRAIN_WARP == "tangents" and torch.is_grad_enabled()
            and (x2.requires_grad or flows.requires_grad)):
        return resample2d_tangents(x2, flows)
    return resample2d_multi(x2, flows)


def stage_glue(x: torch.Tensor, x2: torch.Tensor, flow: torch.Tensor,
               div_flow: float) -> torch.Tensor:
    """cat([x, warp(x2, flow), flow/div_flow, ||x[:, :3] - warp||]).

    x: (B, 6, H, W) the stacked frame pair; x2: (B, 3, H, W); flow
    (B, 2, H, W).  Returns the next stage's 12-channel input.
    """
    resampled = _warp(x2, flow.unsqueeze(1)).squeeze(1)
    norm = channel_norm(x[:, :3] - resampled)
    # in the activations' dtype, as the JAX glue casts it: torch.cat would
    # promote a bfloat16 concat with one float32 piece to float32
    return torch.cat([x, resampled, (flow / div_flow).to(x.dtype), norm],
                     dim=1)


def fusion_glue(x1: torch.Tensor, x2: torch.Tensor, sd_flow: torch.Tensor,
                s2_flow: torch.Tensor) -> torch.Tensor:
    """FlowNetFusion's 11-channel input:

        cat([x1, sd_flow, s2_flow, ||sd_flow||, ||s2_flow||,
             ||x1 - warp(x2, sd_flow)||, ||x1 - warp(x2, s2_flow)||])

    Both warps of x2 are one two-flow warp call.
    """
    warps = _warp(x2, torch.stack([sd_flow, s2_flow], dim=1))
    norms = channel_norm_multi(sd_flow, s2_flow, x1 - warps[:, 0],
                               x1 - warps[:, 1])
    return torch.cat([x1, sd_flow, s2_flow, norms], dim=1)
