"""FlowNet2: the full C -> S1 -> S2 (+ SD) -> Fusion cascade (counterpart
of flownet2_tpu/models/flownet2.py).  162,518,834 parameters.

The public ``forward`` keeps the JAX package's layout: frame pairs
``(B, 2, H, W, 3)`` in, flow ``(B, H, W, 2)`` out; inside, everything is
NCHW.  The cascade keeps the reference's quirks: the flow is upsampled
bilinearly after FlowNetC and the first FlowNetS and by nearest after the
second FlowNetS and FlowNetSD, and the SD branch divides by ``div_flow``
where the others multiply.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.stage_glue import fusion_glue, stage_glue
from ..ops.upsample import upsample_bilinear, upsample_nearest
from .flownet_c import FlowNetC
from .flownet_s import FlowNetS
from .flownet_sd import FlowNetFusion, FlowNetSD


def normalize_pair(inputs: torch.Tensor, rgb_max: float):
    """Reference input normalisation: subtract the pair's per-channel mean
    and divide by ``rgb_max``.

    inputs: (B, 2, H, W, 3) RGB, H and W multiples of 64.
    Returns (x1, x2), two (B, 3, H, W) float32 frames.
    """
    if inputs.dim() != 5 or inputs.shape[1] != 2 or inputs.shape[-1] != 3:
        raise ValueError(f"expected frame pairs shaped (B, 2, H, W, 3), got "
                         f"{tuple(inputs.shape)}")
    h, w = inputs.shape[2], inputs.shape[3]
    if h % 64 or w % 64:
        # without it the encoder/decoder skip connections misalign
        raise ValueError(f"input H, W must be multiples of 64 (got {h}x{w}); "
                         "crop or resize the frames")
    inputs = inputs.float()
    rgb_mean = inputs.mean(dim=(2, 3), keepdim=True).mean(dim=1, keepdim=True)
    x = (inputs - rgb_mean) / rgb_max
    return (x[:, 0].permute(0, 3, 1, 2).contiguous(),
            x[:, 1].permute(0, 3, 1, 2).contiguous())


class FlowNet2(nn.Module):
    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 rgb_max: float = 255.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC(batch_norm)
        self.flownets_1 = FlowNetS(12, batch_norm)
        self.flownets_2 = FlowNetS(12, batch_norm)
        self.flownets_d = FlowNetSD(batch_norm)
        self.flownetfusion = FlowNetFusion(batch_norm)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs (B, 2, H, W, 3) -> flow (B, H, W, 2)."""
        x1, x2 = normalize_pair(inputs, self.rgb_max)
        x = torch.cat([x1, x2], dim=1)
        div = self.div_flow

        flownetc_flow = upsample_bilinear(self.flownetc(x1, x2) * div)
        concat1 = stage_glue(x, x2, flownetc_flow, div)

        flownets1_flow = upsample_bilinear(self.flownets_1(concat1) * div)
        concat2 = stage_glue(x, x2, flownets1_flow, div)

        flownets2_flow = upsample_nearest(self.flownets_2(concat2) * div)
        flownetsd_flow = upsample_nearest(self.flownets_d(x) / div)

        concat3 = fusion_glue(x1, x2, flownetsd_flow, flownets2_flow)
        return self.flownetfusion(concat3).permute(0, 2, 3, 1)
