"""FlowNet2, the full C -> S1 -> S2 (+ SD) -> Fusion cascade with
162,518,834 parameters, and the FlowNet2C, 2S, 2SD, 2CS and 2CSS wrappers
(counterparts of flownet2_tpu/models/flownet2.py).

Every public ``forward`` keeps the JAX package's layout: frame pairs
``(B, 2, H, W, 3)`` in, flow ``(B, H, W, 2)`` out; inside, everything is
NCHW.  The cascades keep the reference's quirks: the flow is upsampled
bilinearly after FlowNetC and the first FlowNetS and by nearest after the
second FlowNetS and FlowNetSD, and FlowNet2's SD branch divides by
``div_flow`` where everything else, the FlowNet2SD wrapper included,
multiplies.

In ``train()`` mode FlowNet2's forward is the same and returns the fusion
flow, as the JAX package's ``FlowNet2(training=True)`` does; the gradient
reaches every sub-net through the glues' warps and the correlation.  The
wrappers return their last sub-net's multi-scale tuple ``(flow2, ...,
flow6)``, each ``(B, h, w, 2)`` and unscaled, which ``losses.MultiScale``
takes.  The single-net wrappers are their sub-net with a public forward,
so their modules sit at the root under the reference's state_dict keys.

``dtype=torch.bfloat16`` is the JAX package's bf16 model: ``normalize_pair``
casts the frames once and everything after it runs in bf16
(``nn.layers.set_compute_dtype`` makes the convolutions cast their float32
parameters at each call), so the flow is bf16, in the inference forward
and in the training tuples alike.  It trains through
``train.StepFactory``: the parameters stay float32 and their gradients
come back float32 through the casts; the loss and the optimizer run in
float32.  ``dtype=torch.float16`` is the JAX package's fp16 model, threaded
the same way (its train step takes a loss scale and skips non-finite
updates: ``StepFactory(loss_scale=..., skip_nonfinite_updates=True)``).
With ``batch_norm=True`` the BatchNorm layers compute in float32 and
return the compute dtype (``nn.layers.BatchNorm2d``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import compute_dtype, set_compute_dtype
from ..ops import sharding_hints
from ..ops.stage_glue import fusion_glue, stage_glue
from ..ops.upsample import upsample_bilinear, upsample_nearest
from ..parallel.halo import mean_over_bands
from .flownet_c import FlowNetC
from .flownet_s import FlowNetS
from .flownet_sd import FlowNetFusion, FlowNetSD


def normalize_pair(inputs: torch.Tensor, rgb_max: float,
                   dtype: torch.dtype | None = None):
    """Reference input normalisation: subtract the pair's per-channel mean
    and divide by ``rgb_max``, in float32.

    inputs: (B, 2, H, W, 3) RGB, H and W multiples of 64.  Under a band
    context ``inputs`` is this process's band of the rows (its edges in
    granules of 64 rows, ``sharding_hints.band_edges``), and the mean is
    the whole frame's: the bands' means weighted by their shares of the
    rows.
    Returns (x1, x2), two (B, 3, H, W) frames, float32 or cast once to
    ``dtype`` (the bf16 or fp16 model's one cast: everything after it, the
    glue and the warps included, runs in that dtype, as in the JAX
    package).
    """
    if inputs.dim() != 5 or inputs.shape[1] != 2 or inputs.shape[-1] != 3:
        raise ValueError(f"expected frame pairs shaped (B, 2, H, W, 3), got "
                         f"{tuple(inputs.shape)}")
    band = sharding_hints.band()
    h, w = inputs.shape[2], inputs.shape[3]
    if band is not None:
        h = band.spans(h)[-1][1]
    if h % 64 or w % 64:
        # without it the encoder/decoder skip connections misalign
        raise ValueError(f"input H, W must be multiples of 64 (got {h}x{w}); "
                         "crop or resize the frames")
    inputs = inputs.float()
    rgb_mean = inputs.mean(dim=(2, 3), keepdim=True)
    if band is not None:
        # the bands' edges are the rule's for this height (or it raises)
        if band.spans(inputs.shape[2]) != list(
                sharding_hints.band_edges(h, band.size)):
            raise ValueError(f"band {band.index} of {inputs.shape[2]} rows: "
                             f"not a band of {h} rows cut in {band.size} "
                             "on granules of 64 rows")
        rgb_mean = mean_over_bands(rgb_mean, band)
    rgb_mean = rgb_mean.mean(dim=1, keepdim=True)
    x = (inputs - rgb_mean) / rgb_max
    if dtype is not None:
        x = x.to(dtype)
    return (x[:, 0].permute(0, 3, 1, 2).contiguous(),
            x[:, 1].permute(0, 3, 1, 2).contiguous())


class FlowNet2(nn.Module):
    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 rgb_max: float = 255.0, dtype: torch.dtype | None = None):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC(batch_norm)
        self.flownets_1 = FlowNetS(12, batch_norm)
        self.flownets_2 = FlowNetS(12, batch_norm)
        self.flownets_d = FlowNetSD(batch_norm)
        self.flownetfusion = FlowNetFusion(batch_norm)
        set_compute_dtype(self, dtype)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs (B, 2, H, W, 3) -> flow (B, H, W, 2)."""
        x1, x2 = normalize_pair(inputs, self.rgb_max, compute_dtype(self))
        x = torch.cat([x1, x2], dim=1)
        div = self.div_flow

        flownetc_flow = upsample_bilinear(self.flownetc(x1, x2)[0] * div)
        concat1 = stage_glue(x, x2, flownetc_flow, div)

        flownets1_flow = upsample_bilinear(self.flownets_1(concat1)[0] * div)
        concat2 = stage_glue(x, x2, flownets1_flow, div)

        flownets2_flow = upsample_nearest(self.flownets_2(concat2)[0] * div)
        flownetsd_flow = upsample_nearest(self.flownets_d(x)[0] / div)

        concat3 = fusion_glue(x1, x2, flownetsd_flow, flownets2_flow)
        return self.flownetfusion(concat3).permute(0, 2, 3, 1)


def _wrapper_output(flows, module: nn.Module, upsample=upsample_bilinear):
    """A wrapper's result from its last sub-net's NCHW ``flows``: the
    multi-scale tuple in ``train()`` mode, else flow2 times ``div_flow``
    upsampled to the frame; NHWC either way."""
    if module.training:
        return tuple(f.permute(0, 2, 3, 1) for f in flows)
    return upsample(flows[0] * module.div_flow).permute(0, 2, 3, 1)


class FlowNet2C(FlowNetC):
    """FlowNetC on frame pairs."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 rgb_max: float = 255.0, dtype: torch.dtype | None = None):
        super().__init__(batch_norm)
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        set_compute_dtype(self, dtype)

    def forward(self, inputs: torch.Tensor):
        x1, x2 = normalize_pair(inputs, self.rgb_max, compute_dtype(self))
        return _wrapper_output(super().forward(x1, x2), self)


class FlowNet2S(FlowNetS):
    """FlowNetS on frame pairs (6 input channels)."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 rgb_max: float = 255.0, dtype: torch.dtype | None = None):
        super().__init__(6, batch_norm)
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        set_compute_dtype(self, dtype)

    def forward(self, inputs: torch.Tensor):
        x = torch.cat(normalize_pair(inputs, self.rgb_max,
                                     compute_dtype(self)), dim=1)
        return _wrapper_output(super().forward(x), self)


class FlowNet2SD(FlowNetSD):
    """FlowNetSD on frame pairs; multiplies by ``div_flow``, where the SD
    branch inside FlowNet2 divides."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 rgb_max: float = 255.0, dtype: torch.dtype | None = None):
        super().__init__(batch_norm)
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        set_compute_dtype(self, dtype)

    def forward(self, inputs: torch.Tensor):
        x = torch.cat(normalize_pair(inputs, self.rgb_max,
                                     compute_dtype(self)), dim=1)
        return _wrapper_output(super().forward(x), self)


class FlowNet2CS(nn.Module):
    """The C -> S1 cascade."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 rgb_max: float = 255.0, dtype: torch.dtype | None = None):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC(batch_norm)
        self.flownets_1 = FlowNetS(12, batch_norm)
        set_compute_dtype(self, dtype)

    def forward(self, inputs: torch.Tensor):
        x1, x2 = normalize_pair(inputs, self.rgb_max, compute_dtype(self))
        x = torch.cat([x1, x2], dim=1)
        div = self.div_flow
        flownetc_flow = upsample_bilinear(self.flownetc(x1, x2)[0] * div)
        concat1 = stage_glue(x, x2, flownetc_flow, div)
        return _wrapper_output(self.flownets_1(concat1), self)


class FlowNet2CSS(nn.Module):
    """The C -> S1 -> S2 cascade; its last upsample is nearest."""

    def __init__(self, batch_norm: bool = False, div_flow: float = 20.0,
                 rgb_max: float = 255.0, dtype: torch.dtype | None = None):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC(batch_norm)
        self.flownets_1 = FlowNetS(12, batch_norm)
        self.flownets_2 = FlowNetS(12, batch_norm)
        set_compute_dtype(self, dtype)

    def forward(self, inputs: torch.Tensor):
        x1, x2 = normalize_pair(inputs, self.rgb_max, compute_dtype(self))
        x = torch.cat([x1, x2], dim=1)
        div = self.div_flow
        flownetc_flow = upsample_bilinear(self.flownetc(x1, x2)[0] * div)
        concat1 = stage_glue(x, x2, flownetc_flow, div)
        flownets1_flow = upsample_bilinear(self.flownets_1(concat1)[0] * div)
        concat2 = stage_glue(x, x2, flownets1_flow, div)
        return _wrapper_output(self.flownets_2(concat2), self,
                               upsample_nearest)
