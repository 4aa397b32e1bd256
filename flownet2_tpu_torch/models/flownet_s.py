"""FlowNetS: plain encoder-decoder (counterpart of
flownet2_tpu/models/flownet_s.py).  38,695,322 parameters at 12 input
channels, 38,676,506 at 6."""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import conv, deconv, predict_flow, upsampled_flow


class FlowNetS(nn.Module):
    def __init__(self, input_channels: int = 12, batch_norm: bool = False):
        super().__init__()
        bn = batch_norm
        self.conv1 = conv(input_channels, 64, 7, 2, bn)
        self.conv2 = conv(64, 128, 5, 2, bn)
        self.conv3 = conv(128, 256, 5, 2, bn)
        self.conv3_1 = conv(256, 256, batch_norm=bn)
        self.conv4 = conv(256, 512, stride=2, batch_norm=bn)
        self.conv4_1 = conv(512, 512, batch_norm=bn)
        self.conv5 = conv(512, 512, stride=2, batch_norm=bn)
        self.conv5_1 = conv(512, 512, batch_norm=bn)
        self.conv6 = conv(512, 1024, stride=2, batch_norm=bn)
        self.conv6_1 = conv(1024, 1024, batch_norm=bn)

        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)

        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(1026)
        self.predict_flow4 = predict_flow(770)
        self.predict_flow3 = predict_flow(386)
        self.predict_flow2 = predict_flow(194)

        self.upsampled_flow6_to_5 = upsampled_flow(bias=False)
        self.upsampled_flow5_to_4 = upsampled_flow(bias=False)
        self.upsampled_flow4_to_3 = upsampled_flow(bias=False)
        self.upsampled_flow3_to_2 = upsampled_flow(bias=False)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """x (B, C, H, W) -> ``(flow2,)`` (B, 2, H/4, W/4) or, in
        ``train()`` mode, ``(flow2, flow3, flow4, flow5, flow6)``, each half
        the size of the one before: the multi-scale training outputs."""
        out_conv2 = self.conv2(self.conv1(x))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))

        flow6 = self.predict_flow6(out_conv6)
        concat5 = torch.cat([out_conv5, self.deconv5(out_conv6),
                             self.upsampled_flow6_to_5(flow6)], dim=1)
        flow5 = self.predict_flow5(concat5)
        concat4 = torch.cat([out_conv4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)], dim=1)
        flow4 = self.predict_flow4(concat4)
        concat3 = torch.cat([out_conv3, self.deconv3(concat4),
                             self.upsampled_flow4_to_3(flow4)], dim=1)
        flow3 = self.predict_flow3(concat3)
        concat2 = torch.cat([out_conv2, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)], dim=1)
        flow2 = self.predict_flow2(concat2)
        if self.training:
            return flow2, flow3, flow4, flow5, flow6
        return (flow2,)
