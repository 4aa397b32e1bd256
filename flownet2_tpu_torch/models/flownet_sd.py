"""FlowNetSD (small displacements, 45,371,666 parameters) and FlowNetFusion
(581,226 parameters): counterparts of flownet2_tpu/models/flownet_sd.py."""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import conv, deconv, i_conv, predict_flow, upsampled_flow


class FlowNetSD(nn.Module):
    def __init__(self, batch_norm: bool = False):
        super().__init__()
        bn = batch_norm
        self.conv0 = conv(6, 64, batch_norm=bn)
        self.conv1 = conv(64, 64, stride=2, batch_norm=bn)
        self.conv1_1 = conv(64, 128, batch_norm=bn)
        self.conv2 = conv(128, 128, stride=2, batch_norm=bn)
        self.conv2_1 = conv(128, 128, batch_norm=bn)
        self.conv3 = conv(128, 256, stride=2, batch_norm=bn)
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

        self.inter_conv5 = i_conv(1026, 512, batch_norm=bn)
        self.inter_conv4 = i_conv(770, 256, batch_norm=bn)
        self.inter_conv3 = i_conv(386, 128, batch_norm=bn)
        self.inter_conv2 = i_conv(194, 64, batch_norm=bn)

        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(512)
        self.predict_flow4 = predict_flow(256)
        self.predict_flow3 = predict_flow(128)
        self.predict_flow2 = predict_flow(64)

        self.upsampled_flow6_to_5 = upsampled_flow()
        self.upsampled_flow5_to_4 = upsampled_flow()
        self.upsampled_flow4_to_3 = upsampled_flow()
        self.upsampled_flow3_to_2 = upsampled_flow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 6, H, W) -> flow2 (B, 2, H/4, W/4)."""
        out_conv1 = self.conv1_1(self.conv1(self.conv0(x)))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))

        flow6 = self.predict_flow6(out_conv6)
        concat5 = torch.cat([out_conv5, self.deconv5(out_conv6),
                             self.upsampled_flow6_to_5(flow6)], dim=1)
        flow5 = self.predict_flow5(self.inter_conv5(concat5))
        concat4 = torch.cat([out_conv4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)], dim=1)
        flow4 = self.predict_flow4(self.inter_conv4(concat4))
        concat3 = torch.cat([out_conv3, self.deconv3(concat4),
                             self.upsampled_flow4_to_3(flow4)], dim=1)
        flow3 = self.predict_flow3(self.inter_conv3(concat3))
        concat2 = torch.cat([out_conv2, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)], dim=1)
        return self.predict_flow2(self.inter_conv2(concat2))


class FlowNetFusion(nn.Module):
    """Shallow fusion net over the 11-channel fusion-glue output."""

    def __init__(self, batch_norm: bool = False):
        super().__init__()
        bn = batch_norm
        self.conv0 = conv(11, 64, batch_norm=bn)
        self.conv1 = conv(64, 64, stride=2, batch_norm=bn)
        self.conv1_1 = conv(64, 128, batch_norm=bn)
        self.conv2 = conv(128, 128, stride=2, batch_norm=bn)
        self.conv2_1 = conv(128, 128, batch_norm=bn)

        self.deconv1 = deconv(128, 32)
        self.deconv0 = deconv(162, 16)

        self.inter_conv1 = i_conv(162, 32, batch_norm=bn)
        self.inter_conv0 = i_conv(82, 16, batch_norm=bn)

        self.predict_flow2 = predict_flow(128)
        self.predict_flow1 = predict_flow(32)
        self.predict_flow0 = predict_flow(16)

        self.upsampled_flow2_to_1 = upsampled_flow()
        self.upsampled_flow1_to_0 = upsampled_flow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 11, H, W) -> flow0 (B, 2, H, W)."""
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))

        flow2 = self.predict_flow2(out_conv2)
        concat1 = torch.cat([out_conv1, self.deconv1(out_conv2),
                             self.upsampled_flow2_to_1(flow2)], dim=1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        concat0 = torch.cat([out_conv0, self.deconv0(concat1),
                             self.upsampled_flow1_to_0(flow1)], dim=1)
        return self.predict_flow0(self.inter_conv0(concat0))
