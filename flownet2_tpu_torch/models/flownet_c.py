"""FlowNetC: siamese towers, correlation cost volume, encoder-decoder
(counterpart of flownet2_tpu/models/flownet_c.py).  39,175,298 parameters."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (LEAKY_SLOPE, conv, deconv, predict_flow,
                         upsampled_flow)
from ..ops import correlation as corr_ops


class FlowNetC(nn.Module):
    def __init__(self, batch_norm: bool = False):
        super().__init__()
        bn = batch_norm
        self.batch_norm = bn
        self.conv1 = conv(3, 64, 7, 2, bn)
        self.conv2 = conv(64, 128, 5, 2, bn)
        self.conv3 = conv(128, 256, 5, 2, bn)
        self.conv_redir = conv(256, 32, 1, 1, bn)

        self.conv3_1 = conv(473, 256, batch_norm=bn)
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

        self.upsampled_flow6_to_5 = upsampled_flow()
        self.upsampled_flow5_to_4 = upsampled_flow()
        self.upsampled_flow4_to_3 = upsampled_flow()
        self.upsampled_flow3_to_2 = upsampled_flow()

    def _tower(self, x: torch.Tensor):
        out_conv2 = self.conv2(self.conv1(x))
        return out_conv2, self.conv3(out_conv2)

    def forward(self, x1: torch.Tensor,
                x2: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """x1, x2: the normalised frames (B, 3, H, W) -> ``(flow2,)``
        (B, 2, H/4, W/4) or, in ``train()`` mode, ``(flow2, flow3, flow4,
        flow5, flow6)``."""
        if self.batch_norm and self.training:
            # train-mode BatchNorm normalises each stream with its own batch
            # statistics (the reference calls the tower twice): batching the
            # streams would mix them
            out_conv2a, out_conv3a = self._tower(x1)
            _, out_conv3b = self._tower(x2)
        else:
            # shared weights: both streams in one batch, half the launches
            out_conv2, out_conv3 = self._tower(torch.cat([x1, x2], dim=0))
            out_conv2a = out_conv2[:x1.shape[0]]
            out_conv3a, out_conv3b = out_conv3.chunk(2, dim=0)

        out_corr = F.leaky_relu(
            corr_ops.correlation(out_conv3a, out_conv3b, pad_size=20,
                                 kernel_size=1, max_displacement=20,
                                 stride1=1, stride2=2, corr_multiply=1),
            LEAKY_SLOPE)
        in_conv3_1 = torch.cat([self.conv_redir(out_conv3a), out_corr], dim=1)

        out_conv3 = self.conv3_1(in_conv3_1)
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
        # the skip is the first stream's conv2 (the reference's FlowNetC)
        concat2 = torch.cat([out_conv2a, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)], dim=1)
        flow2 = self.predict_flow2(concat2)
        if self.training:
            return flow2, flow3, flow4, flow5, flow6
        return (flow2,)
