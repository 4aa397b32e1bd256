"""Conv/deconv building blocks (counterpart of flownet2_tpu/nn/layers.py).

The builders return modules under the reference's state_dict keys
(flownet2_tpu/checkpoints/torch_import.py:10-17):

    conv()           Sequential(Conv2d[, BatchNorm2d], LeakyReLU)  conv*.0.*, conv*.1.*
    i_conv()         Sequential(Conv2d[, BatchNorm2d])             inter_conv*.0.*
    deconv()         Sequential(ConvTranspose2d, LeakyReLU)        deconv*.0.*
    predict_flow()   bare Conv2d                                   predict_flow*.*
    upsampled_flow() bare ConvTranspose2d                          upsampled_flow*.*

LeakyReLU has slope 0.1, padding is (k-1)//2, and a conv followed by
BatchNorm has no bias.  ConvTranspose2d keeps torch's own (in, out, kh, kw)
weight.  ``init_weights`` reproduces the reference's init: xavier-uniform
weights and U[0, 1) biases, drawn from the generator it is given.
"""

from __future__ import annotations

import torch
from torch import nn

LEAKY_SLOPE = 0.1


def conv(in_planes: int, out_planes: int, kernel_size: int = 3,
         stride: int = 1, batch_norm: bool = False) -> nn.Sequential:
    layers = [nn.Conv2d(in_planes, out_planes, kernel_size, stride,
                        padding=(kernel_size - 1) // 2, bias=not batch_norm)]
    if batch_norm:
        layers.append(nn.BatchNorm2d(out_planes))
    layers.append(nn.LeakyReLU(LEAKY_SLOPE, inplace=True))
    return nn.Sequential(*layers)


def i_conv(in_planes: int, out_planes: int, kernel_size: int = 3,
           stride: int = 1, batch_norm: bool = False,
           bias: bool = True) -> nn.Sequential:
    layers = [nn.Conv2d(in_planes, out_planes, kernel_size, stride,
                        padding=(kernel_size - 1) // 2, bias=bias)]
    if batch_norm:
        layers.append(nn.BatchNorm2d(out_planes))
    return nn.Sequential(*layers)


def predict_flow(in_planes: int) -> nn.Conv2d:
    return nn.Conv2d(in_planes, 2, 3, 1, 1, bias=True)


def deconv(in_planes: int, out_planes: int) -> nn.Sequential:
    return nn.Sequential(
        nn.ConvTranspose2d(in_planes, out_planes, 4, 2, 1, bias=True),
        nn.LeakyReLU(LEAKY_SLOPE, inplace=True))


def upsampled_flow(bias: bool = True) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=bias)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Xavier-uniform conv weights and U[0, 1) conv biases, in module
    order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            if m.bias is not None:
                nn.init.uniform_(m.bias, generator=generator)
            nn.init.xavier_uniform_(m.weight, generator=generator)
