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

``set_compute_dtype(model, dtype)`` is the JAX layers' ``dtype``
(nn/layers.py:116-122 there): None computes in the input's dtype;
``torch.bfloat16`` keeps the parameters float32 under the same keys and
makes every convolution cast its input, weight and bias to bfloat16 at
each call, so the output and the LeakyReLU after it are bfloat16.  One
state_dict serves both.  BatchNorm has no bfloat16 form yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.1


def _cast(t: torch.Tensor | None, dtype: torch.dtype | None):
    return t if t is None or dtype is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose forward casts the input and its float32
    parameters to ``compute_dtype`` (None: no cast)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(_cast(x, dt), _cast(self.weight, dt),
                                  _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (without ``output_size``) whose forward casts
    like ``Conv2d``'s."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(
            _cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype | None):
    """Make every convolution of ``model`` cast to ``dtype`` at each call
    (None: no cast) and return ``model``.  BatchNorm has no bfloat16 form
    yet: a model that holds one raises for any dtype but float32."""
    if dtype not in (None, torch.float32) and any(
            isinstance(m, nn.BatchNorm2d) for m in model.modules()):
        raise NotImplementedError(
            f"BatchNorm in {dtype}: not ported yet (ROADMAP.md); build the "
            "model with batch_norm=False")
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype
    return model


def compute_dtype(model: nn.Module) -> torch.dtype | None:
    """The dtype a model's convolutions cast to (None: the input's)."""
    return next((m.compute_dtype for m in model.modules()
                 if isinstance(m, (Conv2d, ConvTranspose2d))), None)


def conv(in_planes: int, out_planes: int, kernel_size: int = 3,
         stride: int = 1, batch_norm: bool = False) -> nn.Sequential:
    layers = [Conv2d(in_planes, out_planes, kernel_size, stride,
                     padding=(kernel_size - 1) // 2, bias=not batch_norm)]
    if batch_norm:
        layers.append(nn.BatchNorm2d(out_planes))
    layers.append(nn.LeakyReLU(LEAKY_SLOPE, inplace=True))
    return nn.Sequential(*layers)


def i_conv(in_planes: int, out_planes: int, kernel_size: int = 3,
           stride: int = 1, batch_norm: bool = False,
           bias: bool = True) -> nn.Sequential:
    layers = [Conv2d(in_planes, out_planes, kernel_size, stride,
                     padding=(kernel_size - 1) // 2, bias=bias)]
    if batch_norm:
        layers.append(nn.BatchNorm2d(out_planes))
    return nn.Sequential(*layers)


def predict_flow(in_planes: int) -> Conv2d:
    return Conv2d(in_planes, 2, 3, 1, 1, bias=True)


def deconv(in_planes: int, out_planes: int) -> nn.Sequential:
    return nn.Sequential(
        ConvTranspose2d(in_planes, out_planes, 4, 2, 1, bias=True),
        nn.LeakyReLU(LEAKY_SLOPE, inplace=True))


def upsampled_flow(bias: bool = True) -> ConvTranspose2d:
    return ConvTranspose2d(2, 2, 4, 2, 1, bias=bias)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Xavier-uniform conv weights and U[0, 1) conv biases, in module
    order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            if m.bias is not None:
                nn.init.uniform_(m.bias, generator=generator)
            nn.init.xavier_uniform_(m.weight, generator=generator)
