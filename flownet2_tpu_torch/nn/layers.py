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
``torch.bfloat16`` or ``torch.float16`` keeps the parameters float32 under
the same keys and makes every convolution cast its input, weight and bias
to that dtype at each call, so the output and the LeakyReLU after it are
in it.  One state_dict serves every dtype.  ``BatchNorm2d`` takes a
bfloat16 or float16 input as Flax's ``nn.BatchNorm(dtype=...)`` does
(``_compute_stats`` with its float32 reductions, ``_normalize``): the
statistics and the normalisation in float32, the result rounded once to
the input's dtype; its parameters and running statistics stay float32.
On the CPU a float16 convolution runs in float32 and rounds once
(``_convolve``), as cuDNN's float16 convolutions accumulate in float32.

Under a band context (``ops.sharding_hints.scoped_band``, which
``parallel.DataParallelPlan.band_context(height)`` enters) each process
holds a band of the rows, whose height may differ from the other bands'
(granules of 64 frame rows, whole rows at every level): ``Conv2d`` and
``ConvTranspose2d`` then fetch the halo rows their kernel, stride and
padding need from the neighbouring bands (``parallel.halo_rows``, zero rows
beyond the image), pad the width alone and convolve, so that each band's
output is its rows of the whole map's.

``BatchNorm2d`` is ``nn.BatchNorm2d`` under the same keys; with
``global_batch`` set (``set_global_batch_norm``, which ``StepFactory`` calls
under a ``DataParallelPlan``) it normalises by the statistics of the whole
global batch, over every rank, as the JAX package's BatchNorm does over a
batch sharded on the mesh; each rank's sums count its own elements, so
bands of unequal height weigh by their rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import sharding_hints
from ..parallel.halo import halo_rows
from ..parallel.mesh import sum_over_ranks

LEAKY_SLOPE = 0.1


def _cast(t: torch.Tensor | None, dtype: torch.dtype | None):
    return t if t is None or dtype is None else t.to(dtype)


def _convolve(conv, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor | None) -> torch.Tensor:
    """``conv(x, w, b)``.  On the CPU a float16 convolution runs as the
    float32 convolution of its float16 operands, rounded once to float16,
    forward and backward alike: what cuDNN's float16 convolutions, which
    accumulate in float32, compute on the card.  torch's own CPU float16
    convolution backward has no fast kernel (35 s for one FlowNet2CS step
    at 64x128, against 2 s in float32)."""
    if x.dtype != torch.float16 or x.device.type != "cpu":
        return conv(x, w, b)
    return conv(x.float(), w.float(), _cast(b, torch.float32)).half()


def _band_config(module: nn.Module, x: torch.Tensor, what: str):
    """(kernel rows, stride, padding rows) of ``module`` on a band ``x``."""
    (k, _), (s, _), (p, _) = (module.kernel_size, module.stride,
                              module.padding)
    if module.dilation[0] != 1 or module.padding_mode != "zeros":
        raise NotImplementedError(f"{what} on row bands: dilation 1 and zero "
                                  "padding only")
    if what == "Conv2d" and x.shape[2] % s:
        raise ValueError(f"{what} of stride {s} on a band of {x.shape[2]} "
                         "rows")
    return k, s, p


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose forward casts the input and its float32
    parameters to ``compute_dtype`` (None: no cast).  Under a band context
    output row ``o`` reads input rows ``[o*s - p, o*s - p + k)``: a band of
    ``h`` rows takes ``p`` rows from the band above and ``k - s - p`` from
    the band below (7x7 s2 p3: 3 and 2; 5x5 s2 p2: 2 and 1; 3x3 s1 p1: 1
    and 1), and gives its ``h / s`` output rows."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w, b = _cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt)
        band = sharding_hints.band()
        if band is None:
            return _convolve(self._conv_forward, x, w, b)
        k, s, p = _band_config(self, x, "Conv2d")
        bottom = k - s - p
        x = halo_rows(x, p, max(bottom, 0), band)
        if bottom < 0:
            x = x[:, :, :bottom]
        sharding_hints.record_dispatch(
            "convolution", f"process group(spatial={band.size})+halo rows")
        return _convolve(lambda x, w, b: F.conv2d(
            x, w, b, self.stride, (0, self.padding[1]), self.dilation,
            self.groups), x, w, b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (without ``output_size``) whose forward casts
    like ``Conv2d``'s.  Under a band context output row ``o`` takes input
    rows ``i`` with ``o + p - i*s`` in ``[0, k)``: a band of ``h`` rows
    takes ``(k - 1 - p) // s`` rows from the band above and ``(p + s - 1)
    // s`` from the band below (4x4 s2 p1: 1 and 1), is convolved without
    padding in H and cropped to its ``s * h`` output rows."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w, b = _cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt)
        band = sharding_hints.band()
        if band is None:
            return _convolve(lambda x, w, b: F.conv_transpose2d(
                x, w, b, self.stride, self.padding, self.output_padding,
                self.groups, self.dilation), x, w, b)
        k, s, p = _band_config(self, x, "ConvTranspose2d")
        if self.output_padding[0]:
            raise NotImplementedError("ConvTranspose2d on row bands: no "
                                      "output padding in H")
        top, height = (k - 1 - p) // s, x.shape[2]
        x = halo_rows(x, top, (p + s - 1) // s, band)
        sharding_hints.record_dispatch(
            "transposed convolution",
            f"process group(spatial={band.size})+halo rows")
        out = _convolve(lambda x, w, b: F.conv_transpose2d(
            x, w, b, self.stride, (0, self.padding[1]),
            (0, self.output_padding[1]), self.groups, self.dilation), x, w, b)
        first = top * s + p
        return out[:, :, first:first + s * height]


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that, with ``global_batch`` set, normalises in
    ``train()`` mode by the mean and the biased variance of the global
    batch: each rank's per-channel count, sum and sum of squares are
    all-reduced (``parallel.sum_over_ranks``, whose backward all-reduces
    the gradient too, over gloo and NCCL alike), and the
    variance is E[x^2] - E[x]^2, as Flax computes it.  The running
    statistics take the global mean and the unbiased global variance, as
    torch's own BatchNorm2d takes its batch's.  A bfloat16 or float16
    input is upcast to float32 for the statistics and the normalisation,
    and the result is rounded once to its dtype (Flax's float32
    reductions); the sums over the ranks are float32."""

    global_batch: bool = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.bfloat16, torch.float16):
            return self._forward(x.float()).to(x.dtype)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.global_batch):
            return super().forward(x)
        if not dist.is_initialized():
            raise RuntimeError("BatchNorm2d with global_batch set needs a "
                               "process group (parallel.init_distributed)")
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=x.dtype,
                           device=x.device)
        stats = sum_over_ranks(torch.cat(
            [x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]))
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
                self.num_batches_tracked.add_(1)
        # Flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        shape = (1, c, 1, 1)
        mul = torch.rsqrt(var + self.eps)
        if self.affine:
            mul = mul * self.weight
        y = (x - mean.view(shape)) * mul.view(shape)
        return y + self.bias.view(shape) if self.affine else y


def set_global_batch_norm(model: nn.Module) -> nn.Module:
    """Make every ``BatchNorm2d`` of ``model`` normalise by the global
    batch's statistics, and return ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.global_batch = True
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype | None):
    """Make every convolution of ``model`` cast to ``dtype`` at each call
    (None: no cast) and return ``model``.  The BatchNorm layers follow the
    dtype of their input (``BatchNorm2d``)."""
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
        layers.append(BatchNorm2d(out_planes))
    layers.append(nn.LeakyReLU(LEAKY_SLOPE, inplace=True))
    return nn.Sequential(*layers)


def i_conv(in_planes: int, out_planes: int, kernel_size: int = 3,
           stride: int = 1, batch_norm: bool = False,
           bias: bool = True) -> nn.Sequential:
    layers = [Conv2d(in_planes, out_planes, kernel_size, stride,
                     padding=(kernel_size - 1) // 2, bias=bias)]
    if batch_norm:
        layers.append(BatchNorm2d(out_planes))
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
