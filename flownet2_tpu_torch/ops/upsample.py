"""Flow upsampling and the loss's pooling (counterpart of
flownet2_tpu/ops/upsample.py), NCHW.

The reference upsamples with ``nn.Upsample(scale_factor=4)``: bilinear
(align_corners=False) after FlowNetC and the first FlowNetS, nearest after
the second FlowNetS and FlowNetSD.

The bilinear upsample's forward is ``F.interpolate``.  Its backward is not:
torch's, on CUDA, accumulates the cotangent with atomic adds in no fixed
order (``upsample_bilinear2d_backward_out_cuda``), so two backward passes
over one forward give gradients that differ in their last bits.  The
backward here is a fixed sum of gathered taps, the same bits on every
run.

Under a band context (``sharding_hints.scoped_band``) the bilinear upsample
of a band takes one low-resolution row from each neighbouring band
(``parallel.halo_rows``), or repeats its own edge row at the image's top
and bottom, where ``F.interpolate`` clamps; it interpolates that and crops
its ``scale * h`` rows.  Its backward is the same fixed sum, then the
halo's transpose.  The nearest upsample and the pooling are row-local.
"""

from __future__ import annotations

import functools
import sys
import types

import torch
import torch.nn.functional as F

from . import sharding_hints


@functools.lru_cache(maxsize=None)
def _taps(n_out: int, scale: int, device: torch.device):
    """The gather indices and weights of ``_linear_transpose`` for n_out
    outputs, made on ``device`` once (no host-to-device copy a step)."""
    half = scale // 2
    taps = torch.arange(-half, scale + half, device=device)
    at = (scale * torch.arange(n_out // scale, device=device)[:, None]
          + taps).reshape(-1)
    at = torch.where(at < 0, -1 - at, at)
    at = torch.where(at >= n_out, 2 * n_out - 1 - at, at)
    weights = 1 - (2 * taps + 1 - scale).abs() / (2 * scale)
    return at, weights.float()


def _linear_transpose(g: torch.Tensor, scale: int, dim: int) -> torch.Tensor:
    """The transpose of the align_corners=False linear upsample by an
    integer ``scale`` along ``dim``: ``g`` of n*scale along ``dim`` -> n.

    Output ``scale*i + p`` samples source ``i + f_p``,
    ``f_p = (2p + 1 - scale) / (2 scale)``, so source ``j`` takes output
    ``scale*j + t`` with the weight ``1 - |(2t + 1 - scale) / (2 scale)|``
    for ``t`` in ``[-(scale // 2), scale + scale // 2)``: for scale 4,
    outputs 4j - 2 .. 4j + 5 with weights 1, 3, 5, 7, 7, 5, 3, 1 eighths.
    At the ends torch clamps the source coordinate to 0 and the upper tap to
    n - 1, so the taps that fall outside land on index 0 and n - 1; the
    cotangent mirrored by ``scale // 2`` outputs at each end (output -1 is
    output 0, -2 is 1; likewise past the last) gives them those weights.
    One gather of the taps, one product and one sum over them: no atomics,
    no matmul."""
    at, weights = _taps(g.shape[dim], scale, g.device)
    shape = [1] * (g.dim() + 1)
    shape[dim + 1] = weights.numel()
    gathered = g.index_select(dim, at).unflatten(
        dim, (g.shape[dim] // scale, weights.numel()))
    return (gathered * weights.to(g.dtype).view(shape)).sum(dim + 1)


class _UpsampleBilinear(torch.autograd.Function):
    """``F.interpolate(x, scale_factor=scale, mode="bilinear",
    align_corners=False)`` with a deterministic backward: the transpose of
    the H axis and then of the W axis, in float32 (float64 for float64),
    rounded once to the input's dtype."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        wide = g.to(torch.promote_types(g.dtype, torch.float32))
        d_x = _linear_transpose(_linear_transpose(wide, ctx.scale, 2),
                                ctx.scale, 3)
        return d_x.to(g.dtype), None


def upsample_bilinear(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """NCHW bilinear upsample by an integer ``scale``, torch
    align_corners=False semantics; its backward is deterministic."""
    if int(scale) != scale or scale < 1:
        raise ValueError(f"upsample_bilinear: scale {scale} is not a "
                         "positive integer")
    scale = int(scale)
    band = sharding_hints.band()
    if band is None:
        return _UpsampleBilinear.apply(x, scale)
    from ..parallel.halo import halo_rows

    # output rows [s*a, s*(a + h)) read source rows a - 1 .. a + h
    height = x.shape[2]
    x = halo_rows(x, 1, 1, band)
    if band.index == 0:
        x = torch.cat([x[:, :, 1:2], x[:, :, 1:]], dim=2)
    if band.index == band.size - 1:
        x = torch.cat([x[:, :, :-1], x[:, :, -2:-1]], dim=2)
    sharding_hints.record_dispatch(
        "upsample_bilinear", f"process group(spatial={band.size})+halo rows")
    return _UpsampleBilinear.apply(x, scale)[:, :, scale:scale * (height + 1)]


def upsample_nearest(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample(x: torch.Tensor, scale: int = 4,
             mode: str = "bilinear") -> torch.Tensor:
    """The JAX package's ``upsample(x, scale, mode)``: bilinear or nearest
    by an integer ``scale``."""
    if mode == "bilinear":
        return upsample_bilinear(x, scale)
    if mode == "nearest":
        return upsample_nearest(x, scale)
    raise ValueError(f"unknown upsample mode {mode!r}")


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """NCHW average pool with stride == window (torch ``AvgPool2d(k, k)``),
    as the MultiScale loss pools its target."""
    return F.avg_pool2d(x, window, window)


class _CallableModule(types.ModuleType):
    """This module, callable as ``upsample``: ``ops.upsample(x, scale,
    mode)`` is the JAX package's ``ops.upsample``, and ``ops.upsample``
    stays the module its users import."""

    def __call__(self, x: torch.Tensor, scale: int = 4,
                 mode: str = "bilinear") -> torch.Tensor:
        return upsample(x, scale, mode)


sys.modules[__name__].__class__ = _CallableModule
