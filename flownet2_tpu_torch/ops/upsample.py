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
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


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
    return _UpsampleBilinear.apply(x, int(scale))


def upsample_nearest(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """NCHW average pool with stride == window (torch ``AvgPool2d(k, k)``),
    as the MultiScale loss pools its target."""
    return F.avg_pool2d(x, window, window)
