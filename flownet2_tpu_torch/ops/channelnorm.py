"""Channel-wise L2 norm (counterpart of flownet2_tpu/ops/channelnorm.py).

Plain PyTorch: an elementwise square and a reduction over the channel axis,
which the JAX package also left to the compiler rather than to a kernel.
NCHW in, ``(B, 1, H, W)`` out.

The backward is the reference's ``g * x / (norm + 1e-9)``, as the JAX
package pins it: autograd of ``sqrt`` would give NaN wherever the norm is
exactly 0 (two frames that agree at a pixel, as in letterbox bars).
"""

from __future__ import annotations

import torch

_EPS = 1e-9


class _ChannelNorms(torch.autograd.Function):
    """The norms of N inputs as one ``(B, N, H, W)`` tensor."""

    @staticmethod
    def forward(ctx, *xs):
        out = torch.cat([torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
                         for x in xs], dim=1)
        ctx.save_for_backward(out, *xs)
        return out

    @staticmethod
    def backward(ctx, g):
        out, *xs = ctx.saved_tensors
        return tuple(
            g[:, i:i + 1] * x / (out[:, i:i + 1] + _EPS)
            if ctx.needs_input_grad[i] else None
            for i, x in enumerate(xs))


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum_c x^2), keeping a singleton channel axis."""
    return _ChannelNorms.apply(x)


def channel_norm_multi(*xs: torch.Tensor) -> torch.Tensor:
    """``cat([channel_norm(x) for x in xs], 1)``: one ``(B, N, H, W)``
    tensor of the N inputs' norms."""
    return _ChannelNorms.apply(*xs)
