"""Correlation cost volume, forward only.

Counterpart of flownet2_tpu/ops/correlation.py (the plain shifts form) and
of the Pallas forward kernels in flownet2_tpu/ops/correlation_pallas.py
(the CUDA kernel ``csrc/correlation_fwd.cu``).  Semantics of the
reference's Correlation op, with the JAX package's in-bounds centring for
kernel_size > 1:

    d_rad = max_displacement // stride2,  D = 2*d_rad + 1
    k_rad = (kernel_size - 1) // 2,       b_rad = k_rad + max_displacement
    out[b, (tj+d_rad)*D + (ti+d_rad), y, x]
      = 1/(K*K*C) * sum_{j,i in KxK} sum_c
          f1p[b, c, y*s1 + b_rad + j,         x*s1 + b_rad + i]
        * f2p[b, c, y*s1 + b_rad + tj*s2 + j, x*s1 + b_rad + ti*s2 + i]

with f1p, f2p zero-padded by ``pad_size``.  FlowNetC uses pad 20, K 1,
maxd 20, s1 1, s2 2: 441 output channels at the input's size.
``corr_multiply`` is accepted and, as in the reference, ignored.

Layout: NCHW in, ``(B, D*D, out_h, out_w)`` out.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel (K 1, s1 1,
pad == maxd, float32) or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _cuda

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_MAX_GRID_YZ = 65535


def _out_dims(height, width, pad_size, kernel_size, max_displacement,
              stride1):
    b_rad = (kernel_size - 1) // 2 + max_displacement
    out_h = int(math.ceil((height + 2 * pad_size - 2 * b_rad) / stride1))
    out_w = int(math.ceil((width + 2 * pad_size - 2 * b_rad) / stride1))
    return out_h, out_w


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, pad_size: int = 20,
                      kernel_size: int = 1, max_displacement: int = 20,
                      stride1: int = 1, stride2: int = 2) -> torch.Tensor:
    """The general shifts form, on any device."""
    _cuda.PLAIN_CALLS["correlation"] += 1
    channels, height, width = f1.shape[1:]
    d_rad = max_displacement // stride2
    k_rad = (kernel_size - 1) // 2
    b_rad = k_rad + max_displacement
    out_h, out_w = _out_dims(height, width, pad_size, kernel_size,
                             max_displacement, stride1)
    nelems = kernel_size * kernel_size * channels

    # An extra stride1 of padding covers the ceil() overhang of the grid.
    pp = pad_size + stride1
    f1p = F.pad(f1, (pp, pp, pp, pp))
    f2p = F.pad(f2, (pp, pp, pp, pp))

    def window(xp, dy, dx):
        return xp[:, :, dy:dy + (out_h - 1) * stride1 + 1:stride1,
                  dx:dx + (out_w - 1) * stride1 + 1:stride1]

    outs = []
    for tj in range(-d_rad, d_rad + 1):
        for ti in range(-d_rad, d_rad + 1):
            acc = 0.0
            for j in range(-k_rad, k_rad + 1):
                for i in range(-k_rad, k_rad + 1):
                    oy = stride1 + b_rad + j
                    ox = stride1 + b_rad + i
                    w1 = window(f1p, oy, ox)
                    w2 = window(f2p, oy + tj * stride2, ox + ti * stride2)
                    acc = acc + torch.sum(w1 * w2, dim=1)
            outs.append(acc / nelems)
    return torch.stack(outs, dim=1)


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, pad_size: int = 20,
                     kernel_size: int = 1, max_displacement: int = 20,
                     stride1: int = 1, stride2: int = 2) -> torch.Tensor:
    """The CUDA cost volume: K 1, s1 1, pad == maxd, float32, any width."""
    name = "correlation_fwd"
    if not (kernel_size == 1 and stride1 == 1
            and pad_size == max_displacement >= 0 and stride2 >= 1):
        raise NotImplementedError(
            "correlation on CUDA: the kernel covers kernel_size=1, "
            "stride1=1, pad_size=max_displacement (got "
            f"pad={pad_size}, K={kernel_size}, maxd={max_displacement}, "
            f"s1={stride1}, s2={stride2})")
    _cuda.reject_grad(name, f1, f2)
    device = f1.device
    _cuda.check_operand(name, "f1", f1, 4, device)
    _cuda.check_operand(name, "f2", f2, 4, device)
    if f2.shape != f1.shape:
        raise ValueError(f"{name}: f1 {tuple(f1.shape)} and f2 "
                         f"{tuple(f2.shape)} differ")
    batch, channels, height, width = f1.shape
    if batch > _MAX_GRID_YZ or height > _MAX_GRID_YZ:
        raise ValueError(f"{name}: B and H must be <= {_MAX_GRID_YZ}")
    disp = 2 * (max_displacement // stride2) + 1
    out = torch.empty((batch, disp * disp, height, width),
                      dtype=f1.dtype, device=device)
    if out.numel() == 0:
        return out
    fn = _cuda.function("correlation_fwd", "correlation_fwd", _ARGTYPES)
    err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), batch, channels,
             height, width, max_displacement, stride2, device.index,
             _cuda.stream_ptr(device))
    _cuda.LAUNCHES[name] += 1
    _cuda.check("correlation_fwd", name, err)
    return out


def correlation(f1: torch.Tensor, f2: torch.Tensor, pad_size: int = 20,
                kernel_size: int = 1, max_displacement: int = 20,
                stride1: int = 1, stride2: int = 2,
                corr_multiply: int = 1) -> torch.Tensor:
    """Cost volume between two NCHW feature maps -> (B, D*D, out_h, out_w)."""
    del corr_multiply
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, pad_size, kernel_size,
                                 max_displacement, stride1, stride2)
    return correlation_cuda(f1, f2, pad_size, kernel_size, max_displacement,
                            stride1, stride2)
