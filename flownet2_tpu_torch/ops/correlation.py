"""Correlation cost volume and its gradient.

Counterpart of flownet2_tpu/ops/correlation.py (the plain shifts form and
the explicit backward ``_corr_bwd``) and of the Pallas kernels in
flownet2_tpu/ops/correlation_pallas.py (the CUDA kernels
``csrc/correlation_fwd.cu`` and ``csrc/correlation_bwd.cu``).  Semantics
of the reference's Correlation op, with the JAX package's in-bounds
centring for kernel_size > 1:

    d_rad = max_displacement // stride2,  D = 2*d_rad + 1
    k_rad = (kernel_size - 1) // 2,       b_rad = k_rad + max_displacement
    out[b, (tj+d_rad)*D + (ti+d_rad), y, x]
      = 1/(K*K*C) * sum_{j,i in KxK} sum_c
          f1p[b, c, y*s1 + b_rad + j,         x*s1 + b_rad + i]
        * f2p[b, c, y*s1 + b_rad + tj*s2 + j, x*s1 + b_rad + ti*s2 + i]

with f1p, f2p zero-padded by ``pad_size``.  FlowNetC uses pad 20, K 1,
maxd 20, s1 1, s2 2: 441 output channels at the input's size.
``corr_multiply`` is accepted and, as in the reference, ignored.

For K 1, s1 1, pad == maxd (the only configuration a model uses) the op is
a ``torch.autograd.Function``: its gradient, with d = (tj+d_rad)*D +
(ti+d_rad) and out-of-range terms zero, is

    d_f1[b, c, y, x]   = 1/C sum_d g[b, d, y, x]
                                  * f2[b, c, y + tj*s2, x + ti*s2]
    d_f2[b, c, y2, x2] = 1/C sum_d g[b, d, y2 - tj*s2, x2 - ti*s2]
                                  * f1[b, c, y2 - tj*s2, x2 - ti*s2]

Every other configuration (kernel_size, stride1, stride2 >= 1, pad and
max_displacement >= 0) is the ``torch.autograd.Function`` ``_CorrelationCfg``:
forward ``correlation_plain`` or the kernel ``csrc/correlation_cfg.cu``, and
a gradient that gathers, for each input element, every (tj, ti, j, i)
whose output reads it (``correlation_cfg_bwd_plain`` or the same source's
backward kernels).  An output with no rows or columns launches nothing.

Layout: NCHW in, ``(B, D*D, out_h, out_w)`` out.  A CPU tensor takes the
plain versions; a CUDA tensor launches the kernels (float32, or bfloat16 or
float16 with outputs of the same dtype: float32 sums, one rounding) or
raises.  With ``sharding_hints.spatial_shards() > 1``, or under a band
context across processes, the K 1, s1 1, pad == maxd configuration runs as
row bands against halo slabs of f2 (``ops/correlation_spatial.py``); other
configurations have no band form, and under a band context they raise.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _cuda, sharding_hints

# Every entry point of csrc/correlation_fwd.cu and csrc/correlation_bwd.cu,
# the row-slab ones included: three tensors, B, C, H, W, maxd, s2, the
# device index and the stream.  ctypes checks nothing against the
# ``extern "C"`` signatures, so the two change together.
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ENTRY_POINTS = {
    "correlation_fwd": tuple(
        base + sfx for sfx in _cuda.KERNEL_DTYPES.values()
        for base in ("correlation_fwd", "correlation_fwd_rows")),
    "correlation_bwd": tuple(
        base + sfx for sfx in _cuda.KERNEL_DTYPES.values()
        for base in ("correlation_bwd_f1", "correlation_bwd_f2",
                     "correlation_bwd_f1_rows", "correlation_bwd_f2_rows")),
}
# Every entry point of csrc/correlation_cfg.cu: three tensors, B, C, H, W,
# pad, K, maxd, s1, s2, the device index and the stream.
_CFG_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_ENTRY_POINTS["correlation_cfg"] = tuple(
    base + sfx for sfx in _cuda.KERNEL_DTYPES.values()
    for base in ("correlation_cfg_fwd", "correlation_cfg_bwd_f1",
                 "correlation_cfg_bwd_f2"))
_MAX_GRID_YZ = 65535


def _out_dims(height, width, pad_size, kernel_size, max_displacement,
              stride1):
    b_rad = (kernel_size - 1) // 2 + max_displacement
    out_h = int(math.ceil((height + 2 * pad_size - 2 * b_rad) / stride1))
    out_w = int(math.ceil((width + 2 * pad_size - 2 * b_rad) / stride1))
    return out_h, out_w


def _kernel_config(pad_size, kernel_size, max_displacement, stride1,
                   stride2) -> bool:
    return (kernel_size == 1 and stride1 == 1
            and pad_size == max_displacement >= 0 and stride2 >= 1)


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, pad_size: int = 20,
                      kernel_size: int = 1, max_displacement: int = 20,
                      stride1: int = 1, stride2: int = 2) -> torch.Tensor:
    """The general shifts form, on any device.  bfloat16 and float16
    operands are upcast, multiplied and summed in float32, and the output
    is rounded once to their dtype, as the kernel and the JAX package
    do."""
    _cuda.PLAIN_CALLS["correlation"] += 1
    dtype = f1.dtype
    f1, f2 = _cuda.widened(f1), _cuda.widened(f2)
    batch, channels, height, width = f1.shape
    d_rad = max_displacement // stride2
    k_rad = (kernel_size - 1) // 2
    b_rad = k_rad + max_displacement
    out_h, out_w = _out_dims(height, width, pad_size, kernel_size,
                             max_displacement, stride1)
    if out_h <= 0 or out_w <= 0:
        disp = 2 * d_rad + 1
        return f1.new_zeros((batch, disp * disp, max(out_h, 0),
                             max(out_w, 0)), dtype=dtype)
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
    return torch.stack(outs, dim=1).to(dtype)


def correlation_bwd_plain(g: torch.Tensor, f1: torch.Tensor,
                          f2: torch.Tensor, max_displacement: int = 20,
                          stride2: int = 2, needs=(True, True)):
    """(d_f1, d_f2) of the K 1, s1 1, pad == maxd cost volume for the
    cotangent ``g`` (B, D*D, H, W), on any device; an input whose entry in
    ``needs`` is False gets None.  The explicit D*D-step loop of the JAX
    package's ``_corr_bwd``, accumulating in place: autograd of the
    forward would keep D*D products of the inputs' size alive.  bfloat16
    and float16 g, f1 and f2 are upcast, summed in float32, divided by C
    and rounded once to f1's dtype, as the JAX package's ``_corr_bwd`` and
    the kernels do."""
    _cuda.PLAIN_CALLS["correlation_bwd"] += 1
    dtype = f1.dtype
    g, f1, f2 = (_cuda.widened(t) for t in (g, f1, f2))
    batch, channels, height, width = f1.shape
    maxd = max_displacement
    d_rad = maxd // stride2
    disp = 2 * d_rad + 1
    pad = (maxd, maxd, maxd, maxd)
    need_f1, need_f2 = needs
    d_f1 = torch.zeros_like(f1) if need_f1 else None
    d_f2 = torch.zeros_like(f2) if need_f2 else None
    # Everything padded once by maxd, so every shift is a plain slice:
    # d_f1 reads f2 at +shift, d_f2 reads g and f1 at -shift.
    f2p = F.pad(f2, pad) if need_f1 else None
    gp = F.pad(g, pad) if need_f2 else None
    f1p = F.pad(f1, pad) if need_f2 else None
    for tj in range(-d_rad, d_rad + 1):
        for ti in range(-d_rad, d_rad + 1):
            d = (tj + d_rad) * disp + (ti + d_rad)
            if need_f1:
                oy, ox = maxd + tj * stride2, maxd + ti * stride2
                d_f1.addcmul_(g[:, d:d + 1],
                              f2p[:, :, oy:oy + height, ox:ox + width])
            if need_f2:
                oy, ox = maxd - tj * stride2, maxd - ti * stride2
                d_f2.addcmul_(gp[:, d:d + 1, oy:oy + height, ox:ox + width],
                              f1p[:, :, oy:oy + height, ox:ox + width])
    return (None if d_f1 is None else (d_f1 / channels).to(dtype),
            None if d_f2 is None else (d_f2 / channels).to(dtype))


def correlation_cfg_bwd_plain(g: torch.Tensor, f1: torch.Tensor,
                              f2: torch.Tensor, pad_size: int,
                              kernel_size: int, max_displacement: int,
                              stride1: int, stride2: int, needs=(True, True)):
    """(d_f1, d_f2) of ``correlation_plain`` at any configuration for the
    cotangent ``g`` (B, D*D, out_h, out_w), on any device; an input whose
    entry in ``needs`` is False gets None.  For each (tj, ti, j, i) in
    order, the strided windows that the forward multiplied take the
    cotangent times the other window, accumulated in place into padded
    gradients: autograd of the forward would keep D*D*K*K products of the
    inputs' size alive.  bfloat16 and float16 are summed in float32,
    divided by K*K*C and rounded once to f1's dtype, as the kernels do."""
    _cuda.PLAIN_CALLS["correlation_cfg_bwd"] += 1
    dtype = f1.dtype
    g, f1, f2 = (_cuda.widened(t) for t in (g, f1, f2))
    channels, height, width = f1.shape[1:]
    d_rad = max_displacement // stride2
    disp = 2 * d_rad + 1
    k_rad = (kernel_size - 1) // 2
    b_rad = k_rad + max_displacement
    out_h, out_w = _out_dims(height, width, pad_size, kernel_size,
                             max_displacement, stride1)
    nelems = kernel_size * kernel_size * channels
    need_f1, need_f2 = needs
    # padded as the forward pads, so that every window is a strided slice
    pp = pad_size + stride1
    pad = (pp, pp, pp, pp)
    f1p = F.pad(f1, pad) if need_f2 else None
    f2p = F.pad(f2, pad) if need_f1 else None
    padded = f1.shape[:2] + (height + 2 * pp, width + 2 * pp)
    d_f1p = f1.new_zeros(padded) if need_f1 else None
    d_f2p = f1.new_zeros(padded) if need_f2 else None

    def window(xp, dy, dx):
        return xp[:, :, dy:dy + (out_h - 1) * stride1 + 1:stride1,
                  dx:dx + (out_w - 1) * stride1 + 1:stride1]

    if out_h > 0 and out_w > 0:
        for tj in range(-d_rad, d_rad + 1):
            for ti in range(-d_rad, d_rad + 1):
                d = (tj + d_rad) * disp + (ti + d_rad)
                gd = g[:, d:d + 1]
                for j in range(-k_rad, k_rad + 1):
                    for i in range(-k_rad, k_rad + 1):
                        oy = stride1 + b_rad + j
                        ox = stride1 + b_rad + i
                        oy2, ox2 = oy + tj * stride2, ox + ti * stride2
                        if need_f1:
                            window(d_f1p, oy, ox).addcmul_(
                                gd, window(f2p, oy2, ox2))
                        if need_f2:
                            window(d_f2p, oy2, ox2).addcmul_(
                                gd, window(f1p, oy, ox))
    crop = (slice(None), slice(None), slice(pp, pp + height),
            slice(pp, pp + width))
    return tuple(None if d is None else (d[crop] / nelems).to(dtype)
                 for d in (d_f1p, d_f2p))


def _check_config(name, pad_size, kernel_size, max_displacement, stride1,
                  stride2):
    if not _kernel_config(pad_size, kernel_size, max_displacement, stride1,
                          stride2):
        raise NotImplementedError(
            f"{name} on CUDA: the kernel covers kernel_size=1, "
            "stride1=1, pad_size=max_displacement (got "
            f"pad={pad_size}, K={kernel_size}, maxd={max_displacement}, "
            f"s1={stride1}, s2={stride2})")


def _check_features(name, f1, f2, dtypes=(torch.float32,)):
    device = f1.device
    _cuda.check_operand(name, "f1", f1, 4, device, dtypes)
    _cuda.check_operand(name, "f2", f2, 4, device, dtypes)
    if f2.dtype != f1.dtype:
        raise TypeError(f"{name}: f1 is {f1.dtype} and f2 {f2.dtype}")
    if f2.shape != f1.shape:
        raise ValueError(f"{name}: f1 {tuple(f1.shape)} and f2 "
                         f"{tuple(f2.shape)} differ")
    if f1.shape[0] > _MAX_GRID_YZ or f1.shape[2] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: B and H must be <= {_MAX_GRID_YZ}")
    return device


def _launch(lib: str, name: str, tensors, f1: torch.Tensor,
            max_displacement: int, stride2: int) -> None:
    """Run the C entry point ``name`` of ``csrc/<lib>.cu`` on ``tensors``
    and f1's (B, C, H, W) on the current stream, and count the launch."""
    device = f1.device
    fn = _cuda.function(lib, name, _ARGTYPES)
    err = fn(*(t.data_ptr() for t in tensors), *f1.shape, max_displacement,
             stride2, device.index, _cuda.stream_ptr(device))
    _cuda.LAUNCHES[name] += 1
    _cuda.check(lib, name, err)


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, pad_size: int = 20,
                     kernel_size: int = 1, max_displacement: int = 20,
                     stride1: int = 1, stride2: int = 2) -> torch.Tensor:
    """The CUDA cost volume (K1): K 1, s1 1, pad == maxd, any width;
    float32, or bfloat16 or float16 f1 and f2 with an output of their dtype
    (entry points ``correlation_fwd_bf16``, ``correlation_fwd_fp16``: the
    tensor-core body at maxd 20, s2 2 in either dtype, the general body at
    any other configuration)."""
    name = "correlation_fwd" + _cuda.suffix(f1.dtype)
    _check_config("correlation", pad_size, kernel_size, max_displacement,
                  stride1, stride2)
    device = _check_features(name, f1, f2, tuple(_cuda.KERNEL_DTYPES))
    batch, channels, height, width = f1.shape
    disp = 2 * (max_displacement // stride2) + 1
    out = torch.empty((batch, disp * disp, height, width),
                      dtype=f1.dtype, device=device)
    if out.numel():
        _launch("correlation_fwd", name, (f1, f2, out), f1, max_displacement,
                stride2)
    return out


def correlation_bwd_cuda(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                         max_displacement: int = 20, stride2: int = 2,
                         needs=(True, True)):
    """The CUDA gradient of the cost volume: d_f1 by K5 and d_f2 by K6
    (``csrc/correlation_bwd.cu``), each launched only where ``needs``
    asks; any width.  float32, or bfloat16 or float16 g, f1 and f2 with
    gradients of their dtype (entry points ``correlation_bwd_f1_bf16``,
    ``correlation_bwd_f2_bf16`` and their ``_fp16`` forms: float32 sums of
    the exact products, one rounding; at maxd 20, s2 2 both tensor-core
    bodies in either dtype, the general bodies, which upcast the operands,
    at any other configuration)."""
    _check_config("correlation backward", max_displacement, 1,
                  max_displacement, 1, stride2)
    dtypes = tuple(_cuda.KERNEL_DTYPES)
    device = _check_features("correlation_bwd", f1, f2, dtypes)
    batch, channels, height, width = f1.shape
    disp = 2 * (max_displacement // stride2) + 1
    _cuda.check_operand("correlation_bwd", "g", g, 4, device, dtypes)
    if g.dtype != f1.dtype:
        raise TypeError(f"correlation_bwd: g is {g.dtype} and f1 "
                        f"{f1.dtype}")
    suffix = _cuda.suffix(f1.dtype)
    if g.shape != (batch, disp * disp, height, width):
        raise ValueError(f"correlation_bwd: g {tuple(g.shape)} does not "
                         f"match f1 {tuple(f1.shape)} and D*D = "
                         f"{disp * disp}")
    grads = []
    for name, src, need in (("correlation_bwd_f1", f2, needs[0]),
                            ("correlation_bwd_f2", f1, needs[1])):
        if not need:
            grads.append(None)
            continue
        out = torch.empty_like(f1)
        if out.numel():
            _launch("correlation_bwd", name + suffix, (g, src, out), f1,
                    max_displacement, stride2)
        grads.append(out)
    return tuple(grads)


def _check_cfg(pad_size, kernel_size, max_displacement, stride1,
               stride2) -> None:
    """Raise ``ValueError`` for a configuration the op does not define
    (the JAX package fails on it: K 0 divides by zero)."""
    if (kernel_size < 1 or stride1 < 1 or stride2 < 1 or pad_size < 0
            or max_displacement < 0):
        raise ValueError(
            "correlation: kernel_size, stride1 and stride2 must be >= 1 and "
            f"pad_size, max_displacement >= 0 (got pad={pad_size}, "
            f"K={kernel_size}, maxd={max_displacement}, s1={stride1}, "
            f"s2={stride2})")


def _cfg_launch(name: str, tensors, f1: torch.Tensor, config) -> None:
    """Run the C entry point ``name`` of ``csrc/correlation_cfg.cu`` on
    ``tensors``, f1's (B, C, H, W) and ``config`` (pad, K, maxd, s1, s2) on
    the current stream, and count the launch."""
    device = f1.device
    fn = _cuda.function("correlation_cfg", name, _CFG_ARGTYPES)
    err = fn(*(t.data_ptr() for t in tensors), *f1.shape, *config,
             device.index, _cuda.stream_ptr(device))
    _cuda.LAUNCHES[name] += 1
    _cuda.check("correlation_cfg", name, err)


def _cfg_out_shape(f1: torch.Tensor, config):
    """(B, D*D, out_h, out_w) of the cost volume, empty where the map is
    too small for the window."""
    pad_size, kernel_size, max_displacement, stride1, stride2 = config
    out_h, out_w = _out_dims(*f1.shape[2:], pad_size, kernel_size,
                             max_displacement, stride1)
    disp = 2 * (max_displacement // stride2) + 1
    if out_h > _MAX_GRID_YZ:
        raise ValueError(f"correlation: out_h {out_h} exceeds {_MAX_GRID_YZ}")
    return (f1.shape[0], disp * disp, max(out_h, 0), max(out_w, 0))


def correlation_cfg_cuda(f1: torch.Tensor, f2: torch.Tensor, pad_size: int,
                         kernel_size: int, max_displacement: int,
                         stride1: int, stride2: int) -> torch.Tensor:
    """The CUDA cost volume at any configuration
    (``csrc/correlation_cfg.cu``): float32, or bfloat16 or float16 f1 and
    f2 with an output of their dtype (entry points
    ``correlation_cfg_fwd_bf16``, ``_fp16``)."""
    config = (pad_size, kernel_size, max_displacement, stride1, stride2)
    _check_cfg(*config)
    name = "correlation_cfg_fwd" + _cuda.suffix(f1.dtype)
    device = _check_features(name, f1, f2, tuple(_cuda.KERNEL_DTYPES))
    out = torch.empty(_cfg_out_shape(f1, config), dtype=f1.dtype,
                      device=device)
    if out.numel():
        _cfg_launch(name, (f1, f2, out), f1, config)
    return out


def correlation_cfg_bwd_cuda(g: torch.Tensor, f1: torch.Tensor,
                             f2: torch.Tensor, pad_size: int,
                             kernel_size: int, max_displacement: int,
                             stride1: int, stride2: int, needs=(True, True)):
    """The CUDA gradient of the cost volume at any configuration: d_f1 and
    d_f2 by the gathers of ``csrc/correlation_cfg.cu``, each launched only
    where ``needs`` asks; float32, bfloat16 or float16 as the forward.  An
    empty cotangent gives zero gradients and launches nothing."""
    config = (pad_size, kernel_size, max_displacement, stride1, stride2)
    _check_cfg(*config)
    dtypes = tuple(_cuda.KERNEL_DTYPES)
    device = _check_features("correlation_cfg_bwd", f1, f2, dtypes)
    _cuda.check_operand("correlation_cfg_bwd", "g", g, 4, device, dtypes)
    if g.dtype != f1.dtype:
        raise TypeError(f"correlation_cfg_bwd: g is {g.dtype} and f1 "
                        f"{f1.dtype}")
    shape = _cfg_out_shape(f1, config)
    if g.shape != shape:
        raise ValueError(f"correlation_cfg_bwd: g {tuple(g.shape)} is not "
                         f"{shape}")
    suffix = _cuda.suffix(f1.dtype)
    grads = []
    for name, src, need in (("correlation_cfg_bwd_f1", f2, needs[0]),
                            ("correlation_cfg_bwd_f2", f1, needs[1])):
        if not need:
            grads.append(None)
        elif not g.numel():
            grads.append(torch.zeros_like(f1))
        else:
            out = torch.empty_like(f1)
            if out.numel():
                _cfg_launch(name + suffix, (g, src, out), f1, config)
            grads.append(out)
    return tuple(grads)


class _Correlation(torch.autograd.Function):
    """The K 1, s1 1, pad == maxd cost volume: K1 forward and K5/K6
    backward on CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride2):
        ctx.save_for_backward(f1, f2)
        ctx.config = (max_displacement, stride2)
        args = (max_displacement, 1, max_displacement, 1, stride2)
        if _cuda.on_cpu(f1):
            return correlation_plain(f1, f2, *args)
        return correlation_cuda(f1, f2, *args)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:2])
        bwd = (correlation_bwd_plain if _cuda.on_cpu(f1)
               else correlation_bwd_cuda)
        d_f1, d_f2 = bwd(g.contiguous(), f1, f2, *ctx.config, needs=needs)
        return d_f1, d_f2, None, None


class _CorrelationCfg(torch.autograd.Function):
    """The cost volume at any other configuration: the ``correlation_cfg``
    kernels on CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, f1, f2, config):
        ctx.save_for_backward(f1, f2)
        ctx.config = config
        if _cuda.on_cpu(f1):
            return correlation_plain(f1, f2, *config)
        return correlation_cfg_cuda(f1, f2, *config)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:2])
        bwd = (correlation_cfg_bwd_plain if _cuda.on_cpu(f1)
               else correlation_cfg_bwd_cuda)
        d_f1, d_f2 = bwd(g.contiguous(), f1, f2, *ctx.config, needs=needs)
        return d_f1, d_f2, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, pad_size: int = 20,
                kernel_size: int = 1, max_displacement: int = 20,
                stride1: int = 1, stride2: int = 2,
                corr_multiply: int = 1) -> torch.Tensor:
    """Cost volume between two NCHW feature maps -> (B, D*D, out_h, out_w),
    differentiable in both."""
    del corr_multiply
    if _kernel_config(pad_size, kernel_size, max_displacement, stride1,
                      stride2):
        band = sharding_hints.band()
        if band is not None:
            from .correlation_spatial import band_wrapper

            return band_wrapper(f1, f2, max_displacement, stride2, band)
        if sharding_hints.spatial_shards() > 1:
            from .correlation_spatial import spatial_wrapper

            out = spatial_wrapper(f1, f2, max_displacement, stride2)
            if out is not None:
                return out
        sharding_hints.record_dispatch(
            "correlation", "whole map, kernel="
            + ("plain" if _cuda.on_cpu(f1) else "cuda"))
        return _Correlation.apply(f1, f2, max_displacement, stride2)
    if sharding_hints.band() is not None:
        raise NotImplementedError("correlation on row bands: K 1, s1 1 and "
                                  "pad == max_displacement only")
    config = (pad_size, kernel_size, max_displacement, stride1, stride2)
    _check_cfg(*config)
    return _CorrelationCfg.apply(f1, f2, config)


class Correlation(torch.nn.Module):
    """The reference's Correlation op as a module without parameters: the
    JAX package's ``Correlation`` class, its constructor's arguments and
    defaults (the JAX package's ``impl``, its choice among its own forms,
    has no counterpart)."""

    def __init__(self, pad_size: int = 0, kernel_size: int = 0,
                 max_displacement: int = 0, stride1: int = 1,
                 stride2: int = 2, corr_multiply: int = 1):
        super().__init__()
        self.pad_size = pad_size
        self.kernel_size = kernel_size
        self.max_displacement = max_displacement
        self.stride1 = stride1
        self.stride2 = stride2
        self.corr_multiply = corr_multiply

    def forward(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        return correlation(f1, f2, self.pad_size, self.kernel_size,
                           self.max_displacement, self.stride1, self.stride2,
                           self.corr_multiply)
