"""Flow warping (backward resampling) and its gradients.

Counterpart of flownet2_tpu/ops/resample2d.py (the plain form and its
custom VJP) and of the Pallas kernels in flownet2_tpu/ops/resample2d_pallas.py
(the CUDA kernels ``csrc/resample2d_fwd.cu`` K2,
``csrc/resample2d_tangents.cu`` K3 and ``csrc/resample2d_grad_flow.cu``
K4).  Semantics of the reference's Resample2d op:

    xf = x + flow[:, 0], yf = y + flow[:, 1]      (channel 0 is dx)
    bilinear: corners floor/floor+1 clamped to the image, weights not
      renormalised at the border; with kernel_size K each corner read is
      summed over a KxK window of taps that reuse the unshifted weights.
    nearest: index floor(xf + 0.5), clamped.

Layout: image ``(B, C, H, W)``, flow ``(B, 2, H, W)``; ``resample2d_multi``
warps one image by F flows ``(B, F, 2, H, W)`` into ``(B, F, C, H, W)``.

Local rows: the bilinear K=1 functions take a flow of ``Ho <= H`` rows and
an integer row offset ``off``; output row ``r`` then samples at
``y = (r + off) + dy``, clamped against the image's ``H`` (the local-rows
form of the Pallas kernels, which the height-split composition in
``ops/resample2d_spatial.py`` runs per row band).  The offset joins the
integer row index before the flow is added, so the result is bit-equal to
rows ``[off, off + Ho)`` of the whole-image call; ``Ho == H, off == 0`` is
that call.

The bilinear K=1 warp is differentiable in two ways, which agree:

- the generic op (``resample2d``, ``resample2d_multi``): forward K2,
  backward K4, which recomputes the corners and forms the analytic flow
  gradient, as the reference CUDA backward does;
- the tangent route (``resample2d_tangents``): forward K3, which also
  writes d1 = d out/d dx and d2 = d out/d dy per channel, so the backward
  is the elementwise ``d_flow = (sum_c g*d1, sum_c g*d2)``.

The image gradient, a scatter-add of the four taps, is plain PyTorch on
any device (the JAX package leaves it to an XLA scatter), computed only
when the image needs a gradient, which no model's warp does.  Nearest and
K > 1 are differentiated by autograd through the plain version, on the CPU.

bfloat16, as the JAX package's Pallas kernels compute it: the image, the
flow and the cotangent are upcast, the coordinates, weights and sums are
float32, and each result is rounded once: the warp to the image's dtype,
the flow gradient to the flow's; K3's tangents d1, d2 stay float32, and
the tangent route's backward sums ``g * d1`` in float32 and rounds once.

A CPU tensor takes the plain PyTorch versions.  A CUDA tensor launches the
kernels (bilinear, K=1; float32, or a bfloat16 image, flow and cotangent,
over the whole image or its local rows) or raises; no tensor is cast to
run a kernel of another type.  With
``sharding_hints.spatial_shards() > 1`` the three differentiable entry
points run as row bands (``ops/resample2d_spatial.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, sharding_hints

_MAX_GRID_Y = 65535


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """img[b, :, yi[b, h, w], xi[b, h, w]] -> (B, C, Ho, Wo)."""
    batch, channels, _, width = img.shape
    idx = (yi * width + xi).reshape(batch, 1, -1).expand(batch, channels, -1)
    return img.reshape(batch, channels, -1).gather(2, idx).reshape(
        batch, channels, *yi.shape[1:])


def _coords(flow: torch.Tensor, off: int = 0):
    """Source coordinates (xf, yf), each (B, Ho, Wo) float32, of output
    rows ``off .. off + Ho``."""
    _, _, out_h, out_w = flow.shape
    ys = torch.arange(off, off + out_h, dtype=torch.float32,
                      device=flow.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=flow.device)
    return (xs.view(1, 1, -1) + flow[:, 0].float(),
            ys.view(1, -1, 1) + flow[:, 1].float())


def _sample_point(flow: torch.Tensor, height: int, width: int, off: int = 0):
    """Bilinear weights a, b (B, 1, Ho, Wo) and the clamped corner indices
    x_l, x_r, y_t, y_b (B, Ho, Wo)."""
    xf, yf = _coords(flow, off)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    return ((xf - x0).unsqueeze(1), (yf - y0).unsqueeze(1),
            x0.clamp(0, width - 1).long(), (x0 + 1).clamp(0, width - 1).long(),
            y0.clamp(0, height - 1).long(),
            (y0 + 1).clamp(0, height - 1).long())


def _corners(img: torch.Tensor, flow: torch.Tensor, off: int = 0):
    """a, b and the four corner values iTL, iTR, iBL, iBR (B, C, Ho, Wo)."""
    a, b, x_l, x_r, y_t, y_b = _sample_point(flow, *img.shape[2:], off)
    return (a.to(img.dtype), b.to(img.dtype), _gather(img, y_t, x_l),
            _gather(img, y_t, x_r), _gather(img, y_b, x_l),
            _gather(img, y_b, x_r))


def _bilinear_plain(img, flow, kernel_size, off=0):
    _, _, height, width = img.shape
    a, b, x_l, x_r, y_t, y_b = _sample_point(flow, height, width, off)
    a, b = a.to(img.dtype), b.to(img.dtype)
    out = torch.zeros(img.shape[:2] + flow.shape[2:], dtype=img.dtype,
                      device=img.device)
    for fy in range(kernel_size):
        for fx in range(kernel_size):
            yts = (y_t + fy).clamp_max(height - 1)
            ybs = (y_b + fy).clamp_max(height - 1)
            xls = (x_l + fx).clamp_max(width - 1)
            xrs = (x_r + fx).clamp_max(width - 1)
            out = out + (1 - a) * (1 - b) * _gather(img, yts, xls)
            out = out + a * (1 - b) * _gather(img, yts, xrs)
            out = out + (1 - a) * b * _gather(img, ybs, xls)
            out = out + a * b * _gather(img, ybs, xrs)
    return out


def _nearest_plain(img, flow):
    _, _, height, width = img.shape
    xf, yf = _coords(flow)
    xn = torch.floor(xf + 0.5).clamp(0, width - 1).long()
    yn = torch.floor(yf + 0.5).clamp(0, height - 1).long()
    return _gather(img, yn, xn)


def _per_flow(base: str, nflows: int) -> str:
    """Counter name of a warp over ``nflows`` flows: one, or several."""
    return base if nflows == 1 else f"{base}_multi"


def resample2d_plain(img: torch.Tensor, flow: torch.Tensor,
                     kernel_size: int = 1, bilinear: bool = True,
                     off: int = 0) -> torch.Tensor:
    """The plain PyTorch warp; any device, any K, bilinear or nearest
    (``off``: bilinear only).  A bfloat16 image and flow are upcast, warped
    in float32 and rounded once, as the kernel and the JAX package do."""
    _cuda.PLAIN_CALLS["resample2d"] += 1
    if bilinear:
        return _bilinear_plain(_cuda.widened(img), flow, kernel_size,
                               off).to(img.dtype)
    if off:
        raise NotImplementedError("the nearest warp has no local-rows form")
    return _nearest_plain(img, flow)


def resample2d_multi_plain(img: torch.Tensor, flows: torch.Tensor,
                           off: int = 0) -> torch.Tensor:
    """The plain PyTorch F-flow bilinear warp: (B, F, C, Ho, W), bfloat16
    as ``resample2d_plain``."""
    _cuda.PLAIN_CALLS["resample2d_multi"] += 1
    wide = _cuda.widened(img)
    return torch.stack([_bilinear_plain(wide, flows[:, f], 1, off)
                        for f in range(flows.shape[1])], dim=1).to(img.dtype)


def resample2d_tangents_plain(img: torch.Tensor, flows: torch.Tensor,
                              off: int = 0):
    """The plain version of K3: the bilinear warp of one image (B, C, H, W)
    by F flows (B, F, 2, Ho, W) and its flow tangents d1 = d out/d dx,
    d2 = d out/d dy, as ``(out, d1, d2)``, each (B, F, C, Ho, W): ``out``
    in the image's dtype, d1 and d2 in float32 (the TPU kernel's)."""
    _cuda.PLAIN_CALLS[_per_flow("resample2d_tangents", flows.shape[1])] += 1
    wide = _cuda.widened(img)
    outs, d1s, d2s = [], [], []
    for f in range(flows.shape[1]):
        a, b, i_tl, i_tr, i_bl, i_br = _corners(wide, flows[:, f], off)
        outs.append((1 - a) * (1 - b) * i_tl + a * (1 - b) * i_tr
                    + (1 - a) * b * i_bl + a * b * i_br)
        d1s.append((1 - b) * (i_tr - i_tl) + b * (i_br - i_bl))
        d2s.append((1 - a) * (i_bl - i_tl) + a * (i_br - i_tr))
    return (torch.stack(outs, dim=1).to(img.dtype), torch.stack(d1s, dim=1),
            torch.stack(d2s, dim=1))


def resample2d_grad_flow_plain(g: torch.Tensor, img: torch.Tensor,
                               flows: torch.Tensor,
                               off: int = 0) -> torch.Tensor:
    """The plain version of K4: the flow gradient (B, F, 2, Ho, W) of the
    bilinear warp of ``img`` by ``flows`` for the cotangent ``g``
    (B, F, C, Ho, W), in the flows' dtype (bfloat16: summed in float32 and
    rounded once)."""
    _cuda.PLAIN_CALLS[_per_flow("resample2d_grad_flow", flows.shape[1])] += 1
    g, wide = _cuda.widened(g), _cuda.widened(img)
    d_flows = []
    for f in range(flows.shape[1]):
        a, b, i_tl, i_tr, i_bl, i_br = _corners(wide, flows[:, f], off)
        gf = g[:, f]
        d_flows.append(torch.stack([
            torch.sum(gf * ((1 - b) * (i_tr - i_tl) + b * (i_br - i_bl)), 1),
            torch.sum(gf * ((1 - a) * (i_bl - i_tl) + a * (i_br - i_tr)), 1),
        ], dim=1))
    return torch.stack(d_flows, dim=1).to(flows.dtype)


def _d_img(g: torch.Tensor, img: torch.Tensor, flows: torch.Tensor,
           off: int = 0) -> torch.Tensor:
    """The image gradient of the bilinear warp: each flow's cotangent
    (B, F, C, Ho, W) scattered back onto its four taps in the full-height
    image, plain PyTorch on any device (the reference's and the JAX
    package's scatter-add; bfloat16 summed in float32, rounded once)."""
    batch, channels, height, width = img.shape
    g = _cuda.widened(g)
    d_img = torch.zeros_like(img, dtype=g.dtype).reshape(batch, channels, -1)
    for f in range(flows.shape[1]):
        a, b, x_l, x_r, y_t, y_b = _sample_point(flows[:, f], height, width,
                                                 off)
        gf = g[:, f].reshape(batch, channels, -1)
        a, b = a.reshape(batch, 1, -1), b.reshape(batch, 1, -1)
        for yi, xi, w in ((y_t, x_l, (1 - a) * (1 - b)),
                          (y_t, x_r, a * (1 - b)),
                          (y_b, x_l, (1 - a) * b), (y_b, x_r, a * b)):
            idx = (yi * width + xi).reshape(batch, 1, -1).expand_as(gf)
            d_img.scatter_add_(2, idx, w * gf)
    return d_img.reshape(img.shape).to(img.dtype)


def _check_warp(name: str, img: torch.Tensor, flows: torch.Tensor, off: int,
                dtypes: tuple = (torch.float32,)):
    """The device, the kernels' integer arguments (B, F, C, H, W, Ho, off)
    and the output shape (B, F, C, Ho, W) of a warp of ``img`` (B, C, H, W)
    by ``flows`` (B, F, 2, Ho, W) whose rows are image rows
    ``[off, off + Ho)``; the image and the flows of one of ``dtypes``, both
    of the same."""
    device = img.device
    _cuda.check_operand(name, "img", img, 4, device, dtypes)
    _cuda.check_operand(name, "flows", flows, 5, device, dtypes)
    if flows.dtype != img.dtype:
        raise TypeError(f"{name}: img is {img.dtype} and flows "
                        f"{flows.dtype}")
    batch, channels, height, width = img.shape
    nflows, out_h = flows.shape[1], flows.shape[3]
    if flows.shape != (batch, nflows, 2, out_h, width):
        raise ValueError(f"{name}: flows {tuple(flows.shape)} do not match "
                         f"img {tuple(img.shape)}")
    if int(off) != off or off < 0 or off + out_h > height:
        raise ValueError(f"{name}: rows [{off}, {off} + {out_h}) are not "
                         f"rows of an image of height {height}")
    if batch * nflows > _MAX_GRID_Y:
        raise ValueError(f"{name}: B*F = {batch * nflows} exceeds "
                         f"{_MAX_GRID_Y}")
    return (device,
            (batch, nflows, channels, height, width, out_h, int(off)),
            (batch, nflows, channels, out_h, width))


# The tensors each entry point of ``csrc/<lib>.cu`` takes; B, F, C, H, W,
# Ho, off, the device index and the stream follow.  The argument types and
# the ``extern "C"`` signatures change together: ctypes checks neither.
_POINTERS = {"resample2d_fwd": 3, "resample2d_tangents": 5,
             "resample2d_grad_flow": 4}
# lib -> the entry points it defines, with the same arguments
_ENTRY_POINTS = {lib: (lib, f"{lib}_bf16") for lib in _POINTERS}


def _argtypes(lib: str) -> list:
    return ([ctypes.c_void_p] * _POINTERS[lib] + [ctypes.c_int] * 8
            + [ctypes.c_void_p])


def _launch(lib: str, name: str, pointers, dims, device,
            entry: str) -> None:
    """Run the C entry point ``entry`` of ``csrc/<lib>.cu`` on ``pointers``
    (tensors) and ``dims`` (B, F, C, H, W, Ho, off) on the current stream,
    and count the launch under ``name``."""
    if len(pointers) != _POINTERS[lib]:
        raise TypeError(f"{lib} takes {_POINTERS[lib]} tensors, got "
                        f"{len(pointers)}")
    fn = _cuda.function(lib, entry, _argtypes(lib))
    err = fn(*(t.data_ptr() for t in pointers), *dims, device.index,
             _cuda.stream_ptr(device))
    _cuda.LAUNCHES[name] += 1
    _cuda.check(lib, name, err)


def _check_cuda_warp(lib: str, name: str, img: torch.Tensor,
                     flows: torch.Tensor, off: int):
    """``_check_warp`` for the entry points of ``csrc/<lib>.cu``: float32,
    or a bfloat16 image and bfloat16 flows (entry point ``<lib>_bf16``),
    over the whole image or its local rows.  Returns the device, the dims,
    the output shape, the entry point and the counter name
    (``<name>_bf16`` for bfloat16)."""
    device, dims, shape = _check_warp(name, img, flows, off,
                                      (torch.float32, torch.bfloat16))
    suffix = "_bf16" if img.dtype == torch.bfloat16 else ""
    return device, dims, shape, lib + suffix, name + suffix


def _fwd_cuda(name: str, img: torch.Tensor, flows: torch.Tensor, off: int):
    """Run K2 (csrc/resample2d_fwd.cu) over flows (B, F, 2, Ho, W): float32,
    or a bfloat16 image and bfloat16 flows (entry point
    ``resample2d_fwd_bf16``, counted under ``<name>_bf16``)."""
    device, dims, shape, entry, name = _check_cuda_warp(
        "resample2d_fwd", name, img, flows, off)
    out = torch.empty(shape, dtype=img.dtype, device=device)
    if out.numel():
        _launch("resample2d_fwd", name, (img, flows, out), dims, device,
                entry)
    return out


def resample2d_cuda(img: torch.Tensor, flow: torch.Tensor,
                    kernel_size: int = 1, bilinear: bool = True,
                    off: int = 0) -> torch.Tensor:
    """The CUDA warp of one flow (K2); bilinear K=1, float32 or a
    bfloat16 image and flow."""
    if kernel_size != 1 or not bilinear:
        raise NotImplementedError(
            "resample2d on CUDA: the kernel covers bilinear, kernel_size=1 "
            f"(got kernel_size={kernel_size}, bilinear={bilinear})")
    return _fwd_cuda("resample2d_fwd", img, flow.unsqueeze(1), off).squeeze(1)


def resample2d_multi_cuda(img: torch.Tensor, flows: torch.Tensor,
                          off: int = 0) -> torch.Tensor:
    """The CUDA warp of F flows over one image, in one launch (K2)."""
    return _fwd_cuda("resample2d_fwd_multi", img, flows, off)


def resample2d_tangents_cuda(img: torch.Tensor, flows: torch.Tensor,
                             off: int = 0):
    """K3: the warp of one image by F flows (B, F, 2, Ho, W) and its flow
    tangents, ``(out, d1, d2)`` each (B, F, C, Ho, W), in one launch;
    ``out`` in the image's dtype, d1 and d2 float32 (a bfloat16 image and
    flows: entry point ``resample2d_tangents_bf16``)."""
    device, dims, shape, entry, name = _check_cuda_warp(
        "resample2d_tangents", _per_flow("resample2d_tangents",
                                         flows.shape[1]), img, flows, off)
    outs = (torch.empty(shape, dtype=img.dtype, device=device),
            *(torch.empty(shape, dtype=torch.float32, device=device)
              for _ in range(2)))
    if outs[0].numel():
        _launch("resample2d_tangents", name, (img, flows, *outs), dims,
                device, entry)
    return outs


def resample2d_grad_flow_cuda(g: torch.Tensor, img: torch.Tensor,
                              flows: torch.Tensor,
                              off: int = 0) -> torch.Tensor:
    """K4: the flow gradient (B, F, 2, Ho, W) of the warp of ``img`` by
    ``flows`` for the cotangent ``g`` (B, F, C, Ho, W), in one launch, in
    the flows' dtype (a bfloat16 image, flows and g: entry point
    ``resample2d_grad_flow_bf16``)."""
    device, dims, shape, entry, name = _check_cuda_warp(
        "resample2d_grad_flow", _per_flow("resample2d_grad_flow",
                                          flows.shape[1]), img, flows, off)
    _cuda.check_operand(name, "g", g, 5, device, (img.dtype,))
    if g.shape != shape:
        raise ValueError(f"{name}: g {tuple(g.shape)} is not {shape}")
    d_flows = torch.empty_like(flows)
    if d_flows.numel():
        _launch("resample2d_grad_flow", name, (g, img, flows, d_flows), dims,
                device, entry)
    return d_flows


class _Warp(torch.autograd.Function):
    """The generic bilinear K=1 warp of F flows over the image rows
    ``[off, off + Ho)``: forward K2, backward K4 recomputing the corners
    (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, img, flows, off):
        ctx.save_for_backward(img, flows)
        ctx.off = off
        single = flows.shape[1] == 1
        if _cuda.on_cpu(img):
            if single:
                return resample2d_plain(img, flows[:, 0],
                                        off=off).unsqueeze(1)
            return resample2d_multi_plain(img, flows, off)
        if single:
            return resample2d_cuda(img, flows[:, 0], off=off).unsqueeze(1)
        return resample2d_multi_cuda(img, flows, off)

    @staticmethod
    def backward(ctx, g):
        img, flows = ctx.saved_tensors
        g = g.contiguous()
        d_img = (_d_img(g, img, flows, ctx.off)
                 if ctx.needs_input_grad[0] else None)
        d_flows = None
        if ctx.needs_input_grad[1]:
            grad_flow = (resample2d_grad_flow_plain if _cuda.on_cpu(img)
                         else resample2d_grad_flow_cuda)
            d_flows = grad_flow(g, img, flows, ctx.off)
        return d_img, d_flows, None


class _WarpTangents(torch.autograd.Function):
    """The tangent route of the bilinear K=1 warp of F flows over the image
    rows ``[off, off + Ho)``: forward K3, which saves d1 and d2, and the
    elementwise backward."""

    @staticmethod
    def forward(ctx, img, flows, off):
        tangents = (resample2d_tangents_plain if _cuda.on_cpu(img)
                    else resample2d_tangents_cuda)
        out, d1, d2 = tangents(img, flows, off)
        ctx.save_for_backward(img, flows, d1, d2)
        ctx.off = off
        return out

    @staticmethod
    def backward(ctx, g):
        img, flows, d1, d2 = ctx.saved_tensors
        d_img = (_d_img(g, img, flows, ctx.off)
                 if ctx.needs_input_grad[0] else None)
        d_flows = None
        if ctx.needs_input_grad[1]:
            # float32 tangents: a bfloat16 cotangent is upcast, the sums
            # are float32 and the gradient is rounded once to the flows'
            # dtype, as the JAX package's _resample2d_bwd does
            gf = g.float()
            d_flows = torch.stack([torch.sum(gf * d1, dim=2),
                                   torch.sum(gf * d2, dim=2)],
                                  dim=2).to(flows.dtype)
        return d_img, d_flows, None


def _warp(img: torch.Tensor, flows: torch.Tensor,
          tangents: bool) -> torch.Tensor:
    """The differentiable bilinear K=1 warp of F flows, by the generic or
    the tangent route: as row bands where ``sharding_hints`` asks for them
    and the composition takes the shapes, else over the whole image."""
    if sharding_hints.spatial_shards() > 1:
        from .resample2d_spatial import spatial_wrapper

        out = spatial_wrapper(img, flows, tangents)
        if out is not None:
            return out
    sharding_hints.record_dispatch(
        "resample2d", "whole image, kernel="
        + ("plain" if _cuda.on_cpu(img) else "cuda"))
    return (_WarpTangents if tangents else _Warp).apply(img, flows, 0)


def resample2d(img: torch.Tensor, flow: torch.Tensor, kernel_size: int = 1,
               bilinear: bool = True) -> torch.Tensor:
    """Backward-warp ``img`` (B, C, H, W) by ``flow`` (B, 2, H, W)."""
    if bilinear and kernel_size == 1:
        return _warp(img, flow.unsqueeze(1), False).squeeze(1)
    if _cuda.on_cpu(img):
        return resample2d_plain(img, flow, kernel_size, bilinear)
    return resample2d_cuda(img, flow, kernel_size, bilinear)


def resample2d_multi(img: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """Bilinear warps of one image (B, C, H, W) by F flows (B, F, 2, H, W)
    -> (B, F, C, H, W)."""
    return _warp(img, flows, False)


def resample2d_tangents(img: torch.Tensor,
                        flows: torch.Tensor) -> torch.Tensor:
    """``resample2d_multi`` differentiated by the tangent route."""
    return _warp(img, flows, True)
