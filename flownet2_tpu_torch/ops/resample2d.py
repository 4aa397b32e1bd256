"""Flow warping (backward resampling), forward only.

Counterpart of flownet2_tpu/ops/resample2d.py (the plain form) and of the
Pallas forward kernel in flownet2_tpu/ops/resample2d_pallas.py (the CUDA
kernel ``csrc/resample2d_fwd.cu``).  Semantics of the reference's
Resample2d op:

    xf = x + flow[:, 0], yf = y + flow[:, 1]      (channel 0 is dx)
    bilinear: corners floor/floor+1 clamped to the image, weights not
      renormalised at the border; with kernel_size K each corner read is
      summed over a KxK window of taps that reuse the unshifted weights.
    nearest: index floor(xf + 0.5), clamped.

Layout: image ``(B, C, H, W)``, flow ``(B, 2, H, W)``; ``resample2d_multi``
warps one image by F flows ``(B, F, 2, H, W)`` into ``(B, F, C, H, W)``.

A CPU tensor takes the plain PyTorch version.  A CUDA tensor launches the
kernel (bilinear, K=1, float32) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_MAX_GRID_Y = 65535


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """img[b, :, yi[b, h, w], xi[b, h, w]] -> (B, C, Ho, Wo)."""
    batch, channels, _, width = img.shape
    idx = (yi * width + xi).reshape(batch, 1, -1).expand(batch, channels, -1)
    return img.reshape(batch, channels, -1).gather(2, idx).reshape(
        batch, channels, *yi.shape[1:])


def _coords(flow: torch.Tensor):
    """Source coordinates (xf, yf), each (B, Ho, Wo) float32."""
    _, _, out_h, out_w = flow.shape
    ys = torch.arange(out_h, dtype=torch.float32, device=flow.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=flow.device)
    return (xs.view(1, 1, -1) + flow[:, 0].float(),
            ys.view(1, -1, 1) + flow[:, 1].float())


def _bilinear_plain(img, flow, kernel_size):
    _, _, height, width = img.shape
    xf, yf = _coords(flow)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    a = (xf - x0).unsqueeze(1).to(img.dtype)
    b = (yf - y0).unsqueeze(1).to(img.dtype)
    x_l = x0.clamp(0, width - 1).long()
    x_r = (x0 + 1).clamp(0, width - 1).long()
    y_t = y0.clamp(0, height - 1).long()
    y_b = (y0 + 1).clamp(0, height - 1).long()

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


def resample2d_plain(img: torch.Tensor, flow: torch.Tensor,
                     kernel_size: int = 1,
                     bilinear: bool = True) -> torch.Tensor:
    """The plain PyTorch warp; any device, any K, bilinear or nearest."""
    _cuda.PLAIN_CALLS["resample2d"] += 1
    if bilinear:
        return _bilinear_plain(img, flow, kernel_size)
    return _nearest_plain(img, flow)


def resample2d_multi_plain(img: torch.Tensor,
                           flows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch F-flow bilinear warp: (B, F, C, H, W)."""
    _cuda.PLAIN_CALLS["resample2d_multi"] += 1
    return torch.stack([_bilinear_plain(img, flows[:, f], 1)
                        for f in range(flows.shape[1])], dim=1)


def _launch(name: str, img: torch.Tensor, flows: torch.Tensor):
    """Run csrc/resample2d_fwd.cu over flows (B, F, 2, H, W)."""
    _cuda.reject_grad(name, img, flows)
    device = img.device
    _cuda.check_operand(name, "img", img, 4, device)
    _cuda.check_operand(name, "flows", flows, 5, device)
    batch, channels, height, width = img.shape
    nflows = flows.shape[1]
    if flows.shape != (batch, nflows, 2, height, width):
        raise ValueError(f"{name}: flows {tuple(flows.shape)} do not match "
                         f"img {tuple(img.shape)}")
    if batch * nflows > _MAX_GRID_Y:
        raise ValueError(f"{name}: B*F = {batch * nflows} exceeds "
                         f"{_MAX_GRID_Y}")
    out = torch.empty((batch, nflows, channels, height, width),
                      dtype=img.dtype, device=device)
    if out.numel() == 0:
        return out
    fn = _cuda.function("resample2d_fwd", "resample2d_fwd", _ARGTYPES)
    err = fn(img.data_ptr(), flows.data_ptr(), out.data_ptr(), batch, nflows,
             channels, height, width, device.index, _cuda.stream_ptr(device))
    _cuda.LAUNCHES[name] += 1
    _cuda.check("resample2d_fwd", name, err)
    return out


def resample2d_cuda(img: torch.Tensor, flow: torch.Tensor,
                    kernel_size: int = 1,
                    bilinear: bool = True) -> torch.Tensor:
    """The CUDA warp of one flow; bilinear K=1 float32 only."""
    if kernel_size != 1 or not bilinear:
        raise NotImplementedError(
            "resample2d on CUDA: the kernel covers bilinear, kernel_size=1 "
            f"(got kernel_size={kernel_size}, bilinear={bilinear})")
    return _launch("resample2d_fwd", img, flow.unsqueeze(1)).squeeze(1)


def resample2d_multi_cuda(img: torch.Tensor,
                          flows: torch.Tensor) -> torch.Tensor:
    """The CUDA warp of F flows over one image, in one launch."""
    return _launch("resample2d_fwd_multi", img, flows)


def resample2d(img: torch.Tensor, flow: torch.Tensor, kernel_size: int = 1,
               bilinear: bool = True) -> torch.Tensor:
    """Backward-warp ``img`` (B, C, H, W) by ``flow`` (B, 2, H, W)."""
    if img.device.type == "cpu":
        return resample2d_plain(img, flow, kernel_size, bilinear)
    return resample2d_cuda(img, flow, kernel_size, bilinear)


def resample2d_multi(img: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """Bilinear warps of one image (B, C, H, W) by F flows (B, F, 2, H, W)
    -> (B, F, C, H, W)."""
    if img.device.type == "cpu":
        return resample2d_multi_plain(img, flows)
    return resample2d_multi_cuda(img, flows)
