"""The height-split correlation: row bands against halo slabs of f2.

Counterpart of flownet2_tpu/ops/correlation_spatial.py (the halo-slab
composition) and of the Pallas row-slab kernels ``correlation_pallas_rows``
and ``correlation_pallas_bwd_rows`` (K7: the entry points
``correlation_fwd_rows`` of ``csrc/correlation_fwd.cu`` and
``correlation_bwd_f1_rows``, ``correlation_bwd_f2_rows`` of
``csrc/correlation_bwd.cu``, and their ``_bf16`` and ``_fp16`` forms for
bfloat16 and float16 operands, which sum the exact products in float32
and round once: at maxd 20, s2 2 on the tensor-core bodies of K1, K5 and
K6 in either dtype; any other configuration on the general bodies).

Output rows ``[off, off + Hloc)`` of the cost volume read f2 rows
``[off - maxd, off + Hloc + maxd)``, zero beyond the map: a halo bounded
by ``max_displacement``, so a fixed slab is exact.  The local op

    corr_slab(f1_loc (B, C, Hloc, W), slab (B, C, Hloc + 2*maxd, W))
      out[b, d, y, x] = 1/C sum_c f1_loc[b, c, y, x]
                                 * slab[b, c, y + maxd + tj*s2, x + ti*s2]

(columns outside ``[0, W)`` read zero, the slab is not padded in H again)
is a ``torch.autograd.Function`` whose gradient comes back as ``d_f1``
(B, C, Hloc, W) and ``d_slab`` in slab coordinates:

    d_slab[b, c, ys, x2] = 1/C sum_d g[b, d, ys - maxd - tj*s2, x2 - ti*s2]
                                   * f1_loc[b, c, ys - maxd - tj*s2, x2 - ti*s2]

with source rows outside ``[0, Hloc)`` contributing zero.

The composition pads f2 by maxd rows once, gives band ``s`` the rows
``[s*Hloc, s*Hloc + Hloc + 2*maxd)`` of it as its slab and concatenates
the bands' outputs.  In the JAX package every shard gathers f2 over the
mesh; here all bands live on one device, so the gather is the identity and
its transpose, which sums the bands' slab gradients into the padded array
and crops it, is autograd of the slicing and the pad.  The forward and
d_f1 are bit-equal to the whole-map op (the same sums in the same order);
d_f2 differs by the one extra add per halo row.

Across processes (a band context, ``sharding_hints.scoped_band``) each rank
holds one band of f1 and of f2, as the JAX package's shards do (the bands
may differ in height; the band's edges give its offset):
``band_wrapper`` gathers f2 over the band's group (``parallel.gather_rows``),
pads it by maxd rows, cuts this band's slab and runs ``corr_slab`` on the
local rows (JAX ``correlation_spatial.py`` ``spatial_wrapper``'s body).
Its backward is K7's d_f1, local, and d_slab, whose transpose goes home
through the gather's reduce-scatter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda, sharding_hints
from .correlation import _MAX_GRID_YZ, _check_config, _launch


def corr_slab_plain(f1: torch.Tensor, slab: torch.Tensor,
                    max_displacement: int = 20,
                    stride2: int = 2) -> torch.Tensor:
    """The plain PyTorch local op, on any device: the shifts form of
    ``correlation_plain`` in slab coordinates.  bfloat16 and float16
    operands are upcast, multiplied and summed in float32, and the output
    is rounded once to f1's dtype, as ``correlation_plain`` and the kernel
    do."""
    _cuda.PLAIN_CALLS["corr_slab"] += 1
    dtype = f1.dtype
    f1, slab = _cuda.widened(f1), _cuda.widened(slab)
    channels, height, width = f1.shape[1:]
    maxd = max_displacement
    d_rad = maxd // stride2
    slabp = F.pad(slab, (maxd, maxd))
    outs = []
    for tj in range(-d_rad, d_rad + 1):
        for ti in range(-d_rad, d_rad + 1):
            oy, ox = maxd + tj * stride2, maxd + ti * stride2
            w2 = slabp[:, :, oy:oy + height, ox:ox + width]
            outs.append((0.0 + torch.sum(f1 * w2, dim=1)) / channels)
    return torch.stack(outs, dim=1).to(dtype)


def corr_slab_bwd_plain(g: torch.Tensor, f1: torch.Tensor,
                        slab: torch.Tensor, max_displacement: int = 20,
                        stride2: int = 2, needs=(True, True)):
    """(d_f1, d_slab) of ``corr_slab`` for the cotangent ``g``
    (B, D*D, Hloc, W), on any device; an input whose entry in ``needs`` is
    False gets None.  The D*D-step loop of the JAX package's
    ``_corr_slab_bwd``, accumulating in place.  bfloat16 and float16 g,
    f1 and slab are upcast, summed in float32, divided by C and rounded
    once to f1's dtype, as ``correlation_bwd_plain`` and the kernels
    do."""
    _cuda.PLAIN_CALLS["corr_slab_bwd"] += 1
    dtype = f1.dtype
    g, f1, slab = (_cuda.widened(t) for t in (g, f1, slab))
    channels, height, width = f1.shape[1:]
    slab_h = slab.shape[2]
    maxd = max_displacement
    d_rad = maxd // stride2
    disp = 2 * d_rad + 1
    need_f1, need_slab = needs
    d_f1 = torch.zeros_like(f1) if need_f1 else None
    d_slab = torch.zeros_like(slab) if need_slab else None
    slabp = F.pad(slab, (maxd, maxd)) if need_f1 else None
    # g and f1 padded by 2*maxd rows (slab coordinates span [-maxd,
    # Hloc + maxd) around the local rows) and maxd columns, so every
    # reverse shift is a plain slice and out-of-range sources read zero
    pad = (maxd, maxd, 2 * maxd, 2 * maxd)
    gp = F.pad(g, pad) if need_slab else None
    f1p = F.pad(f1, pad) if need_slab else None
    for tj in range(-d_rad, d_rad + 1):
        for ti in range(-d_rad, d_rad + 1):
            d = (tj + d_rad) * disp + (ti + d_rad)
            if need_f1:
                oy, ox = maxd + tj * stride2, maxd + ti * stride2
                d_f1.addcmul_(g[:, d:d + 1],
                              slabp[:, :, oy:oy + height, ox:ox + width])
            if need_slab:
                oy, ox = maxd - tj * stride2, maxd - ti * stride2
                d_slab.addcmul_(
                    gp[:, d:d + 1, oy:oy + slab_h, ox:ox + width],
                    f1p[:, :, oy:oy + slab_h, ox:ox + width])
    return (None if d_f1 is None else (d_f1 / channels).to(dtype),
            None if d_slab is None else (d_slab / channels).to(dtype))


_DTYPES = tuple(_cuda.KERNEL_DTYPES)


def _check_slab(name, f1, slab, max_displacement, stride2):
    _check_config(name, max_displacement, 1, max_displacement, 1, stride2)
    device = f1.device
    _cuda.check_operand(name, "f1", f1, 4, device, _DTYPES)
    _cuda.check_operand(name, "slab", slab, 4, device, _DTYPES)
    if slab.dtype != f1.dtype:
        raise TypeError(f"{name}: f1 is {f1.dtype} and slab {slab.dtype}")
    batch, channels, height, width = f1.shape
    slab_h = height + 2 * max_displacement
    if slab.shape != (batch, channels, slab_h, width):
        raise ValueError(f"{name}: slab {tuple(slab.shape)} is not f1 "
                         f"{tuple(f1.shape)} with {slab_h} rows")
    # the d_slab grid has a block row per slab row
    if batch > _MAX_GRID_YZ or slab_h > _MAX_GRID_YZ:
        raise ValueError(f"{name}: B and Hloc + 2*maxd must be <= "
                         f"{_MAX_GRID_YZ}")
    return device


def corr_slab_cuda(f1: torch.Tensor, slab: torch.Tensor,
                   max_displacement: int = 20,
                   stride2: int = 2) -> torch.Tensor:
    """K7 forward, any width: ``correlation_fwd_rows`` on float32, or
    ``correlation_fwd_rows_bf16`` (``_fp16``) on bfloat16 (float16) f1 and
    slab with an output of their dtype."""
    name = "correlation_fwd_rows" + _cuda.suffix(f1.dtype)
    device = _check_slab(name, f1, slab, max_displacement, stride2)
    batch, _, height, width = f1.shape
    disp = 2 * (max_displacement // stride2) + 1
    out = torch.empty((batch, disp * disp, height, width), dtype=f1.dtype,
                      device=device)
    if out.numel():
        _launch("correlation_fwd", name, (f1, slab, out), f1,
                max_displacement, stride2)
    return out


def corr_slab_bwd_cuda(g: torch.Tensor, f1: torch.Tensor, slab: torch.Tensor,
                       max_displacement: int = 20, stride2: int = 2,
                       needs=(True, True)):
    """K7 backward, any width: d_f1 by ``correlation_bwd_f1_rows`` and
    d_slab by ``correlation_bwd_f2_rows``, each launched only where
    ``needs`` asks; float32, or bfloat16 or float16 g, f1 and slab with
    gradients of their dtype (the entry points' ``_bf16`` and ``_fp16``
    forms)."""
    device = _check_slab("correlation_bwd_rows", f1, slab, max_displacement,
                         stride2)
    batch, _, height, width = f1.shape
    disp = 2 * (max_displacement // stride2) + 1
    _cuda.check_operand("correlation_bwd_rows", "g", g, 4, device, _DTYPES)
    if g.dtype != f1.dtype:
        raise TypeError(f"correlation_bwd_rows: g is {g.dtype} and f1 "
                        f"{f1.dtype}")
    if g.shape != (batch, disp * disp, height, width):
        raise ValueError(f"correlation_bwd_rows: g {tuple(g.shape)} does not "
                         f"match f1 {tuple(f1.shape)} and D*D = "
                         f"{disp * disp}")
    grads = []
    for name, src, like, need in (
            ("correlation_bwd_f1_rows", slab, f1, needs[0]),
            ("correlation_bwd_f2_rows", f1, slab, needs[1])):
        if not need:
            grads.append(None)
            continue
        out = torch.empty_like(like)
        if out.numel():
            _launch("correlation_bwd", name + _cuda.suffix(f1.dtype),
                    (g, src, out), f1, max_displacement, stride2)
        grads.append(out)
    return tuple(grads)


class _CorrSlab(torch.autograd.Function):
    """The local rows-against-slab cost volume: K7 forward and backward on
    CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, f1, slab, max_displacement, stride2):
        ctx.save_for_backward(f1, slab)
        ctx.config = (max_displacement, stride2)
        fwd = corr_slab_plain if _cuda.on_cpu(f1) else corr_slab_cuda
        return fwd(f1, slab, max_displacement, stride2)

    @staticmethod
    def backward(ctx, g):
        f1, slab = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:2])
        bwd = corr_slab_bwd_plain if _cuda.on_cpu(f1) else corr_slab_bwd_cuda
        d_f1, d_slab = bwd(g.contiguous(), f1, slab, *ctx.config, needs=needs)
        return d_f1, d_slab, None, None


def corr_slab(f1: torch.Tensor, slab: torch.Tensor, max_displacement: int = 20,
              stride2: int = 2) -> torch.Tensor:
    """Cost volume (B, D*D, Hloc, W) of one band ``f1`` (B, C, Hloc, W)
    against its halo slab (B, C, Hloc + 2*maxd, W), differentiable in
    both."""
    return _CorrSlab.apply(f1, slab, max_displacement, stride2)


def band_wrapper(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int,
                 stride2: int, band) -> torch.Tensor:
    """The K 1, s1 1, pad == maxd cost volume of this process's band of
    ``f1`` and ``f2`` (B, C, Hloc, W): band ``band.index`` of the whole
    map's, against a slab of the f2 gathered over ``band.group``."""
    from ..parallel.halo import gather_rows

    if max_displacement % stride2 or f1.shape != f2.shape:
        raise ValueError(f"correlation on row bands: max_displacement "
                         f"{max_displacement} over stride2 {stride2}, f1 "
                         f"{tuple(f1.shape)}, f2 {tuple(f2.shape)}")
    maxd, local_h = max_displacement, f1.shape[2]
    off = band.spans(local_h)[band.index][0]
    sharding_hints.record_dispatch(
        "correlation", f"process group(spatial={band.size})+halo-slab, "
        "kernel=" + ("plain" if _cuda.on_cpu(f1) else "cuda-rows"))
    f2p = F.pad(gather_rows(f2, band), (0, 0, maxd, maxd))
    return corr_slab(f1.contiguous(),
                     f2p[:, :, off:off + local_h + 2 * maxd].contiguous(),
                     maxd, stride2)


def spatial_wrapper(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int,
                    stride2: int):
    """The K 1, s1 1, pad == maxd cost volume of ``f1`` and ``f2``
    (B, C, H, W) as ``spatial_shards()`` row bands, or None where the
    composition does not apply: one band, a displacement the stride does
    not divide, differing shapes, or a height the number of bands does not
    divide (said once on stderr)."""
    shards = sharding_hints.spatial_shards()
    if shards <= 1:
        return None
    if max_displacement % stride2 or f1.shape != f2.shape:
        return None
    height = f1.shape[2]
    if height % shards:
        sharding_hints._warn_fallback(
            f"correlation height {height} ragged on spatial={shards}")
        return None
    local_h = height // shards
    maxd = max_displacement
    sharding_hints.record_dispatch(
        "correlation", f"bands(spatial={shards})+halo-slab, kernel="
        + ("plain" if _cuda.on_cpu(f1) else "cuda-rows"))
    f2p = F.pad(f2, (0, 0, maxd, maxd))
    bands = [corr_slab(f1[:, :, off:off + local_h].contiguous(),
                       f2p[:, :, off:off + local_h + 2 * maxd].contiguous(),
                       maxd, stride2)
             for off in range(0, height, local_h)]
    return torch.cat(bands, dim=2)
