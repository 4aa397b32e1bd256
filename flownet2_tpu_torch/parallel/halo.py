"""Differentiable collectives over a spatial process group: the row bands'
halo exchange, gather and mean (the counterparts of what GSPMD inserts for
an H-sharded convolution and of ``jax.lax.all_gather`` / ``psum_scatter``
over the ``spatial`` mesh axis).

Every function takes the caller's ``band`` (``ops.sharding_hints.Band``:
the group, the number of bands, this process's index, rank ``i`` of the
group holding band ``i``, and every band's edges) and works on NCHW
tensors whose rows (axis 2) are this band's.  The bands may differ in
height (``sharding_hints.band_edges``): each function reads every band's
rows at its level off ``band.spans``.  Each is a
``torch.autograd.Function`` that makes one collective call in its forward
and one in its backward, on every rank of the group alike, so the ranks
issue them in one order.  They use only ``all_gather`` and
``all_reduce``: a reduce-scatter is an all-reduce and a slice, an
all-gather of bands of unequal height pads each band to the tallest and
cuts the padding off again, and where gloo holds CUDA tensors, whose
all-gather it does not take, an all-gather is an all-reduce of the bands'
pieces, each in its own slot of a zeroed buffer (a sum with zeros, exact).
bfloat16 takes the same collectives (gloo adds bf16 tensors, on the CPU and
on CUDA).

- ``halo_rows(x, top, bottom, band)``: ``x`` with the ``top`` rows of the
  band above and the ``bottom`` rows of the band below around it, zero rows
  beyond the image's top and bottom; the backward sends each halo's
  gradient home and adds it there.
- ``gather_rows(x, band)``: every band, concatenated along the height (the
  whole map); the backward is the reduce-scatter of the map's gradient.
- ``mean_over_bands(x, band)``: the bands' ``x`` weighted by their shares
  of the rows and summed, the whole frame's mean where ``x`` is the mean
  over a band's rows; the backward gives each band its share of the summed
  gradient.

The sums of the backward passes run in a fixed order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_by_all_reduce(t: torch.Tensor, group) -> bool:
    """Whether to all-gather ``t`` by an all-reduce: gloo takes no
    all-gather of CUDA tensors."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_list(t: torch.Tensor, n: int, index: int, group) -> list:
    """Every rank's ``t`` (the same shape on each), in the order of the
    ranks of ``group`` (None: the default group), of which this process is
    rank ``index`` of ``n``."""
    t = t.contiguous()
    if _gather_by_all_reduce(t, group):
        slots = t.new_zeros((n,) + t.shape)
        slots[index] = t
        dist.all_reduce(slots, group=group)
        return list(slots.unbind(0))
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return parts


def _all_gather(t: torch.Tensor, band) -> list:
    return all_gather_list(t, band.size, band.index, band.group)


def gather_band_rows(x: torch.Tensor, band, dim: int = 2) -> list:
    """Every band's ``x``, whose axis ``dim`` holds this band's rows, in
    band order: each band padded to the tallest band's rows for the
    all-gather and cut to its own rows after it."""
    spans = band.spans(x.shape[dim])
    tallest = max(b - a for a, b in spans)
    pad = tallest - x.shape[dim]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,)
                                      + x.shape[dim + 1:])], dim=dim)
    return [part.narrow(dim, 0, b - a)
            for part, (a, b) in zip(_all_gather(x, band), spans)]


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, band):
        height = x.shape[2]
        if top > height or bottom > height:
            raise ValueError(f"halo of {top} and {bottom} rows around a band "
                             f"of {height}: at most one band's rows")
        ctx.config = (top, bottom, band)
        # what the neighbours take: the first `bottom` rows go to the band
        # above, the last `top` rows to the band below
        parts = _all_gather(torch.cat([x[:, :, :bottom],
                                       x[:, :, height - top:]], dim=2), band)

        def zeros(rows):
            return x.new_zeros(x.shape[:2] + (rows,) + x.shape[3:])

        above = (parts[band.index - 1][:, :, bottom:] if band.index > 0
                 else zeros(top))
        below = (parts[band.index + 1][:, :, :bottom]
                 if band.index < band.size - 1 else zeros(bottom))
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        top, bottom, band = ctx.config
        height = g.shape[2] - top - bottom
        # the halos' gradients go back to the bands whose rows they were
        parts = _all_gather(torch.cat([g[:, :, :top], g[:, :, top + height:]],
                                      dim=2), band)
        d_x = g[:, :, top:top + height].clone()
        if band.index > 0:     # the band above held my first rows below it
            d_x[:, :, :bottom] += parts[band.index - 1][:, :, top:]
        if band.index < band.size - 1:  # the band below, my last rows
            d_x[:, :, height - top:] += parts[band.index + 1][:, :, :top]
        return d_x, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, band) -> torch.Tensor:
    """``x`` (N, C, h, W), band ``band.index``, with ``top`` rows of the
    band above and ``bottom`` rows of the band below: (N, C, top + h +
    bottom, W), zero rows beyond the image's top and bottom edges."""
    if top == bottom == 0:
        return x
    return _HaloRows.apply(x, top, bottom, band)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, band):
        ctx.band = band
        ctx.rows = band.spans(x.shape[2])[band.index]
        return torch.cat(gather_band_rows(x, band), dim=2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # reduce-scatter: the whole map's gradient summed over the bands,
        # then this band's rows
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.band.group)
        start, stop = ctx.rows
        return g[:, :, start:stop].contiguous(), None


def gather_rows(x: torch.Tensor, band) -> torch.Tensor:
    """Every band's ``x`` (N, C, h, W) in band order along the height: the
    whole map (N, C, H, W), the same on every rank."""
    return _GatherRows.apply(x, band)


class _MeanOverBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, band):
        ctx.band = band
        out = (x * band.share()).contiguous()
        dist.all_reduce(out, group=band.group)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.band.group)
        return g.mul_(ctx.band.share()), None


def mean_over_bands(x: torch.Tensor, band) -> torch.Tensor:
    """Every band's ``x`` (any shape) weighted by the band's share of the
    rows and summed, the same on every rank: where ``x`` is a mean over
    each band's rows, the whole frame's mean."""
    return _MeanOverBands.apply(x, band)
