"""The height-split flow warp: row bands over a full-height image.

Counterpart of flownet2_tpu/ops/resample2d_spatial.py (the halo-gather
composition).  A warp cannot be cut into independent bands of the image:
the flow reaches across any band boundary and the op clamps at the edge of
the whole image.  So each band of ``H / S`` output rows samples the
full-height image (in the JAX package every shard gathers it; here all
bands live on one device, so the gather is the identity), through the
local-rows forms of the kernels: K2, or K3 on the tangent route, forward
and K4 backward, with the band's row offset joined to the integer row
index.  Each band's rows are therefore bit-equal to the same rows of the
whole-image call.

The flow gradient stays with its band.  The image gradient of a band is
the plain scatter-add of its taps into the full-height image, and autograd
sums the bands' images: the transpose of the gather.

Across processes (a band context, ``sharding_hints.scoped_band``) each rank
holds one band of the image and of the flows: ``band_wrapper`` gathers the
image over the band's group (``parallel.gather_rows``) and warps its own
flow rows at the band's offset through ``warp_rows``, one launch for the F
flows (JAX ``resample2d_spatial.py`` ``spatial_wrapper``'s body); the
image gradient goes home through the gather's reduce-scatter.
"""

from __future__ import annotations

import torch

from . import _cuda, sharding_hints
from .resample2d import _Warp, _WarpTangents


def warp_rows(img: torch.Tensor, flows_loc: torch.Tensor, off: int,
              tangents: bool = False) -> torch.Tensor:
    """Rows ``[off, off + Ho)`` of the bilinear K=1 warp of ``img``
    (B, C, H, W) by F flows given on those rows only, ``flows_loc``
    (B, F, 2, Ho, W) -> (B, F, C, Ho, W); differentiable in both, by the
    generic route (K2, K4) or the tangent route (K3)."""
    return (_WarpTangents if tangents else _Warp).apply(img, flows_loc, off)


def band_wrapper(img: torch.Tensor, flows: torch.Tensor, tangents: bool,
                 band) -> torch.Tensor:
    """The warp of this process's band of ``img`` (B, C, Hloc, W) by its
    band of ``flows`` (B, F, 2, Hloc, W): band ``band.index`` of the whole
    image's warp, over the image gathered over ``band.group``."""
    from ..parallel.halo import gather_rows

    if flows.shape[3] != img.shape[2]:
        raise ValueError(f"warp on row bands: image {tuple(img.shape)}, "
                         f"flows {tuple(flows.shape)}")
    sharding_hints.record_dispatch(
        "resample2d", f"process group(spatial={band.size})+halo-gather, "
        "kernel=" + ("plain" if _cuda.on_cpu(img) else "cuda-rows"))
    return warp_rows(gather_rows(img, band), flows.contiguous(),
                     band.index * img.shape[2], tangents)


def spatial_wrapper(img: torch.Tensor, flows: torch.Tensor,
                    tangents: bool = False):
    """The warp of ``img`` (B, C, H, W) by ``flows`` (B, F, 2, H, W) as
    ``spatial_shards()`` row bands, one launch per band for all F flows, or
    None where the composition does not apply (one band, or a height the
    number of bands does not divide, which is said once on stderr)."""
    shards = sharding_hints.spatial_shards()
    if shards <= 1:
        return None
    height = img.shape[2]
    if flows.shape[3] != height:
        return None
    if height % shards:
        sharding_hints._warn_fallback(
            f"warp height {height} ragged on spatial={shards}")
        return None
    local_h = height // shards
    sharding_hints.record_dispatch(
        "resample2d", f"bands(spatial={shards})+halo-gather, kernel="
        + ("plain" if _cuda.on_cpu(img) else "cuda-rows"))
    bands = [warp_rows(img, flows[:, :, :, off:off + local_h].contiguous(),
                       off, tangents)
             for off in range(0, height, local_h)]
    return torch.cat(bands, dim=3)
