"""The row-band (height-split) setting of the model's ops.

Counterpart of flownet2_tpu/ops/sharding_hints.py and of the mesh
registration in flownet2_tpu/parallel/mesh.py.  The JAX package shards the
image height over a mesh's ``spatial`` axis; its correlation and warp then
run as halo compositions over the shards (ops/correlation_spatial.py,
ops/resample2d_spatial.py) and GSPMD gives every convolution its halo.  The
port has two forms of it.

On one process, one process-global number of row bands, default 1: with
``S > 1`` the dispatchers of ``ops.correlation`` and ``ops.resample2d`` cut
their work into ``S`` bands of ``H / S`` rows, all on the caller's device,
run in turn.  The gather of the halo rows is then the identity and its
transpose a sum; the rest of the model runs on the whole map.

Across processes, a band context (``scoped_band(Band(group, size, index,
edges))``, which ``parallel.DataParallelPlan.band_context(height)``
enters): each process holds band ``index`` of ``size`` bands of the
height, rows ``edges[index]``, and every op of the model works on its band.
The edges fall on granules of 64 rows, FlowNet2's total stride
(``band_edges``): band i takes ceil(G / S) or floor(G / S) of the G = H / 64
granules, the larger bands first, as GSPMD gives the first shards the
extra row; so every level of the model, down to conv6 at 1/64, holds whole
rows on every band, and each band's share of the rows is the same at every
level.  The convolutions and the bilinear upsample fetch their halo rows
from the neighbouring bands, the correlation gathers f2 and the warp its
image over ``group`` (``parallel/halo.py``), and the input normalisation
averages its mean over the bands.  The band context wins over the
one-process number.

Each dispatcher records which composition it took (``dispatch_log``), and a
one-process composition that declines (a height ``S`` does not divide) says
so once on stderr and leaves the op to its whole-map kernel.  A band context
never declines: a height that breaks its rule raises (``band_edges``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Optional

# FlowNet2's total stride: conv6 is at 1/64 of the frame
TOTAL_STRIDE = 64

_SPATIAL_SHARDS = 1

# the band this process holds, or None
_BAND = None

# one stderr line per distinct reason
_WARNED_REASONS: set = set()

# the latest dispatch decision per op name
_DISPATCH_LOG: dict = {}


def set_spatial_shards(n: int) -> None:
    """Split the correlation and the warp into ``n`` row bands (1: whole)."""
    global _SPATIAL_SHARDS
    if int(n) != n or n < 1:
        raise ValueError(f"spatial shards must be a positive integer, got {n}")
    _SPATIAL_SHARDS = int(n)


def spatial_shards() -> int:
    return _SPATIAL_SHARDS


@contextlib.contextmanager
def scoped_spatial_shards(n: int):
    """``set_spatial_shards(n)`` that restores the previous number on exit."""
    prev = _SPATIAL_SHARDS
    set_spatial_shards(n)
    try:
        yield
    finally:
        set_spatial_shards(prev)


@dataclasses.dataclass(frozen=True)
class Band:
    """This process's band: ``index`` of ``size`` bands of the height,
    exchanged with the other bands over the process group ``group``, whose
    rank ``i`` holds band ``i``.  ``edges`` are every band's ``(start,
    stop)`` rows of the frame (``band_edges``)."""
    group: Any
    size: int
    index: int
    edges: tuple

    def spans(self, rows: int) -> list:
        """Every band's ``(start, stop)`` rows at the level of the model
        where this band holds ``rows`` rows: the frame's edges scaled by
        that level's stride."""
        start, stop = self.edges[self.index]
        scale, ragged = divmod(stop - start, rows)
        if ragged or any(a % scale or b % scale for a, b in self.edges):
            raise ValueError(f"band {self.index} of the edges {self.edges} "
                             f"holds {rows} rows: not a level of the frame")
        return [(a // scale, b // scale) for a, b in self.edges]

    def share(self) -> float:
        """This band's share of the rows, the same at every level."""
        start, stop = self.edges[self.index]
        return (stop - start) / self.edges[-1][1]


def band() -> Optional[Band]:
    """The band context in force, or None."""
    return _BAND


@contextlib.contextmanager
def scoped_band(b: Optional[Band]):
    """Run the model's ops on band ``b`` (None: the whole map) until the
    block ends."""
    global _BAND
    prev = _BAND
    _BAND = b
    try:
        yield b
    finally:
        _BAND = prev


def band_edges(height: int, size: int) -> tuple:
    """Every band's ``(start, stop)`` rows of a frame ``height`` rows high
    cut in ``size`` bands on granules of 64 rows, FlowNet2's total stride:
    of the G = height / 64 granules band i takes ceil(G / size) or
    floor(G / size), the larger bands first (384 over 4: 128, 128, 64, 64
    rows; 448 over 2: 256, 192).  Every level down to conv6 then holds
    whole rows on every band and every stride-2 layer, deconvolution and
    pooling window starts at a band's edge.  Raises ``ValueError`` unless
    the height is a multiple of 64 that holds at least ``size`` granules."""
    if size < 1 or height % TOTAL_STRIDE or height // TOTAL_STRIDE < size:
        raise ValueError(
            f"a height of {height} rows over {size} row bands: the bands "
            f"are cut on granules of {TOTAL_STRIDE} rows, FlowNet2's total "
            f"stride, so H must be a multiple of {TOTAL_STRIDE} with at "
            f"least one granule a band (H / {TOTAL_STRIDE} >= {size}; "
            "thinner bands are not ported)")
    more, extra = divmod(height // TOTAL_STRIDE, size)
    edges, start = [], 0
    for i in range(size):
        stop = start + (more + (i < extra)) * TOTAL_STRIDE
        edges.append((start, stop))
        start = stop
    return tuple(edges)


def _warn_fallback(reason: str) -> None:
    if reason in _WARNED_REASONS:
        return
    _WARNED_REASONS.add(reason)
    print(f"flownet2_tpu_torch: row-band composition declined ({reason}); "
          "the op runs its whole-map kernel", file=sys.stderr)


def record_dispatch(op: str, mode: str) -> None:
    _DISPATCH_LOG[op] = mode


def dispatch_log() -> dict:
    return dict(_DISPATCH_LOG)


def clear_dispatch_log() -> None:
    _DISPATCH_LOG.clear()
