"""The row-band (height-split) setting of the correlation and the warp.

Counterpart of flownet2_tpu/ops/sharding_hints.py and of the mesh
registration in flownet2_tpu/parallel/mesh.py.  The JAX package shards the
image height over a mesh's ``spatial`` axis; its correlation and warp then
run as halo compositions over the shards (ops/correlation_spatial.py,
ops/resample2d_spatial.py).  The port keeps one process-global number of
row bands, default 1: with ``S > 1`` the dispatchers of ``ops.correlation``
and ``ops.resample2d`` cut their work into ``S`` bands of ``H / S`` rows,
all on the caller's device, run in turn.  The gather of the halo rows is
then the identity and its transpose a sum; the collectives between cards
come with multi-GPU.

Each dispatcher records which composition it took (``dispatch_log``), and a
composition that declines (a height ``S`` does not divide) says so once on
stderr and leaves the op to its whole-map kernel.
"""

from __future__ import annotations

import contextlib
import sys

_SPATIAL_SHARDS = 1

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
