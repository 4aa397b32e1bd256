"""Middlebury ``.flo`` I/O and flow visualisation: the port's copy of
flownet2_tpu/data/flow_io.py.  ``read_flo`` and ``write_flo`` go through
the native decoders (``flownet2_tpu_torch.native``) where they are
available, else through numpy; both give the same bytes and arrays.

The .flo format is the magic 202021.25, little-endian int32 W and H, then
H*W*2 float32 (dx, dy); the colour wheel is the reference's HSV rendering.
"""

from __future__ import annotations

import pathlib

import numpy as np

TAG_FLOAT = 202021.25


def read_flo(path: str | pathlib.Path) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32 (dx, dy)."""
    from .. import native
    if native.available():
        return native.read_flo(path)
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != np.float32(TAG_FLOAT):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
        if data.size != h * w * 2:
            raise ValueError(f"{path}: truncated .flo ({data.size} floats "
                             f"for {h}x{w})")
        return data.reshape(h, w, 2).copy()


def write_flo(path: str | pathlib.Path, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as Middlebury .flo."""
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    from .. import native
    if native.available():
        return native.write_flo(path, flow)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(TAG_FLOAT).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.astype(np.float32).tobytes())


def make_color_wheel() -> np.ndarray:
    """55-entry RGB colour wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalised flow (u, v) to RGB via the colour wheel."""
    h, w = u.shape
    img = np.zeros((h, w, 3), np.uint8)
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = np.where(k0 + 1 == ncols + 1, 1, k0 + 1)
    f = fk - k0
    for i in range(3):
        col0 = wheel[k0 - 1, i] / 255.0
        col1 = wheel[k1 - 1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col = np.where(idx, 1 - rad * (1 - col), col * 0.75)
        img[:, :, i] = np.uint8(np.floor(255 * col * (1 - nan_idx)))
    return img


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """Render (H, W, 2) flow as an RGB uint8 image."""
    u, v = flow[:, :, 0].astype(np.float64), flow[:, :, 1].astype(np.float64)
    unknown_thresh = 1e7
    idx_unknown = (np.abs(u) > unknown_thresh) | (np.abs(v) > unknown_thresh)
    u = np.where(idx_unknown, 0, u)
    v = np.where(idx_unknown, 0, v)

    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(-1.0, float(rad.max()) if rad.size else -1.0)
    eps = np.finfo(float).eps
    img = compute_color(u / (maxrad + eps), v / (maxrad + eps))
    img[idx_unknown] = 0
    return img
