"""Frame reading by extension: the port's copy of
flownet2_tpu/data/frame_io.py.  Images go through the native decoders
(``flownet2_tpu_torch.native``) where they are available, else through
PIL; both give the same pixels.

png/jpg/jpeg/ppm -> (H, W, 3) uint8 RGB (alpha dropped, grey expanded);
.flo -> float32 flow; .bin/.raw -> ``np.load``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from .flow_io import read_flo

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".ppm"}


def read_gen(file_name: str | pathlib.Path) -> np.ndarray:
    ext = os.path.splitext(str(file_name))[-1].lower()
    if ext in _IMG_EXTS:
        from .. import native
        if native.available():
            return native.read_image(file_name)
        from PIL import Image
        with Image.open(str(file_name)) as im:
            arr = np.asarray(im)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr[:, :, :3]
    if ext in (".bin", ".raw"):
        return np.load(str(file_name))
    if ext == ".flo":
        return read_flo(file_name)
    raise ValueError(f"unsupported extension {ext!r} for {file_name}")
