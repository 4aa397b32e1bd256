"""Native (C++) decoders of the data path: the port's copy of
flownet2_tpu/native, bound with ctypes.

``src/fileio.cc`` decodes PNG (libpng), JPEG (libjpeg), PPM/PGM and
Middlebury ``.flo`` files, and decodes, crops and converts a whole batch to
float32 with a thread pool of its own in one call (``batch_load``).  The
decoding runs outside the interpreter lock.

At first use ``g++`` builds the source into the port's build root (the
directory that ``FLOWNET2_TORCH_BUILD_DIR`` names, else the checkout's
``build/flownet2_tpu_torch/``, as ``ops._cuda.build_root`` says), under a
name keyed by the hash of the source and the command: the compiler writes a
file named after its process, which ``os.replace`` then moves into place.
Processes that find the library missing at once (the ranks of a
data-parallel run) take the build root's lock (``ops._cuda.dir_lock``) in
turn: the first compiles, the others find it built.  Nothing is written
into the package.  Importing the module builds nothing.

This is a host decoder, not a device kernel: where the build or the load
fails, or ``FLOWNET2_TORCH_NO_NATIVE`` is set, ``available()`` is False,
``build_error()`` says why, and the data path (``data.flow_io``,
``data.frame_io``, ``data.loader``) reads with numpy and PIL instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops._cuda import build_root, dir_lock

SRC = Path(__file__).resolve().parent / "src" / "fileio.cc"
NO_NATIVE_ENV = "FLOWNET2_TORCH_NO_NATIVE"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lpng", "-ljpeg", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None


def _command(out: Path) -> list[str]:
    return [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SRC), "-o",
            str(out), *LINK_FLAGS]


def library_path() -> Path:
    """Where the library is (or will be) built: the build root, under a
    name keyed by the source and the compile command."""
    h = hashlib.sha256(" ".join(_command(Path("-"))).encode())
    h.update(SRC.read_bytes())
    return build_root() / f"libfileio_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    """Compile to a file named after this process, then move it into
    place, holding the build root's lock (unless another process built it
    meanwhile); returns the reason of a failure, None on success."""
    with dir_lock(so.parent):
        return None if so.exists() else _compile(so)


def _compile(so: Path) -> Optional[str]:
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = _command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        return (proc.stderr.strip()
                or f"{cmd[0]} exited with {proc.returncode}")
    os.replace(tmp, so)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    f32_p = ctypes.POINTER(ctypes.c_float)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.f2t_image_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_int_p]
    lib.f2t_image_read_rgb.argtypes = [ctypes.c_char_p, u8_p, ctypes.c_int,
                                       ctypes.c_int]
    lib.f2t_flo_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
    lib.f2t_flo_read.argtypes = [ctypes.c_char_p, f32_p, ctypes.c_int,
                                 ctypes.c_int]
    lib.f2t_flo_write.argtypes = [ctypes.c_char_p, f32_p, ctypes.c_int,
                                  ctypes.c_int]
    lib.f2t_batch_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int, f32_p, c_int_p, c_int_p,
        ctypes.c_char_p, ctypes.c_int, f32_p, c_int_p, c_int_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    for name in ("f2t_image_info", "f2t_image_read_rgb", "f2t_flo_info",
                 "f2t_flo_read", "f2t_flo_write", "f2t_batch_load"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get(NO_NATIVE_ENV):
            _ERROR = f"switched off by {NO_NATIVE_ENV}"
            return None
        so = library_path()
        if not so.exists():
            reason = _build(so)
            if reason is not None:
                _ERROR = f"build failed: {reason}"
                warnings.warn(f"flownet2_tpu_torch.native: {_ERROR}; the data "
                              "path reads with numpy and PIL", RuntimeWarning)
                return None
        try:
            _LIB = _bind(ctypes.CDLL(str(so)))
        except OSError as e:
            _ERROR = f"load failed: {e}"
            warnings.warn(f"flownet2_tpu_torch.native: {_ERROR}",
                          RuntimeWarning)
        return _LIB


def available() -> bool:
    """Whether the native library is built and loaded (building it at the
    first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native library is not available (None where it is)."""
    _load()
    return _ERROR


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoders not available: {_ERROR}")
    return lib


def _check(rc: int, what: str, path) -> None:
    if rc == 0:
        return
    codes = {-1: "cannot open", -2: "bad format/magic", -3: "truncated",
             -4: "decoder init failed", -5: "shape mismatch"}
    msg = f"{what} {path!r}: {codes.get(rc, f'error {rc}')}"
    if rc in (-2, -5):  # malformed content: as the numpy readers raise
        raise ValueError(msg)
    raise IOError(msg)


def read_image(path) -> np.ndarray:
    """Decode PNG/JPEG/PPM/PGM to an (H, W, 3) uint8 RGB array."""
    lib = _lib()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    p = str(path).encode()
    _check(lib.f2t_image_info(p, ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(c)), "image", path)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.f2t_image_read_rgb(
        p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h.value, w.value), "image", path)
    return out


def read_flo(path) -> np.ndarray:
    """Read a Middlebury .flo file to (H, W, 2) float32."""
    lib = _lib()
    h = ctypes.c_int()
    w = ctypes.c_int()
    p = str(path).encode()
    _check(lib.f2t_flo_info(p, ctypes.byref(h), ctypes.byref(w)),
           ".flo", path)
    out = np.empty((h.value, w.value, 2), np.float32)
    _check(lib.f2t_flo_read(
        p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h.value, w.value), ".flo", path)
    return out


def write_flo(path, flow: np.ndarray) -> None:
    """Write (H, W, 2) flow as a Middlebury .flo file (float32)."""
    lib = _lib()
    flow = np.ascontiguousarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    _check(lib.f2t_flo_write(
        str(path).encode(),
        flow.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flow.shape[0], flow.shape[1]), ".flo", path)


def batch_load(img_paths: Sequence[str], img_offsets: np.ndarray,
               flo_paths: Sequence[str], flo_offsets: np.ndarray,
               crop_h: int, crop_w: int, flip_flow_vertical: bool = False,
               n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Parallel decode and crop of a batch.

    img_offsets/flo_offsets: (N, 2) int32 (oy, ox) crop origins per item
    (for flipped flows: in post-flip coordinates).
    Returns (imgs (n_img, ch, cw, 3) f32, flows (n_flo, ch, cw, 2) f32).
    """
    lib = _lib()
    n_img, n_flo = len(img_paths), len(flo_paths)
    imgs = np.empty((n_img, crop_h, crop_w, 3), np.float32)
    flows = np.empty((n_flo, crop_h, crop_w, 2), np.float32)
    ioff = np.ascontiguousarray(np.asarray(img_offsets, np.int32).reshape(-1, 2))
    foff = np.ascontiguousarray(np.asarray(flo_offsets, np.int32).reshape(-1, 2))
    if ioff.shape[0] != n_img or foff.shape[0] != n_flo:
        raise ValueError(f"{ioff.shape[0]} image and {foff.shape[0]} flow "
                         f"offsets for {n_img} images and {n_flo} flows")
    ipaths = b"".join(str(p).encode() + b"\0" for p in img_paths)
    fpaths = b"".join(str(p).encode() + b"\0" for p in flo_paths)
    if n_threads <= 0:
        n_threads = min(16, os.cpu_count() or 4)
    f32_p = ctypes.POINTER(ctypes.c_float)
    i32_p = ctypes.POINTER(ctypes.c_int)
    # the per-column copies stay referenced until the call returns
    ioy, iox = ioff[:, 0].copy(), ioff[:, 1].copy()
    foy, fox = foff[:, 0].copy(), foff[:, 1].copy()
    rc = lib.f2t_batch_load(
        ipaths, n_img, imgs.ctypes.data_as(f32_p),
        ioy.ctypes.data_as(i32_p), iox.ctypes.data_as(i32_p),
        fpaths, n_flo, flows.ctypes.data_as(f32_p),
        foy.ctypes.data_as(i32_p), fox.ctypes.data_as(i32_p),
        crop_h, crop_w, int(flip_flow_vertical), n_threads)
    _check(rc, "batch", f"{n_img} images + {n_flo} flows")
    return imgs, flows
