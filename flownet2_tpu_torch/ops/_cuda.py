"""Build and bind the port's CUDA kernels.

Every ``csrc/<name>.cu`` is a kernel with a plain C interface.  At the
first CUDA call, ``nvcc`` compiles each source into its own shared library
under ``<build root>/<source hash>/`` (all compilers started together), and
the library is loaded with ``ctypes``.  The build root is the directory
that the environment variable ``FLOWNET2_TORCH_BUILD_DIR`` names, read at
each build, or else ``build/flownet2_tpu_torch/`` beside the package
(inside a checkout, the repository's ``build/``).  Importing the package
builds nothing.  The hash covers the
sources, the headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises:
there is no fallback.

Each C entry point takes raw pointers, sizes, the device index and the
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``check`` raises if it is not 0.

``LAUNCHES`` counts the kernel launches of each wrapper and
``PLAIN_CALLS`` the calls of each plain PyTorch version, so that a run can
show which path it took; ``reset_counts`` sets both to zero.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR_ENV = "FLOWNET2_TORCH_BUILD_DIR"
DEFAULT_BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
                      / "flownet2_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_root() -> Path:
    """Where the libraries are built: ``$FLOWNET2_TORCH_BUILD_DIR`` if it is
    set and not empty, else ``DEFAULT_BUILD_ROOT``."""
    return Path(os.environ.get(BUILD_DIR_ENV) or DEFAULT_BUILD_ROOT)


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot be "
                           "built")
    return nvcc


def build() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that is not yet built for this source
    hash, one ``nvcc`` per source, all running at once.  Returns each
    source's compiler output ("" for a library already built); raises if
    any compile fails, after every compiler has exited."""
    out_dir = build_root() / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    logs = {}
    for src in _sources():
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            logs[src.stem] = ""
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, lib, proc in jobs:
        logs[src.stem], _ = proc.communicate()
        if proc.returncode:
            failures.append(f"{src.name} (exit {proc.returncode}):\n"
                            f"{logs[src.stem]}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return logs


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            build()
            lib = ctypes.CDLL(str(build_root() / source_hash()
                                  / f"lib{name}.so"))
            lib.fnet_error_string.argtypes = [ctypes.c_int]
            lib.fnet_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def function(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``, built and
    loaded on first use, with its argument types declared."""
    key = (lib_name, fn_name)
    if key not in _fns:
        fn = getattr(_library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check(lib_name: str, what: str, err: int) -> None:
    if err:
        msg = _library(lib_name).fnet_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def on_cpu(t: torch.Tensor) -> bool:
    """Whether an op takes its plain version for ``t``: only for a tensor
    on the CPU.  Any other tensor goes to the CUDA wrapper, which launches
    its kernel or raises."""
    return t.device.type == "cpu"


def widened(t: torch.Tensor) -> torch.Tensor:
    """``t`` as float32 if it is bfloat16, else ``t`` itself: a plain
    version computes a bfloat16 op in float32 and rounds once at the end,
    as the bfloat16 kernels do."""
    return t.float() if t.dtype == torch.bfloat16 else t


def check_operand(op: str, name: str, t: torch.Tensor, ndim: int,
                  device: torch.device,
                  dtypes: tuple = (torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D CUDA tensor on
    ``device`` of one of ``dtypes``, the element types the entry point
    ``op`` has kernels for.  A tensor of another type is never cast: it
    raises ``TypeError``."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{op}: {name} is on {t.device}, expected the CUDA "
                         f"device {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{op}: {name} must be "
                        f"{' or '.join(str(d) for d in dtypes)}, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{op}: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
