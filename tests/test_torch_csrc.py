"""The launch interface of the port's CUDA kernels, as far as a CPU can see
it: every ``extern "C"`` entry point of ``flownet2_tpu_torch/csrc/*.cu``
takes the arguments, in number and kind, that its Python wrapper declares to
ctypes.  ctypes checks nothing against the C signatures, so a kernel change
that moves an argument would otherwise show only on the card."""

import ctypes
import os
import pathlib
import re
import subprocess
import sys
from unittest import mock

import pytest
import torch

from flownet2_tpu_torch.ops import _cuda
from flownet2_tpu_torch.ops import correlation as corr
from flownet2_tpu_torch.ops import resample2d as r2d

# one torch thread per test process: several test workers share the cores
torch.set_num_threads(1)

CSRC = pathlib.Path(_cuda.CSRC)
ENTRY = re.compile(r'extern\s+"C"\s+([\w\s]+?[\s*]+)(\w+)\s*\(([^)]*)\)')

# entry point -> (source file stem, the argtypes its wrapper passes)
WRAPPED = {name: (lib, corr._ARGTYPES)
           for lib, names in corr._ENTRY_POINTS.items() for name in names}
WRAPPED.update({name: (lib, r2d._argtypes(lib))
                for lib, names in r2d._ENTRY_POINTS.items() for name in names})


def _kind(param: str) -> str:
    """'pointer' or 'int' for one C parameter declaration."""
    if "*" in param:
        return "pointer"
    words = param.replace("const", " ").split()
    assert words[:-1] == ["int"], f"unexpected parameter type: {param!r}"
    return "int"


def _declared(path: pathlib.Path) -> dict:
    """{entry point: (return type, [kind of each parameter])} of a source."""
    out = {}
    for ret, name, params in ENTRY.findall(path.read_text()):
        kinds = [_kind(p.strip()) for p in params.split(",") if p.strip()]
        out[name] = (" ".join(ret.split()), kinds)
    return out


def _ctypes_kind(argtype) -> str:
    return {ctypes.c_void_p: "pointer", ctypes.c_int: "int"}[argtype]


@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_entry_point_matches_its_wrappers_argtypes(name):
    lib, argtypes = WRAPPED[name]
    declared = _declared(CSRC / f"{lib}.cu")
    assert name in declared, f"csrc/{lib}.cu defines no {name}"
    ret, kinds = declared[name]
    assert ret == "int"
    assert kinds == [_ctypes_kind(a) for a in argtypes]
    # the tensors lead, the device index and the stream close the list
    assert kinds[-2:] == ["int", "pointer"]
    assert "pointer" not in kinds[kinds.index("int"):-1]


def test_error_string_matches_its_binding():
    # bound in _cuda._library: one int in, a C string out
    ret, kinds = _declared(CSRC / "common.cuh")["fnet_error_string"]
    assert (ret, kinds) == ("const char*", ["int"])


def test_every_source_has_a_wrapped_entry_point_and_none_is_unbound():
    sources = sorted(CSRC.glob("*.cu"))
    defined = {}
    for path in sources:
        names = set(_declared(path))
        assert names, f"{path.name} defines no extern \"C\" entry point"
        assert names & set(WRAPPED), f"no wrapper names one of {names}"
        for name in names:
            defined[name] = path.stem
    # every entry point is bound by a wrapper, to the source that defines it
    assert defined == {name: lib for name, (lib, _) in WRAPPED.items()}


def test_build_directory_follows_the_environment(tmp_path, monkeypatch):
    """FLOWNET2_TORCH_BUILD_DIR moves the build; unset or empty, the build
    stays in the default directory.  nvcc is not here, so it is stood in
    for by a compiler that writes each requested library."""
    monkeypatch.delenv(_cuda.BUILD_DIR_ENV, raising=False)
    assert _cuda.build_root() == _cuda.DEFAULT_BUILD_ROOT
    monkeypatch.setenv(_cuda.BUILD_DIR_ENV, "")
    assert _cuda.build_root() == _cuda.DEFAULT_BUILD_ROOT
    root = tmp_path / "kernels"
    monkeypatch.setenv(_cuda.BUILD_DIR_ENV, str(root))
    assert _cuda.build_root() == root

    def fake_nvcc(cmd, **kwargs):
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return mock.Mock(returncode=0, communicate=lambda: ("built", None))

    with mock.patch.object(_cuda, "_nvcc", return_value="nvcc"), \
            mock.patch.object(_cuda.subprocess, "Popen", fake_nvcc):
        logs = _cuda.build()
        assert set(logs) == {p.stem for p in CSRC.glob("*.cu")}
        assert set(logs.values()) == {"built"}
        built = sorted(p.name for p in (root / _cuda.source_hash()).iterdir())
        assert built == sorted(f"lib{p.stem}.so" for p in CSRC.glob("*.cu"))
        # a second build finds them and compiles nothing
        assert set(_cuda.build().values()) == {""}


def test_importing_the_port_builds_nothing(tmp_path):
    """Every module of the port imports without creating the build
    directory: kernels are built at their first CUDA call only."""
    root = tmp_path / "kernels"
    env = dict(os.environ, **{_cuda.BUILD_DIR_ENV: str(root)})
    code = ("import flownet2_tpu_torch, flownet2_tpu_torch.models, "
            "flownet2_tpu_torch.ops.correlation_spatial, "
            "flownet2_tpu_torch.ops.resample2d_spatial, "
            "flownet2_tpu_torch.train")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=pathlib.Path(__file__).resolve().parents[1],
                   timeout=300)
    assert not root.exists()
