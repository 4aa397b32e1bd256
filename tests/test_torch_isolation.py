"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points want the CUDA device unless told otherwise, and its copies of
the JAX package's numpy helpers agree with the originals."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flownet2_tpu.data import flow_io as jax_flow_io

import flownet2_tpu_torch
from flownet2_tpu_torch.data import flow_to_image, read_flo, write_flo
from flownet2_tpu_torch.models import get_model, normalize_pair

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "flownet2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "flownet2_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_module_pulls_in_no_jax():
    script = (
        "import pkgutil, sys\n"
        "import flownet2_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: __import__(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(names), bad, ' '.join(names))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20, proc.stdout
    for module in ("sharding_hints", "correlation_spatial",
                   "resample2d_spatial"):
        assert f"flownet2_tpu_torch.ops.{module}" in proc.stdout.split()


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "kernel_ab.py",
                                 "step_ab.py")]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", None))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert len(files) > 20
    assert not bad, bad


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_entry_points_default_to_cuda_and_refuse_without_it():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("FlowNet2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flownet2_tpu_torch.resolve_device(None)


def test_entry_points_take_the_cpu_when_asked_and_reject_unknown_models():
    with pytest.raises(KeyError, match="available"):
        get_model("FlowNet2X", device="cpu")
    assert flownet2_tpu_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("shape", [(1, 2, 64, 96, 3), (1, 2, 70, 128, 3),
                                   (1, 64, 128, 3), (1, 3, 64, 128, 3)])
def test_normalize_pair_rejects_bad_shapes(shape):
    with pytest.raises(ValueError):
        normalize_pair(torch.zeros(shape), 255.0)


def test_flow_io_copies_match_the_jax_package(tmp_path):
    flow = (np.random.RandomState(0).randn(24, 40, 2) * 5).astype(np.float32)
    flow[0, 0] = 1e9   # unknown-flow marker
    write_flo(tmp_path / "port.flo", flow)
    jax_flow_io.write_flo(tmp_path / "jax.flo", flow)
    assert ((tmp_path / "port.flo").read_bytes()
            == (tmp_path / "jax.flo").read_bytes())
    np.testing.assert_array_equal(read_flo(tmp_path / "jax.flo"), flow)
    np.testing.assert_array_equal(flow_to_image(flow),
                                  jax_flow_io.flow_to_image(flow))
