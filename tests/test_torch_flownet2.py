"""FlowNet2 through the port, end to end on the CPU, against the JAX package.

One JAX ``PRNGKey(0)`` init at 64x128 feeds both packages (carried across by
``from_jax_variables``); the port's weights then go back through the JAX
package's own importer, and into the port's ``load_checkpoint`` and
``run_a_pair`` entry point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flownet2_tpu.checkpoints.torch_import import (assert_tree_matches,
                                                    load_torch_checkpoint)
from flownet2_tpu.models import FlowNet2 as JaxFlowNet2

from flownet2_tpu_torch import ops, run_a_pair
from flownet2_tpu_torch.checkpoints import from_jax_variables, load_checkpoint
from flownet2_tpu_torch.data import read_flo
from flownet2_tpu_torch.models import FlowNet2

H, W = 64, 128
# The cascade amplifies summation-order noise through the warps and the
# correlation; tests/test_parity_torch.py holds the JAX package to the
# torch reference at the same tolerance.
TOL = 1e-3


def _pair(seed):
    return np.random.RandomState(seed).rand(1, 2, H, W, 3).astype(
        np.float32) * 255.0


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxFlowNet2()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 2, H, W, 3)))
    return jax.tree_util.tree_map(np.asarray, variables), jax.jit(jm.apply)


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = FlowNet2().eval()
    model.load_state_dict(from_jax_variables(jax_model[0], "FlowNet2"),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def checkpoint(port_model, tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "FlowNet2_checkpoint.pth.tar"
    torch.save({"arch": "FlowNet2", "epoch": 0,
                "state_dict": port_model.state_dict(), "best_EPE": 1.5}, path)
    return path


def _assert_flow_close(got, want):
    diff = np.abs(got - want).max()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                               err_msg=f"max abs diff {diff:.3e}")


def test_flownet2_matches_jax(jax_model, port_model):
    variables, apply = jax_model
    x = _pair(11)
    want = np.asarray(apply(variables, jnp.asarray(x)))
    ops.reset_counts()
    with torch.inference_mode():
        got = port_model(torch.from_numpy(x)).numpy()
    assert dict(ops.PLAIN_CALLS) == {"correlation": 1, "resample2d": 2,
                                     "resample2d_multi": 1}
    assert sum(ops.LAUNCHES.values()) == 0
    assert got.shape == want.shape == (1, H, W, 2)
    _assert_flow_close(got, want)


def test_port_keys_load_through_jax_importer(jax_model, checkpoint):
    """The port's state_dict keys are the reference's: the JAX package's
    importer takes them, into the tree FlowNet2().init expects, and gives
    back the very weights they came from."""
    variables, meta = load_torch_checkpoint(checkpoint)
    assert meta == {"arch": "FlowNet2", "epoch": 0, "best_EPE": 1.5}
    expected = jax.eval_shape(JaxFlowNet2().init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, H, W, 3)))
    assert_tree_matches(variables, expected)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    want = dict(jax.tree_util.tree_leaves_with_path(jax_model[0]))
    for path, leaf in leaves:
        np.testing.assert_array_equal(leaf, want[path])


def test_load_checkpoint_into_port(port_model, checkpoint):
    fresh = FlowNet2()
    meta = load_checkpoint(checkpoint, fresh)
    assert meta == {"arch": "FlowNet2", "epoch": 0, "best_EPE": 1.5}
    for (k, a), (k2, b) in zip(fresh.state_dict().items(),
                               port_model.state_dict().items()):
        assert k == k2
        assert torch.equal(a, b), k


def test_run_a_pair_on_cpu(jax_model, checkpoint, tmp_path):
    """The entry point crops to /64, runs on the CPU when asked, and writes
    the flow that the JAX package computes for the cropped pair."""
    rng = np.random.RandomState(12)
    frames = rng.randint(0, 256, (2, H + 6, W + 9, 3)).astype(np.uint8)
    paths = []
    for i, frame in enumerate(frames):
        paths.append(str(tmp_path / f"frame{i}.png"))
        Image.fromarray(frame).save(paths[-1])
    out = tmp_path / "flow.flo"
    run_a_pair.main([*paths, "--checkpoint", str(checkpoint), "--out",
                     str(out), "--viz", str(tmp_path / "flow.png"),
                     "--device", "cpu"])
    got = read_flo(out)
    crop = frames[:, 3:3 + H, 4:4 + W].astype(np.float32)[None]
    variables, apply = jax_model
    want = np.asarray(apply(variables, jnp.asarray(crop)))[0]
    _assert_flow_close(got, want)
    assert (tmp_path / "flow.png").exists()
