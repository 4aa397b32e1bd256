"""The port's FlowNet2C, 2S, 2SD, 2CS and 2CSS wrappers against the JAX
package's, on the CPU, at 64x128.

Weights are made by the port (``get_model``, seeded), carried to the JAX
package by its own importer ``state_dict_to_variables`` and back into a
second port model by ``from_jax_variables``, which strips the sub-net
prefix the JAX package gives the single-net wrappers.  Inputs are seeded
numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu import models as jax_models
from flownet2_tpu.checkpoints.torch_import import state_dict_to_variables

from flownet2_tpu_torch import losses
from flownet2_tpu_torch.checkpoints import from_jax_variables
from flownet2_tpu_torch.checkpoints.torch_import import ROOT_PREFIX
from flownet2_tpu_torch.models import MODELS, get_model

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

H, W = 64, 128
WRAPPERS = ("FlowNet2C", "FlowNet2S", "FlowNet2SD", "FlowNet2CS",
            "FlowNet2CSS")


def _pairs(batch, seed):
    return np.random.RandomState(seed).rand(batch, 2, H, W, 3).astype(
        np.float32) * 255.0


def _numpy_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module", params=WRAPPERS)
def wrapper(request):
    """(name, the JAX model, its variables, a port model loaded from
    them)."""
    name = request.param
    made = get_model(name, device="cpu", seed=WRAPPERS.index(name))
    variables = state_dict_to_variables(_numpy_state(made), name)
    port = MODELS[name]()
    port.load_state_dict(from_jax_variables(variables, name), strict=True)
    for (k, a), (k2, b) in zip(port.state_dict().items(),
                               made.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    return name, getattr(jax_models, name)(), variables, port


def test_wrapper_keys_are_the_references(wrapper):
    """Single-net wrappers keep their modules at the root; the cascades
    name their sub-nets."""
    name, _, variables, port = wrapper
    roots = {k.split(".")[0] for k in port.state_dict()}
    if ROOT_PREFIX[name] is None:
        assert roots == set(variables["params"]) <= {
            "flownetc", "flownets_1", "flownets_2"}
    else:
        assert set(variables["params"]) == {ROOT_PREFIX[name]}
        assert "conv1" in roots and ROOT_PREFIX[name] not in roots


def test_wrapper_inference_matches_jax(wrapper):
    """The full-resolution flow, to an end-point error of 1e-4."""
    name, jm, variables, port = wrapper
    x = _pairs(1, 40 + WRAPPERS.index(name))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, H, W, 2)
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-3
    epe = np.sqrt(((got - want) ** 2).sum(-1)).mean()
    assert epe < 1e-4, epe


def test_wrapper_training_tuple_matches_jax(wrapper):
    """The multi-scale tuple (flow2 .. flow6, unscaled), each scale to
    1e-4, and MultiScale's loss of it."""
    name, jm, variables, port = wrapper
    x = _pairs(1, 50 + WRAPPERS.index(name))
    want = jax.jit(lambda v, a: jm.apply(v, a, training=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == len(want) == 5
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (1, H // (4 << s), W // (4 << s), 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    target = torch.from_numpy(np.random.RandomState(60).rand(
        1, H, W, 2).astype(np.float32) * 5.0)
    lossvalue, epevalue = losses.MultiScale()(got, target)
    assert torch.isfinite(lossvalue) and torch.isfinite(epevalue)


def test_flownetc_trains_with_batchnorm_as_jax():
    """FlowNet2C with BatchNorm in ``train()`` mode against the JAX
    package with ``train_bn=True``: the two towers are normalised apart, so
    the outputs agree, and the running statistics after the step do.  The
    shared tower layers are updated twice (first frame, then second).
    torch keeps the unbiased batch variance in ``running_var`` where Flax
    keeps the biased one, so Flax's update is scaled by n/(n-1) before the
    comparison."""
    made = get_model("FlowNet2C", device="cpu", seed=5, batch_norm=True)
    rng = np.random.RandomState(6)
    state = _numpy_state(made)
    for key, value in state.items():
        if key.endswith((".1.weight", "running_var")):
            state[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith((".1.bias", "running_mean")):
            state[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
    variables = state_dict_to_variables(state, "FlowNet2C")
    port = MODELS["FlowNet2C"](batch_norm=True)
    port.load_state_dict(from_jax_variables(variables, "FlowNet2C"),
                         strict=True)
    x = _pairs(4, 7)

    jm = jax_models.FlowNet2C(batch_norm=True)
    want, updated = jax.jit(lambda v, a: jm.apply(
        v, a, training=True, train_bn=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))

    seen = {}   # BatchNorm module name -> (calls, samples per channel)

    def count(name):
        def hook(module, args):
            calls, _ = seen.get(name, (0, 0))
            seen[name] = (calls + 1, args[0].numel() // args[0].shape[1])
        return hook

    for mod_name, module in port.named_modules():
        if isinstance(module, torch.nn.BatchNorm2d):
            module.register_forward_pre_hook(count(mod_name))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    assert {n: c for n, (c, _) in seen.items() if c != 1} == {
        "conv1.1": 2, "conv2.1": 2, "conv3.1": 2}

    want_state = from_jax_variables(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               updated["batch_stats"])},
        "FlowNet2C")
    got_state = port.state_dict()
    checked = 0
    for key, before in state.items():
        if key.endswith("running_mean"):
            np.testing.assert_allclose(got_state[key].numpy(),
                                       want_state[key].numpy(), rtol=1e-4,
                                       atol=1e-5)
            assert np.abs(got_state[key].numpy() - before).max() > 1e-4
        elif key.endswith("running_var"):
            calls, n = seen[key[:-len(".running_var")]]
            kept = 0.9 ** calls * before
            scaled = kept + (want_state[key].numpy() - kept) * n / (n - 1)
            np.testing.assert_allclose(got_state[key].numpy(), scaled,
                                       rtol=1e-4, atol=1e-5)
            checked += 1
    assert checked == 11   # every conv() of FlowNetC, conv_redir included
    # eval mode after the step uses the new statistics, batched towers
    with torch.no_grad():
        flow = port.eval()(torch.from_numpy(x))
    assert flow.shape == (4, H, W, 2) and torch.isfinite(flow).all()


def test_unknown_names_still_raise():
    with pytest.raises(KeyError, match="available"):
        get_model("FlowNet2X", device="cpu")
    with pytest.raises(KeyError, match="available"):
        get_model("FlowNetC", device="cpu")
    assert sorted(MODELS) == sorted(("FlowNet2",) + WRAPPERS)
    assert set(ROOT_PREFIX) == set(MODELS)
