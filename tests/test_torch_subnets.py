"""The port's sub-networks against the JAX package's, on the CPU.

Weights come from a JAX ``PRNGKey(0)`` init and are carried across by
``flownet2_tpu_torch.checkpoints.from_jax_variables``; inputs are seeded
numpy.  Tolerance 1e-4, as tests/test_parity_torch.py holds the JAX
package against the torch reference (different conv summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu import models as jax_models

from flownet2_tpu_torch import models
from flownet2_tpu_torch.checkpoints import from_jax_variables

H, W = 64, 128


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# name -> (JAX module, port module, NHWC input channels per argument)
SUBNETS = {
    "FlowNetS": (lambda: jax_models.FlowNetS(input_channels=12),
                 lambda: models.FlowNetS(12), (12,)),
    "FlowNetSD": (jax_models.FlowNetSD, models.FlowNetSD, (6,)),
    "FlowNetFusion": (jax_models.FlowNetFusion, models.FlowNetFusion, (11,)),
    "FlowNetC": (jax_models.FlowNetC, models.FlowNetC, (3, 3)),
}


@pytest.mark.parametrize("name", sorted(SUBNETS))
def test_subnet_matches_jax(name):
    make_jax, make_port, chans = SUBNETS[name]
    rng = np.random.RandomState(sorted(SUBNETS).index(name))
    xs = [rng.randn(1, H, W, c).astype(np.float32) for c in chans]
    jm = make_jax()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, xs))
    want = jax.jit(jm.apply)(variables, *map(jnp.asarray, xs))
    want = np.asarray(want[0] if isinstance(want, tuple) else want)

    port = make_port().eval()
    port.load_state_dict(
        from_jax_variables(_numpy_tree(variables), name), strict=True)
    with torch.no_grad():
        got = port(*map(_nchw, xs)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_batchnorm_weights_and_statistics_carry_across():
    """BatchNorm scale/bias and running mean/var land on the port's ``.1``
    modules: an eval-mode FlowNetS with BatchNorm and non-trivial running
    statistics gives the JAX package's output."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, H, W, 12).astype(np.float32)
    jm = jax_models.FlowNetS(input_channels=12, batch_norm=True)
    variables = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(x)))
    stats = variables["batch_stats"]
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else rng.randn(*v.shape) * 0.1).astype(np.float32),
        stats)
    want = np.asarray(jm.apply(variables, jnp.asarray(x))[0])

    port = models.FlowNetS(12, batch_norm=True).eval()
    port.load_state_dict(from_jax_variables(variables, "FlowNetS"),
                         strict=True)
    with torch.no_grad():
        got = port(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_flownetc_refuses_train_mode_batchnorm():
    """The batched tower would mix the streams' BatchNorm statistics."""
    net = models.FlowNetC(batch_norm=True).train()
    x = torch.zeros(2, 3, H, W)
    with pytest.raises(NotImplementedError, match="training slice"):
        net(x, x)


def test_param_counts():
    def count(m):
        return sum(p.numel() for p in m.parameters())

    # the reference's docstring says 38,676,504 for FlowNetS; its own code
    # (and the JAX package, tests/test_models.py) gives these
    assert count(models.FlowNetS(12)) == 38_695_322
    assert count(models.FlowNetS(6)) == 38_676_506
    assert count(models.FlowNetSD()) == 45_371_666
    assert count(models.FlowNetFusion()) == 581_226
    assert count(models.FlowNetC()) == 39_175_298
    assert count(models.FlowNet2()) == 162_518_834
