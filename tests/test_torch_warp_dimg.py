"""The warp's image gradient (``ops/resample2d.py`` ``_d_img``) against the
JAX package's, on the CPU, on the same seeded numpy inputs.

``_d_img`` sums each target pixel's taps in a fixed order (a stable sort by
target, a pairwise tree over each target's run, a gather), so it has no
``scatter_add_`` and gives the same bits on any device; the card's check is
``chip_smoke.py`` phase 2.  Here it is held against ``jax.vjp`` of the JAX
warp with respect to the image, for one and two flows over the image rows
of a band at an offset (the JAX side warps the whole image with the
cotangent zero outside the band's rows, which adds exact zeros):

- float32: within 1e-5 of the JAX gradient (relative, and 1e-5 of its
  largest magnitude absolute);
- bfloat16: the port sums in float32 and rounds once, so it is held within
  one bf16 ulp of ``jax.vjp`` of the JAX warp in float32 on the same bf16
  values, rounded to bf16; the JAX package's own bf16 gradient (its XLA
  scatter rounds to bf16 as it sums) is held at 2e-2 in relative L2, as
  ``tests/test_torch_bf16_spatial.py`` holds it.

The flows reach up to 30 px beyond a 32x48 image, so that many taps clamp
onto the border and a pixel collects dozens of them.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.ops.resample2d import resample2d as jax_resample2d

from flownet2_tpu_torch.ops import resample2d

from test_torch_bf16_train import _one_ulp, _rel_l2

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

B, C, H, W = 2, 3, 32, 48
OFF, HO = 8, 16     # the band: image rows [OFF, OFF + HO)


def _inputs(nflows, seed):
    """img (B, H, W, C), flows (F, B, H, W, 2) up to 30 px, and the
    cotangent (F, B, H, W, C), zero outside the band's rows, float32."""
    rng = np.random.RandomState(seed)
    img = rng.randn(B, H, W, C).astype(np.float32)
    flows = ((rng.rand(nflows, B, H, W, 2) * 2 - 1) * 30).astype(np.float32)
    g = np.zeros((nflows, B, H, W, C), np.float32)
    g[:, :, OFF:OFF + HO] = rng.randn(nflows, B, HO, W, C)
    return img, flows, g


def _jax_d_img(img, flows, g, dtype):
    """d img of sum_f <g_f, warp(img, flow_f)> by jax.vjp, NHWC."""
    def warp(i):
        return jnp.stack([jax_resample2d(i, jnp.asarray(f, dtype))
                          for f in flows])
    _, vjp = jax.vjp(jax.jit(warp), jnp.asarray(img, dtype))
    (d_img,) = vjp(jnp.asarray(g, dtype))
    return d_img


def _port_d_img(img, flows, g, dtype):
    """``_d_img`` on the band: the flows' and the cotangent's rows
    [OFF, OFF + HO), the whole image, NHWC float32."""
    t_img = torch.from_numpy(img.transpose(0, 3, 1, 2).copy()).to(dtype)
    band = slice(OFF, OFF + HO)
    t_flows = torch.from_numpy(
        flows[:, :, band].transpose(1, 0, 4, 2, 3).copy()).to(dtype)
    t_g = torch.from_numpy(
        g[:, :, band].transpose(1, 0, 4, 2, 3).copy()).to(dtype)
    got = resample2d._d_img(t_g, t_img, t_flows, OFF)
    assert got.dtype == dtype and got.shape == t_img.shape
    again = resample2d._d_img(t_g, t_img, t_flows, OFF)
    assert torch.equal(got, again)
    return got.float().numpy().transpose(0, 2, 3, 1)


def _bf16_values(*arrays):
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]


def test_d_img_sums_without_a_scatter():
    """F4: no scatter_add_ (atomics on the card) in the image gradient."""
    source = inspect.getsource(resample2d._d_img)
    assert "scatter" not in source.split('"""')[-1]


@pytest.mark.parametrize("nflows", [1, 2])
def test_d_img_matches_jax_vjp_f32(nflows):
    img, flows, g = _inputs(nflows, seed=40 + nflows)
    want = np.asarray(_jax_d_img(img, flows, g, jnp.float32))
    got = _port_d_img(img, flows, g, torch.float32)
    # the band's taps reach beyond its rows: the gradient is not confined
    # to them
    assert np.abs(got[:, :OFF]).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("nflows", [1, 2])
def test_d_img_matches_jax_vjp_bf16(nflows):
    img, flows, g = _bf16_values(*_inputs(nflows, seed=50 + nflows))
    got = _port_d_img(img, flows, g, torch.bfloat16)
    # float32 sums of the same bf16 values, rounded once
    want = np.asarray(_jax_d_img(img, flows, g, jnp.float32)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    _one_ulp(got, want, f"d_img, {nflows} flow(s)")
    # the JAX package's bf16 gradient, summed in bf16
    own = np.asarray(_jax_d_img(img, flows, g, jnp.bfloat16)
                     .astype(jnp.float32))
    rel = _rel_l2(got, own)
    print(f"d_img, {nflows} flow(s): relative L2 {rel:.3e} against the JAX "
          "package's bf16 gradient")
    assert rel <= 2e-2
