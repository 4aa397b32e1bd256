"""The bilinear flow upsample's deterministic backward, on the CPU.

``flownet2_tpu_torch.ops.upsample.upsample_bilinear`` runs
``F.interpolate(..., mode="bilinear", align_corners=False)`` forward and,
backward, a fixed sum of gathered taps in place of torch's backward, which
accumulates with atomic adds on CUDA.  Held here:
- the forward bit for bit against ``F.interpolate``, in float32 and
  bfloat16, with and without a gradient;
- the backward against ``F.interpolate``'s CPU backward computed in
  float64: 1e-6 relative (of the largest |gradient|) in float32, and in
  bfloat16 one bf16 ulp (rtol 2**-7, atol 1e-6 of the largest magnitude)
  of the float64 result rounded once to bfloat16;
- the backward against ``jax.vjp`` of the JAX package's
  ``upsample_bilinear`` at 1e-5, at maps of 1, 2 and 13 rows and columns,
  so that both clamped ends (and a map of one pixel, all of whose taps
  clamp) are hit;
- ``torch.autograd.gradcheck`` in float64, at the scales 4 (the models')
  and 1, 2, 3.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flownet2_tpu_torch.ops import upsample

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

jax_up = importlib.import_module("flownet2_tpu.ops.upsample")

SIZES = [(1, 1), (1, 13), (2, 2), (2, 13), (13, 1), (13, 13), (6, 7)]


def _rand(shape, seed, dtype=torch.float64):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        *shape)).to(dtype)


def _torch_grads(x, g):
    """F.interpolate's CPU backward for the cotangent ``g``, in float64."""
    leaf = x.double().requires_grad_()
    out = F.interpolate(leaf, scale_factor=4, mode="bilinear",
                        align_corners=False)
    return torch.autograd.grad(out, leaf, g.double())[0]


def _port_grads(x, g):
    leaf = x.detach().clone().requires_grad_()
    return torch.autograd.grad(upsample.upsample_bilinear(leaf), leaf, g)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_forward_is_interpolate(dtype, grad):
    """Bit for bit F.interpolate's output, with a gradient wanted and
    without one."""
    for k, (h, w) in enumerate(SIZES):
        x = _rand((2, 3, h, w), k, dtype).requires_grad_(grad)
        want = F.interpolate(x.detach(), scale_factor=4, mode="bilinear",
                             align_corners=False)
        got = upsample.upsample_bilinear(x)
        assert got.dtype == dtype and got.requires_grad == grad
        assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("h,w", SIZES)
def test_backward_matches_interpolate_f32(h, w):
    """float32: within 1e-6 of the float64 backward, relative to its
    largest magnitude."""
    x, g = _rand((2, 3, h, w), 10), _rand((2, 3, 4 * h, 4 * w), 11)
    want = _torch_grads(x, g)
    got = _port_grads(x.float(), g.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("h,w", SIZES)
def test_backward_matches_interpolate_bf16(h, w):
    """bfloat16: within one bf16 ulp of the float64 backward rounded once
    to bfloat16 (the backward sums in float32 and rounds once)."""
    x = _rand((2, 3, h, w), 20, torch.bfloat16)
    g = _rand((2, 3, 4 * h, 4 * w), 21, torch.bfloat16)
    want = _torch_grads(x, g).to(torch.bfloat16).float()
    got = _port_grads(x, g)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("h,w", [(1, 1), (1, 2), (2, 13), (13, 2),
                                 (13, 13)])
def test_backward_matches_jax_vjp(h, w):
    """Against jax.vjp of the JAX package's upsample_bilinear (NHWC) at
    1e-5, in float32."""
    x = np.random.RandomState(30).randn(2, h, w, 2).astype(np.float32)
    g = np.random.RandomState(31).randn(2, 4 * h, 4 * w, 2).astype(
        np.float32)
    _, vjp = jax.vjp(lambda t: jax_up.upsample_bilinear(t, 4),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _port_grads(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [4, 1, 2, 3])
def test_gradcheck_float64(scale):
    """The backward is the forward's transpose, by finite differences in
    float64, at a map whose ends clamp."""
    x = _rand((1, 2, 3, 5), 40).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: upsample.upsample_bilinear(t, scale), (x,))


def test_backward_repeats_bit_for_bit():
    """Two backward passes over one forward give the same bits, and the
    backward is float32 for a bfloat16 input before its one rounding."""
    x = _rand((2, 2, 12, 14), 50, torch.float32).requires_grad_()
    out = upsample.upsample_bilinear(x)
    g = _rand(out.shape, 51, torch.float32)
    first = torch.autograd.grad(out, x, g, retain_graph=True)[0]
    second = torch.autograd.grad(out, x, g)[0]
    assert torch.equal(first, second)
    with pytest.raises(ValueError):
        upsample.upsample_bilinear(x, 2.5)
