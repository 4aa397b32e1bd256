"""The port's ops (flownet2_tpu_torch.ops) against the JAX package's, on the
CPU, on the same numpy inputs.

The port is NCHW and the JAX package NHWC: inputs are made in NHWC with
numpy, handed to both, and the port's outputs are transposed back.  On the
CPU the port's ops take their plain PyTorch versions; the CUDA kernels are
held against those same plain versions on the card by chip_smoke.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from flownet2_tpu_torch import ops


def _jax_ops(name):
    # flownet2_tpu.ops re-exports functions under some of its module names
    return importlib.import_module(f"flownet2_tpu.ops.{name}")


jax_cn = _jax_ops("channelnorm")
jax_corr = _jax_ops("correlation")
jax_corr_pallas = _jax_ops("correlation_pallas")
jax_r2d = _jax_ops("resample2d")
jax_r2d_pallas = _jax_ops("resample2d_pallas")
jax_glue = _jax_ops("stage_glue")
jax_up = _jax_ops("upsample")

from flownet2_tpu_torch.ops import channelnorm, correlation, resample2d  # noqa: E402
from flownet2_tpu_torch.ops import stage_glue, upsample  # noqa: E402


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------- correlation

def test_correlation_flownetc_config_matches_jax():
    """FlowNetC's configuration (pad 20, K 1, maxd 20, s1 1, s2 2 -> 441
    channels) at a small map: the plain shifts form against the JAX
    package's shifts form and its banded-matmul form (f32, 'highest')."""
    f1, f2 = _rand((1, 16, 32, 16), 0), _rand((1, 16, 32, 16), 1)
    got = _nhwc(correlation.correlation(_nchw(f1), _nchw(f2), 20, 1, 20, 1, 2))
    assert got.shape == (1, 16, 32, 441)
    shifts = np.asarray(jax_corr._correlation_shifts(
        jnp.asarray(f1), jnp.asarray(f2), 20, 1, 20, 1, 2))
    mxu = np.asarray(jax_corr.correlation(
        jnp.asarray(f1), jnp.asarray(f2), 20, 1, 20, 1, 2, impl="mxu"))
    np.testing.assert_allclose(got, shifts, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, mxu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad,k,maxd,s1,s2", [(4, 3, 2, 1, 1),
                                               (3, 3, 2, 2, 1)])
def test_correlation_general_matches_jax_shifts(pad, k, maxd, s1, s2):
    """K = 3 with the JAX package's in-bounds centring, and stride1 2."""
    f1, f2 = _rand((2, 12, 14, 5), 2), _rand((2, 12, 14, 5), 3)
    got = _nhwc(correlation.correlation(_nchw(f1), _nchw(f2), pad, k, maxd,
                                        s1, s2))
    want = np.asarray(jax_corr._correlation_shifts(
        jnp.asarray(f1), jnp.asarray(f2), pad, k, maxd, s1, s2))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_correlation_matches_pallas_kernel_interpret():
    """Against the TPU kernel in interpret mode, at the configuration its
    own tests use; the kernel feeds bf16 operands, hence the tolerance."""
    f1, f2 = _rand((1, 8, 16, 8), 4), _rand((1, 8, 16, 8), 5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_corr_pallas.correlation_pallas(
            jnp.asarray(f1), jnp.asarray(f2), 4, 4, 2))
    got = _nhwc(correlation.correlation(_nchw(f1), _nchw(f2), 4, 1, 4, 1, 2))
    assert got.shape == want.shape == (1, 8, 16, 25)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)


# ----------------------------------------------------------------------- warp

WARP_CASES = [((1, 16, 128, 3), 2.0, 10),    # smooth flow
              ((1, 16, 128, 3), 60.0, 12),   # block-crossing and off-edge
              ((1, 12, 112, 3), 40.0, 14)]   # width not a multiple of 128


@pytest.mark.parametrize("shape,scale,seed", WARP_CASES)
def test_warp_bilinear_matches_jax(shape, scale, seed):
    img = _rand(shape, seed)
    flow = _rand(shape[:3] + (2,), seed + 1, scale)
    got = _nhwc(resample2d.resample2d(_nchw(img), _nchw(flow)))
    want = np.asarray(jax_r2d._resample2d_bilinear_impl(
        jnp.asarray(img), jnp.asarray(flow), 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jax_r2d_pallas.resample2d_bilinear_pallas(
            jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)


def test_warp_taps_and_nearest_match_jax():
    """The plain version's other modes: a 2x2 tap window, and nearest."""
    img = _rand((2, 16, 24, 3), 20)
    flow = _rand((2, 16, 24, 2), 21, 6.0)
    got = _nhwc(resample2d.resample2d(_nchw(img), _nchw(flow), 2, True))
    want = np.asarray(jax_r2d._resample2d_bilinear_impl(
        jnp.asarray(img), jnp.asarray(flow), 2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got = _nhwc(resample2d.resample2d(_nchw(img), _nchw(flow), 1, False))
    want = np.asarray(jax_r2d._resample2d_nearest_impl(
        jnp.asarray(img), jnp.asarray(flow), 1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,scale,seed", WARP_CASES)
def test_warp_multi_matches_jax_kernel(shape, scale, seed):
    """Two flows over one image against the TPU multi-flow kernel."""
    img = _rand(shape, seed)
    flows = _rand((shape[0], 2) + shape[1:3] + (2,), seed + 1, scale)
    got = resample2d.resample2d_multi(
        _nchw(img), torch.from_numpy(
            np.ascontiguousarray(flows.transpose(0, 1, 4, 2, 3))))
    got = got.numpy().transpose(0, 1, 3, 4, 2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_r2d_pallas.resample2d_bilinear_pallas_multi(
            jnp.asarray(img), jnp.asarray(flows)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- channel norm, upsampling

def test_channel_norm_matches_jax():
    xs = [_rand((2, 8, 12, c), 30 + c) for c in (2, 3)]
    got = _nhwc(channelnorm.channel_norm(_nchw(xs[1])))
    want = np.asarray(jax_cn.channel_norm(jnp.asarray(xs[1])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = _nhwc(channelnorm.channel_norm_multi(*map(_nchw, xs)))
    want = np.asarray(jax_cn.channel_norm_multi(*map(jnp.asarray, xs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_upsample_matches_jax():
    """Nearest is bit-exact.  Bilinear is F.interpolate, which the JAX
    phase decomposition reproduces to 1 ulp of the input's magnitude, not
    bit for bit (different association of the two lerps)."""
    x = _rand((2, 6, 7, 2), 40, 10.0)
    got = _nhwc(upsample.upsample_nearest(_nchw(x)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_up.upsample_nearest(jnp.asarray(x), 4)))
    got = _nhwc(upsample.upsample_bilinear(_nchw(x)))
    want = np.asarray(jax_up.upsample_bilinear(jnp.asarray(x), 4))
    ulp = np.spacing(np.abs(x).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


# ---------------------------------------------------------------- stage glue

def test_stage_glue_matches_jax():
    x, x2 = _rand((2, 16, 128, 6), 50), _rand((2, 16, 128, 3), 51)
    flow = _rand((2, 16, 128, 2), 52, 5.0)
    got = _nhwc(stage_glue.stage_glue(_nchw(x), _nchw(x2), _nchw(flow), 20.0))
    want = np.asarray(jax_glue.stage_glue(
        jnp.asarray(x), jnp.asarray(x2), jnp.asarray(flow), 20.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fusion_glue_matches_jax_in_one_warp_call():
    x1, x2 = _rand((2, 16, 128, 3), 60), _rand((2, 16, 128, 3), 61)
    sdf, s2f = _rand((2, 16, 128, 2), 62, 4.0), _rand((2, 16, 128, 2), 63, 6.0)
    ops.reset_counts()
    got = _nhwc(stage_glue.fusion_glue(*map(_nchw, (x1, x2, sdf, s2f))))
    assert dict(ops.PLAIN_CALLS) == {"resample2d_multi": 1}
    want = np.asarray(jax_glue.fusion_glue(
        *map(jnp.asarray, (x1, x2, sdf, s2f))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- dispatch and counts

def test_cpu_takes_plain_versions_and_launches_nothing():
    f = torch.from_numpy(_rand((1, 4, 8, 8), 70))
    img = torch.from_numpy(_rand((1, 3, 8, 8), 71))
    flow = torch.from_numpy(_rand((1, 2, 8, 8), 72))
    ops.reset_counts()
    correlation.correlation(f, f, 2, 1, 2, 1, 1)
    resample2d.resample2d(img, flow)
    resample2d.resample2d_multi(img, torch.stack([flow, flow], 1))
    assert sum(ops.LAUNCHES.values()) == 0
    assert dict(ops.PLAIN_CALLS) == {"correlation": 1, "resample2d": 1,
                                     "resample2d_multi": 1}


def test_non_cpu_tensors_never_fall_back_to_plain():
    """A tensor off the CPU goes to the CUDA wrapper, which raises on
    anything it cannot launch: here a tensor on the meta device, a
    configuration the kernel does not cover, and inputs that need grad."""
    f = torch.empty(1, 4, 8, 8, device="meta")
    img = torch.empty(1, 3, 8, 8, device="meta")
    flow = torch.empty(1, 2, 8, 8, device="meta")
    ops.reset_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        correlation.correlation(f, f, 2, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        resample2d.resample2d(img, flow)
    with pytest.raises(ValueError, match="CUDA device"):
        resample2d.resample2d_multi(img, torch.stack([flow, flow], 1))
    with pytest.raises(NotImplementedError, match="kernel_size=1"):
        correlation.correlation(f, f, 3, 3, 2, 1, 1)
    with pytest.raises(NotImplementedError, match="bilinear"):
        resample2d.resample2d(img, flow, 1, False)
    with pytest.raises(NotImplementedError, match="training slice"):
        correlation.correlation(f.requires_grad_(), f, 2, 1, 2, 1, 1)
    assert sum(ops.PLAIN_CALLS.values()) == 0
    assert sum(ops.LAUNCHES.values()) == 0
