"""The port's ops (flownet2_tpu_torch.ops) against the JAX package's, on the
CPU, on the same numpy inputs.

The port is NCHW and the JAX package NHWC: inputs are made in NHWC with
numpy, handed to both, and the port's outputs are transposed back.  On the
CPU the port's ops take their plain PyTorch versions; the CUDA kernels are
held against those same plain versions on the card by chip_smoke.py.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
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
from flownet2_tpu_torch.ops import sharding_hints, stage_glue  # noqa: E402
from flownet2_tpu_torch.ops import upsample  # noqa: E402

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _leaf(x):
    """An NHWC numpy array as an NCHW tensor that requires grad."""
    return _nchw(x).requires_grad_()


def _flows(x):
    """(B, H, W, 2) numpy -> (B, 1, 2, H, W) tensor, one flow."""
    return _nchw(x).unsqueeze(1)


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


def test_correlation_grads_match_jax_vjp():
    """FlowNetC's configuration at a small map: the gradients of the
    port's correlation (the plain backward loop on the CPU) against
    jax.vjp of the JAX package's op (its _corr_bwd), f32."""
    f1, f2 = _rand((2, 12, 28, 16), 6), _rand((2, 12, 28, 16), 7)
    g = _rand((2, 12, 28, 441), 8)
    _, vjp = jax.vjp(lambda a, b: jax_corr.correlation(a, b, 20, 1, 20, 1, 2),
                     jnp.asarray(f1), jnp.asarray(f2))
    want1, want2 = vjp(jnp.asarray(g))
    t1, t2 = _leaf(f1), _leaf(f2)
    ops.reset_counts()
    correlation.correlation(t1, t2, 20, 1, 20, 1, 2).backward(_nchw(g))
    assert dict(ops.PLAIN_CALLS) == {"correlation": 1, "correlation_bwd": 1}
    np.testing.assert_allclose(_nhwc(t1.grad), want1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_nhwc(t2.grad), want2, rtol=1e-5, atol=1e-5)


def test_correlation_bwd_matches_pallas_kernel_interpret():
    """The plain backward against the TPU backward kernels in interpret
    mode at maxd 4; they feed bf16 operands, hence the tolerance."""
    f1, f2 = _rand((1, 8, 16, 8), 9), _rand((1, 8, 16, 8), 10)
    g = _rand((1, 8, 16, 25), 11)
    with pltpu.force_tpu_interpret_mode():
        want1, want2 = jax_corr_pallas.correlation_pallas_bwd(
            jnp.asarray(g), jnp.asarray(f1), jnp.asarray(f2), 4, 4, 2)
    got1, got2 = correlation.correlation_bwd_plain(
        _nchw(g), _nchw(f1), _nchw(f2), 4, 2)
    np.testing.assert_allclose(_nhwc(got1), want1, rtol=0.05, atol=0.02)
    np.testing.assert_allclose(_nhwc(got2), want2, rtol=0.05, atol=0.02)
    only2 = correlation.correlation_bwd_plain(
        _nchw(g), _nchw(f1), _nchw(f2), 4, 2, needs=(False, True))
    assert only2[0] is None and torch.equal(only2[1], got2)


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


@pytest.mark.parametrize("shape,scale,seed", WARP_CASES)
def test_warp_tangents_and_grad_flow_match_jax_kernels(shape, scale, seed):
    """The plain versions of K3 and K4 against the TPU kernels they replace
    (resample2d_bilinear_tangents_pallas, resample2d_grad_flow_pallas) in
    interpret mode, f32."""
    img = _rand(shape, seed)
    flow = _rand(shape[:3] + (2,), seed + 1, scale)
    g = _rand(shape, seed + 2)
    with pltpu.force_tpu_interpret_mode():
        want = jax_r2d_pallas.resample2d_bilinear_tangents_pallas(
            jnp.asarray(img), jnp.asarray(flow))
        want_flow = np.asarray(jax_r2d_pallas.resample2d_grad_flow_pallas(
            jnp.asarray(g), jnp.asarray(img), jnp.asarray(flow)))
    got = resample2d.resample2d_tangents_plain(_nchw(img), _flows(flow))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_nhwc(a[:, 0]), b, rtol=1e-5, atol=1e-5)
    got_flow = resample2d.resample2d_grad_flow_plain(
        _nchw(g).unsqueeze(1), _nchw(img), _flows(flow))
    np.testing.assert_allclose(_nhwc(got_flow[:, 0]), want_flow, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("shape,scale,seed", WARP_CASES)
@pytest.mark.parametrize("route", ["generic", "tangents"])
def test_warp_grads_match_jax_bwd(shape, scale, seed, route):
    """Image and flow gradients of both differentiable forms of the warp
    against the JAX package's XLA backward (_resample2d_bwd), f32."""
    img = _rand(shape, seed)
    flow = _rand(shape[:3] + (2,), seed + 1, scale)
    g = _rand(shape, seed + 2)
    want_img, want_flow = jax_r2d._resample2d_bwd(
        1, True, (jnp.asarray(img), jnp.asarray(flow), None), jnp.asarray(g))
    t_img, t_flow = _leaf(img), _leaf(flow)
    ops.reset_counts()
    if route == "generic":
        out = resample2d.resample2d(t_img, t_flow)
        plain = {"resample2d": 1, "resample2d_grad_flow": 1}
    else:
        out = resample2d.resample2d_tangents(t_img, t_flow.unsqueeze(1))[:, 0]
        plain = {"resample2d_tangents": 1}
    out.backward(_nchw(g))
    assert dict(ops.PLAIN_CALLS) == plain
    np.testing.assert_allclose(_nhwc(t_img.grad), want_img, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(t_flow.grad), want_flow, rtol=1e-5,
                               atol=1e-4)


def test_warp_taps_and_nearest_grads_match_jax():
    """The other modes differentiate through the plain version: a 2x2 tap
    window (image and flow) and nearest (image; the flow gets none)."""
    img = _rand((2, 16, 24, 3), 22)
    flow = _rand((2, 16, 24, 2), 23, 6.0)
    g = _rand((2, 16, 24, 3), 24)
    for taps, bilinear in ((2, True), (1, False)):
        want_img, want_flow = jax_r2d._resample2d_bwd(
            taps, bilinear, (jnp.asarray(img), jnp.asarray(flow), None),
            jnp.asarray(g))
        t_img, t_flow = _leaf(img), _leaf(flow)
        resample2d.resample2d(t_img, t_flow, taps, bilinear).backward(
            _nchw(g))
        np.testing.assert_allclose(_nhwc(t_img.grad), want_img, rtol=1e-5,
                                   atol=1e-5)
        got_flow = (np.zeros_like(flow) if t_flow.grad is None
                    else _nhwc(t_flow.grad))
        np.testing.assert_allclose(got_flow, want_flow, rtol=1e-5, atol=1e-4)


# ------------------------------------------------- channel norm, upsampling

def test_channel_norm_matches_jax():
    xs = [_rand((2, 8, 12, c), 30 + c) for c in (2, 3)]
    got = _nhwc(channelnorm.channel_norm(_nchw(xs[1])))
    want = np.asarray(jax_cn.channel_norm(jnp.asarray(xs[1])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = _nhwc(channelnorm.channel_norm_multi(*map(_nchw, xs)))
    want = np.asarray(jax_cn.channel_norm_multi(*map(jnp.asarray, xs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_channel_norm_grad_at_zero_is_zero_as_in_jax():
    """Exact-zero pixels (two frames that agree there) get the reference's
    guarded gradient g*x/(norm + 1e-9) = 0, as jax.grad of the JAX op
    gives, not the NaN of autograd through sqrt."""
    xs = [_rand((2, 6, 8, c), 34 + c) for c in (2, 3)]
    for x in xs:
        x[:, 1:4, 2:5] = 0.0
    g = _rand((2, 6, 8, 2), 36)
    _, vjp = jax.vjp(jax_cn.channel_norm_multi, *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(g))
    ts = [_leaf(x) for x in xs]
    channelnorm.channel_norm_multi(*ts).backward(_nchw(g))
    for t, w in zip(ts, want):
        assert np.isfinite(_nhwc(t.grad)).all()
        np.testing.assert_allclose(_nhwc(t.grad), w, rtol=1e-5, atol=1e-6)
    assert np.all(_nhwc(ts[1].grad)[:, 1:4, 2:5] == 0)
    t = _leaf(xs[1])
    channelnorm.channel_norm(t).sum().backward()
    want = jax.grad(lambda x: jax_cn.channel_norm(x).sum())(
        jnp.asarray(xs[1]))
    np.testing.assert_allclose(_nhwc(t.grad), want, rtol=1e-5, atol=1e-6)


def test_avg_pool_matches_jax():
    x = _rand((2, 16, 24, 2), 41)
    for window in (4, 8):
        np.testing.assert_allclose(
            _nhwc(upsample.avg_pool(_nchw(x), window)),
            np.asarray(jax_up.avg_pool(jnp.asarray(x), window)),
            rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("route,plain", [
    ("tangents", {"resample2d_tangents": 1}),
    ("grad_flow", {"resample2d": 1, "resample2d_grad_flow": 1})])
def test_stage_glue_grads_match_jax(monkeypatch, route, plain):
    """Gradients of the stage glue by both training warps against jax.vjp
    of the JAX glue, for every input; some pixels are exact zeros of the
    norm (x1 equals the warp of a constant x2 under zero flow)."""
    x, x2 = _rand((2, 16, 128, 6), 53), _rand((2, 16, 128, 3), 54)
    flow = _rand((2, 16, 128, 2), 55, 5.0)
    x2[:, :4] = 0.5
    flow[:, :4] = 0.0
    x[:, :4, :, :3] = 0.5
    g = _rand((2, 16, 128, 12), 56)
    _, vjp = jax.vjp(lambda a, b, f: jax_glue.stage_glue(a, b, f, 20.0),
                     *map(jnp.asarray, (x, x2, flow)))
    want = vjp(jnp.asarray(g))
    monkeypatch.setattr(stage_glue, "TRAIN_WARP", route)
    ts = [_leaf(a) for a in (x, x2, flow)]
    ops.reset_counts()
    stage_glue.stage_glue(*ts, 20.0).backward(_nchw(g))
    assert dict(ops.PLAIN_CALLS) == plain
    for t, w in zip(ts, want):
        np.testing.assert_allclose(_nhwc(t.grad), w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("route,plain", [
    ("tangents", {"resample2d_tangents_multi": 1}),
    ("grad_flow", {"resample2d_multi": 1, "resample2d_grad_flow_multi": 1})])
def test_fusion_glue_grads_match_jax(monkeypatch, route, plain):
    """The fusion glue's gradients by both training warps, one two-flow
    warp call each, against jax.vjp of the JAX glue."""
    x1, x2 = _rand((2, 16, 128, 3), 64), _rand((2, 16, 128, 3), 65)
    sdf, s2f = _rand((2, 16, 128, 2), 66, 4.0), _rand((2, 16, 128, 2), 67, 6.0)
    g = _rand((2, 16, 128, 11), 68)
    _, vjp = jax.vjp(jax_glue.fusion_glue, *map(jnp.asarray,
                                                 (x1, x2, sdf, s2f)))
    want = vjp(jnp.asarray(g))
    monkeypatch.setattr(stage_glue, "TRAIN_WARP", route)
    ts = [_leaf(a) for a in (x1, x2, sdf, s2f)]
    ops.reset_counts()
    stage_glue.fusion_glue(*ts).backward(_nchw(g))
    assert dict(ops.PLAIN_CALLS) == plain
    for t, w in zip(ts, want):
        np.testing.assert_allclose(_nhwc(t.grad), w, rtol=1e-5, atol=1e-4)


# ------------------------------------------ the configurations no model uses
#
# The correlation outside K 1, s1 1, pad == maxd and the warp other than
# bilinear K=1 (the ``_CorrelationCfg`` and ``_WarpCfg`` Functions: their
# plain versions here, the ``correlation_cfg`` and ``resample2d_cfg``
# kernels on the card, held to the same plain versions by chip_smoke.py).
# The inputs are values of bfloat16 (exact in float16 and float32), so that
# one JAX float32 reference serves the three dtypes: float32 at 1e-5,
# bfloat16 and float16 within one ulp of that reference rounded to their
# dtype (both sum in float32 and round once).

LOW = {torch.bfloat16: 7, torch.float16: 10}   # significand bits
DTYPES = pytest.mark.parametrize(
    "dtype", [torch.float32, torch.bfloat16, torch.float16],
    ids=["f32", "bf16", "fp16"])


def _bf16_values(shape, seed, scale=1.0):
    """Seeded normal values rounded to bfloat16, as float32 numpy."""
    return torch.from_numpy(_rand(shape, seed, scale)).bfloat16().float(
        ).numpy()


def _close(got, want, dtype, what):
    """float32 at 1e-5; bfloat16 and float16 within one ulp of ``want``
    rounded to their dtype (rtol one ulp, atol 1e-6 of the largest
    magnitude)."""
    assert got.dtype == dtype, (what, got.dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
        return
    rounded = torch.from_numpy(np.array(want)).to(dtype).float()
    got = torch.from_numpy(np.ascontiguousarray(_nhwc(got.float())))
    ulp = 2.0 ** -LOW[dtype]
    top = float(rounded.abs().max())
    print(f"{what}: max abs diff {float((got - rounded).abs().max()):.3e} "
          f"from the rounded JAX float32 result, not bit-equal "
          f"{float((got != rounded).float().mean()):.4%}")
    torch.testing.assert_close(got, rounded, rtol=ulp, atol=1e-6 * top,
                               msg=what)


# (pad, K, maxd, s1, s2) and an NHWC map: an output that shrinks (pad below
# b_rad, stride1 2), one larger than the input (pad 6 above maxd 4), even
# K, and the twins of (21, 3, 20, 1, 2) and (20, 1, 20, 2, 2) at maxd 4:
# the same pad - b_rad, K, stride1 and stride2 at D = 5 (the JAX shifts
# form's vjp at D = 21 and K 3 compiles for ~56 s on a CPU; the port's
# kernels meet the full configurations on the card, chip_smoke.py phase 2).
CFG_CASES = [((5, 3, 4, 1, 2), (2, 14, 16, 6)),
             ((4, 1, 4, 2, 2), (2, 16, 20, 8)),
             ((2, 3, 3, 2, 1), (2, 16, 20, 8)),
             ((6, 1, 4, 1, 1), (2, 12, 14, 5)),
             ((4, 2, 4, 1, 2), (2, 12, 14, 12))]
CFG_IDS = ["-".join(map(str, c)) for c, _ in CFG_CASES]


@functools.lru_cache(maxsize=None)
def _correlation_cfg_reference(cfg, shape):
    """Seeded bfloat16 values f1, f2, g (NHWC) and the JAX package's
    correlation and ``jax.vjp`` of it (its general ``_corr_bwd``) in
    float32, one compile."""
    f1, f2 = _bf16_values(shape, 80), _bf16_values(shape, 81)
    out = jax.eval_shape(lambda a, b: jax_corr.correlation(a, b, *cfg),
                         jnp.asarray(f1), jnp.asarray(f2))
    g = _bf16_values(out.shape, 82)

    @jax.jit
    def both(a, b, cot):
        value, vjp = jax.vjp(lambda x, y: jax_corr.correlation(x, y, *cfg),
                             a, b)
        return value, vjp(cot)

    want, (want1, want2) = both(jnp.asarray(f1), jnp.asarray(f2),
                                jnp.asarray(g))
    return f1, f2, g, np.asarray(want), np.asarray(want1), np.asarray(want2)


@DTYPES
@pytest.mark.parametrize("cfg,shape", CFG_CASES, ids=CFG_IDS)
def test_correlation_cfg_and_grads_match_jax_vjp(cfg, shape, dtype):
    """The cost volume and both gradients at a configuration no model uses
    (``_CorrelationCfg``: ``correlation_plain`` and
    ``correlation_cfg_bwd_plain`` on the CPU) against the JAX package's
    correlation and its VJP."""
    f1, f2, g, want, want1, want2 = _correlation_cfg_reference(cfg, shape)
    t1 = _nchw(f1).to(dtype).requires_grad_()
    t2 = _nchw(f2).to(dtype).requires_grad_()
    ops.reset_counts()
    out = correlation.correlation(t1, t2, *cfg)
    out.backward(_nchw(g).to(dtype))
    assert dict(ops.PLAIN_CALLS) == {"correlation": 1,
                                     "correlation_cfg_bwd": 1}
    assert sum(ops.LAUNCHES.values()) == 0
    for what, got, ref in (("out", out, want), ("d_f1", t1.grad, want1),
                           ("d_f2", t2.grad, want2)):
        _close(got, ref, dtype, f"{cfg} {what}")
    if dtype != torch.float32 and cfg == CFG_CASES[0][0]:
        # the JAX package's own low-precision shifts form multiplies in
        # the low dtype: printed beside, the JAX package's own difference
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
        low = jax.jit(lambda a, b: jax_corr.correlation(a, b, *cfg))(
            jnp.asarray(f1, jdt), jnp.asarray(f2, jdt))
        rounded = np.asarray(jnp.asarray(want, jdt).astype(jnp.float32))
        gap = float(np.abs(np.asarray(low.astype(jnp.float32))
                           - rounded).max())
        print(f"{cfg}: the JAX package's {jdt.dtype.name} correlation "
              f"{gap:.3e} from its rounded float32 result (|out| up to "
              f"{float(np.abs(want).max()):.3f})")


@pytest.mark.parametrize("cfg",
                         [(21, 3, 20, 1, 2)] + [c for c, _ in CFG_CASES],
                         ids=["21-3-20-1-2"] + CFG_IDS)
def test_correlation_cfg_bwd_plain_matches_autograd(cfg):
    """``correlation_cfg_bwd_plain`` (the windows' in-place sums) against
    torch.autograd of ``correlation_plain``, at FlowNetC's map's
    configuration with K 3 too, float32 at 1e-6."""
    f1 = torch.from_numpy(_rand((2, 5, 12, 14), 83)).requires_grad_()
    f2 = torch.from_numpy(_rand((2, 5, 12, 14), 84)).requires_grad_()
    out = correlation.correlation_plain(f1, f2, *cfg)
    g = torch.from_numpy(_rand(tuple(out.shape), 85))
    want = torch.autograd.grad(out, (f1, f2), g)
    got = correlation.correlation_cfg_bwd_plain(g, f1.detach(), f2.detach(),
                                                *cfg)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    only2 = correlation.correlation_cfg_bwd_plain(
        g, f1.detach(), f2.detach(), *cfg, needs=(False, True))
    assert only2[0] is None and torch.equal(only2[1], got[1])


def test_correlation_cfg_rejects_undefined_and_empty_launches_nothing():
    """kernel_size, stride1 or stride2 below 1, or a negative pad or
    max_displacement raise ``ValueError`` (the JAX package divides by zero
    at K 0); an output with no rows is empty and its gradients zero."""
    f = torch.from_numpy(_rand((1, 2, 4, 4), 86))
    for bad in ((0, 0, 1, 1, 1), (0, 1, 1, 0, 1), (0, 1, 1, 1, 0),
                (-1, 1, 1, 1, 1), (1, 1, -1, 1, 1)):
        with pytest.raises(ValueError, match="kernel_size"):
            correlation.correlation(f, f, *bad)
    with pytest.raises(ValueError, match="kernel_size"):
        ops.Correlation()(f, f)
    leaf = f.clone().requires_grad_()
    ops.reset_counts()
    out = correlation.correlation(leaf, f, 0, 3, 4, 1, 1)
    assert out.shape == (1, 81, 0, 0)
    out.sum().backward()
    assert torch.equal(leaf.grad, torch.zeros_like(f))
    assert sum(ops.LAUNCHES.values()) == 0


WARP_CFG_CASES = [(2, True), (3, True), (1, False)]
WARP_CFG_IDS = ["bilinear-K2", "bilinear-K3", "nearest"]


@functools.lru_cache(maxsize=None)
def _warp_cfg_reference(kernel_size, bilinear):
    """Seeded bfloat16 values: an image (2, 14, 18, 3), a flow of up to
    +-9 px (some sample points off every edge) and a cotangent; the JAX
    package's warp and ``_resample2d_bwd`` (image and flow gradients) in
    float32."""
    img = _bf16_values((2, 14, 18, 3), 90)
    flow = _bf16_values((2, 14, 18, 2), 91, 4.0)
    g = _bf16_values((2, 14, 18, 3), 92)
    impl = (functools.partial(jax_r2d._resample2d_bilinear_impl,
                              kernel_size=kernel_size) if bilinear
            else functools.partial(jax_r2d._resample2d_nearest_impl,
                                   kernel_size=kernel_size))
    want = impl(jnp.asarray(img), jnp.asarray(flow))
    want_img, want_flow = jax_r2d._resample2d_bwd(
        kernel_size, bilinear, (jnp.asarray(img), jnp.asarray(flow), None),
        jnp.asarray(g))
    return (img, flow, g, np.asarray(want), np.asarray(want_img),
            np.asarray(want_flow))


@DTYPES
@pytest.mark.parametrize("kernel_size,bilinear", WARP_CFG_CASES,
                         ids=WARP_CFG_IDS)
def test_warp_cfg_and_grads_match_jax_bwd(kernel_size, bilinear, dtype):
    """The warps no model uses (``_WarpCfg``: ``resample2d_plain``,
    ``resample2d_cfg_grad_flow_plain`` and the image gradient ``_d_img``
    on the CPU): the warp, its image gradient and its flow gradient
    against the JAX package's warp and ``_resample2d_bwd``.  The nearest
    warp is an exact gather in every dtype, and gives the flow no gradient
    (the JAX package's zeros)."""
    img, flow, g, want, want_img, want_flow = _warp_cfg_reference(
        kernel_size, bilinear)
    t_img = _nchw(img).to(dtype).requires_grad_()
    t_flow = _nchw(flow).to(dtype).requires_grad_()
    ops.reset_counts()
    out = resample2d.resample2d(t_img, t_flow, kernel_size, bilinear)
    out.backward(_nchw(g).to(dtype))
    plain = {"resample2d": 1}
    if bilinear:
        plain["resample2d_cfg_grad_flow"] = 1
    assert dict(ops.PLAIN_CALLS) == plain
    assert sum(ops.LAUNCHES.values()) == 0
    what = f"{WARP_CFG_IDS[WARP_CFG_CASES.index((kernel_size, bilinear))]}"
    if bilinear:
        _close(out, want, dtype, f"{what} warp")
        _close(t_flow.grad, want_flow, dtype, f"{what} flow gradient")
    else:
        np.testing.assert_array_equal(_nhwc(out.float()), want)
        assert t_flow.grad is None and not want_flow.any()
    _close(t_img.grad, want_img, dtype, f"{what} image gradient")


@pytest.mark.parametrize("kernel_size,bilinear", WARP_CFG_CASES,
                         ids=WARP_CFG_IDS)
def test_warp_cfg_image_gradient_is_a_fixed_sum(kernel_size, bilinear):
    """``_d_img`` with the taps of a K x K window, or nearest's one tap:
    two calls bit-equal, and within 1e-6 of a float64 scatter-add."""
    img = torch.from_numpy(_rand((2, 3, 14, 18), 93))
    flow = torch.from_numpy(_rand((2, 1, 2, 14, 18), 94, 4.0))
    g = torch.from_numpy(_rand((2, 1, 3, 14, 18), 95))
    first = resample2d._d_img(g, img, flow, 0, kernel_size, bilinear)
    second = resample2d._d_img(g, img, flow, 0, kernel_size, bilinear)
    assert torch.equal(first, second)
    leaf = img.double().requires_grad_()
    resample2d.resample2d_plain(leaf, flow[:, 0].double(), kernel_size,
                                bilinear).backward(g[:, 0].double())
    torch.testing.assert_close(first.double(), leaf.grad, rtol=1e-6,
                               atol=1e-6)


def test_op_surface_matches_jax_classes():
    """``ops.Correlation``, ``ops.Resample2d``, ``ops.ChannelNorm`` and
    ``ops.upsample`` against the JAX package's classes and function."""
    jax_ops = importlib.import_module("flownet2_tpu.ops")
    f1, f2 = _rand((2, 12, 14, 5), 96), _rand((2, 12, 14, 5), 97)
    args = (4, 2, 4, 1, 2)
    got = ops.Correlation(*args)(_nchw(f1), _nchw(f2))
    want = jax_ops.Correlation(*args)(jnp.asarray(f1), jnp.asarray(f2))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
    img, flow = _rand((2, 12, 14, 3), 98), _rand((2, 12, 14, 2), 99, 4.0)
    for taps, bilinear in ((1, True), (2, True), (1, False)):
        got = ops.Resample2d(taps, bilinear)(_nchw(img), _nchw(flow))
        want = jax_ops.Resample2d(taps, bilinear)(jnp.asarray(img),
                                                  jnp.asarray(flow))
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _nhwc(ops.ChannelNorm()(_nchw(img))),
        jax_ops.ChannelNorm()(jnp.asarray(img)), rtol=1e-5, atol=1e-6)
    for module in (ops.ChannelNorm, jax_ops.ChannelNorm):
        with pytest.raises(NotImplementedError, match="L2"):
            module(1)
    x = _rand((2, 5, 6, 2), 100)
    for mode in ("bilinear", "nearest"):
        got = ops.upsample(_nchw(x), 4, mode)
        want = jax_ops.upsample(jnp.asarray(x), 4, mode)
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)
    for up in (ops.upsample, jax_ops.upsample):
        with pytest.raises(ValueError, match="unknown upsample mode"):
            up(jnp.asarray(x) if up is jax_ops.upsample else _nchw(x), 4,
               "bicubic")
    # ops.upsample is also the module its users import
    assert ops.upsample.upsample_bilinear is upsample.upsample_bilinear
    assert list(ops.Correlation(*args).parameters()) == []


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


def test_cpu_backward_takes_plain_versions_and_launches_nothing():
    f1 = torch.from_numpy(_rand((1, 4, 8, 8), 73)).requires_grad_()
    f2 = torch.from_numpy(_rand((1, 4, 8, 8), 74)).requires_grad_()
    img = torch.from_numpy(_rand((1, 3, 8, 8), 75))
    flows = torch.from_numpy(_rand((1, 2, 2, 8, 8), 76)).requires_grad_()
    ops.reset_counts()
    correlation.correlation(f1, f2, 2, 1, 2, 1, 1).sum().backward()
    resample2d.resample2d_multi(img, flows).sum().backward()
    resample2d.resample2d_tangents(img, flows).sum().backward()
    assert sum(ops.LAUNCHES.values()) == 0
    assert dict(ops.PLAIN_CALLS) == {
        "correlation": 1, "correlation_bwd": 1, "resample2d_multi": 1,
        "resample2d_grad_flow_multi": 1, "resample2d_tangents_multi": 1}


def test_non_cpu_tensors_never_fall_back_to_plain():
    """A tensor off the CPU goes to the CUDA wrapper, which raises on
    anything it cannot launch: here a tensor on the meta device, at the
    models' configurations and at the others (which go to the
    ``correlation_cfg`` and ``resample2d_cfg`` wrappers), and inputs that
    need grad, which go through the autograd.Function to the same
    wrapper.  Under a band context the other configurations raise."""
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
    with pytest.raises(ValueError, match="CUDA device"):
        resample2d.resample2d_tangents(img, torch.stack([flow, flow], 1))
    with pytest.raises(ValueError, match="CUDA device"):
        correlation.correlation(f, f, 3, 3, 2, 1, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        resample2d.resample2d(img, flow, 1, False)
    f_grad = f.clone().requires_grad_()
    flow_grad = flow.clone().requires_grad_()
    with pytest.raises(ValueError, match="CUDA device"):
        correlation.correlation(f_grad, f, 2, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        resample2d.resample2d(img, flow_grad)
    with pytest.raises(ValueError, match="CUDA device"):
        resample2d.resample2d_tangents(img, flow_grad.unsqueeze(1))
    with pytest.raises(ValueError, match="CUDA device"):
        resample2d.resample2d(img, flow_grad, 1, False)
    band = sharding_hints.Band(None, 2, 0, ((0, 64), (64, 128)))
    with sharding_hints.scoped_band(band):
        with pytest.raises(NotImplementedError, match="row bands"):
            correlation.correlation(f, f, 3, 3, 2, 1, 1)
        with pytest.raises(NotImplementedError, match="row bands"):
            resample2d.resample2d(img, flow, 3, True)
    assert sum(ops.PLAIN_CALLS.values()) == 0
    assert sum(ops.LAUNCHES.values()) == 0
