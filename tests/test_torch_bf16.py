"""The port's bfloat16 inference path against the JAX package's bf16 model,
on the CPU, on the same seeded numpy inputs.

The JAX package's bf16 mode (``dtype=jnp.bfloat16``) casts the normalised
frames once and then runs the convolutions, the glue and the warps in
bf16, with the parameters float32 and cast at use; its correlation and
warps compute in float32 and round once.  The port's
``get_model(..., dtype=torch.bfloat16)`` does the same.  On the CPU the
port's ops take their plain versions, which upcast, compute in float32 and
round once, as the kernels do on the card (``chip_smoke.py`` holds the
kernels to them).

Tolerances:
- the ops (correlation, warps, channel norm, glues, upsamples): one bf16
  ulp, rtol 2**-7 with atol 1e-6 of the reference's largest magnitude; the
  share of elements that are not bit-equal is printed;
- against the TPU kernels in interpret mode: the tolerances of their own
  tests (tests/test_torch_ops.py, tests/test_pallas_kernels.py);
- the models: the JAX package's bf16 contract (tests/test_models.py,
  ``TestBf16Precision``), mean |got - want| < 0.05 (mean |want| + 1e-3)
  + 5e-3, with the relative L2 printed.

Weights come from JAX ``PRNGKey(0)`` inits carried across by
``from_jax_variables``; each JAX model compiles once per module.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flownet2_tpu import models as jax_models
from flownet2_tpu_torch import ops
from flownet2_tpu_torch.checkpoints import from_jax_variables
from flownet2_tpu_torch.losses import MultiScale
from flownet2_tpu_torch.models import MODELS, FlowNetC, get_model
from flownet2_tpu_torch.nn.layers import set_compute_dtype
from flownet2_tpu_torch.ops import (channelnorm, correlation, resample2d,
                                    stage_glue, upsample)
from flownet2_tpu_torch.train import StepFactory, get_optimizer

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)


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

H, W = 64, 128
BF16_ULP = 2.0 ** -7


def _bf16(shape, seed, scale=1.0):
    """Seeded normal values rounded to bf16, as float32 numpy (NHWC): both
    packages then start from the same bf16 values."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x).bfloat16().float().numpy()


def _jnp(x):
    return jnp.asarray(x, jnp.bfloat16)


def _nchw(x):
    """An NHWC float32 numpy array of bf16 values as an NCHW bf16 tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2))).bfloat16()


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _one_ulp(got, want, what):
    """Every element within one bf16 ulp of the reference."""
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 1e-6 * float(np.abs(want).max())
    diff = float(np.abs(got - want).max())
    print(f"{what}: max abs diff {diff:.3e}, not bit-equal "
          f"{np.mean(got != want):.4%}")
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=atol,
                               err_msg=what)


def _contract(got, want, what):
    """The JAX package's bf16 contract, with the relative L2 printed."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).mean()
    limit = 0.05 * (np.abs(want).mean() + 1e-3) + 5e-3
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{what}: mean error {err:.4g} against {limit:.4g}, relative L2 "
          f"{rel_l2:.3e}")
    assert np.isfinite(got).all()
    assert err < limit, (what, err, limit)


# ---------------------------------------------------------------- the ops

def test_bf16_correlation_matches_jax():
    """FlowNetC's configuration (441 channels) at a small map: float32
    products and sums of bf16 operands, rounded once."""
    f1, f2 = _bf16((1, 16, 32, 16), 0), _bf16((1, 16, 32, 16), 1)
    ops.reset_counts()
    got = correlation.correlation(_nchw(f1), _nchw(f2), 20, 1, 20, 1, 2)
    assert got.dtype == torch.bfloat16
    assert dict(ops.PLAIN_CALLS) == {"correlation": 1}
    want = jax_corr.correlation(_jnp(f1), _jnp(f2), 20, 1, 20, 1, 2)
    assert want.dtype == jnp.bfloat16
    _one_ulp(_nhwc(got), _f32(want), "correlation")


def test_bf16_correlation_matches_pallas_kernel_interpret():
    """Against the TPU kernel's bf16 form in interpret mode, at the
    tolerance of its f32 counterpart in tests/test_torch_ops.py."""
    f1, f2 = _bf16((1, 8, 16, 8), 4), _bf16((1, 8, 16, 8), 5)
    with pltpu.force_tpu_interpret_mode():
        want = jax_corr_pallas.correlation_pallas(_jnp(f1), _jnp(f2), 4, 4, 2)
    assert want.dtype == jnp.bfloat16
    got = correlation.correlation(_nchw(f1), _nchw(f2), 4, 1, 4, 1, 2)
    assert got.shape == (1, 25, 8, 16) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), _f32(want), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("scale", [3.0, 40.0])
def test_bf16_warp_matches_jax(scale):
    """One flow (within the image, and spilling past every edge): the
    float32 warp of the upcast image by the upcast flow, rounded once."""
    img, flow = _bf16((2, 24, 40, 3), 10), _bf16((2, 24, 40, 2), 11, scale)
    ops.reset_counts()
    got = resample2d.resample2d(_nchw(img), _nchw(flow))
    assert got.dtype == torch.bfloat16
    assert dict(ops.PLAIN_CALLS) == {"resample2d": 1}
    want = jax_r2d.resample2d(_jnp(img), _jnp(flow))
    assert want.dtype == jnp.bfloat16
    _one_ulp(_nhwc(got), _f32(want), f"warp, flow x{scale}")


def test_bf16_two_flow_warp_matches_jax():
    """The two-flow warp of the fusion glue against two JAX warps."""
    img = _bf16((2, 24, 40, 3), 12)
    flows = [_bf16((2, 24, 40, 2), 13 + k, 5.0) for k in range(2)]
    got = resample2d.resample2d_multi(
        _nchw(img), torch.stack([_nchw(f) for f in flows], dim=1))
    assert got.shape == (2, 2, 3, 24, 40) and got.dtype == torch.bfloat16
    for k, flow in enumerate(flows):
        want = jax_r2d.resample2d(_jnp(img), _jnp(flow))
        _one_ulp(_nhwc(got[:, k]), _f32(want), f"two-flow warp, flow {k}")


def test_bf16_warp_matches_pallas_kernel_interpret():
    """Against the TPU kernel's bf16 form (pair-packed planes) in interpret
    mode, with a bf16 flow, at the tolerance of its own bf16 test
    (tests/test_pallas_kernels.py)."""
    img, flow = _bf16((1, 16, 128, 3), 7), _bf16((1, 16, 128, 2), 8, 3.0)
    with pltpu.force_tpu_interpret_mode():
        want = jax_r2d_pallas.resample2d_bilinear_pallas(_jnp(img),
                                                         _jnp(flow))
    assert want.dtype == jnp.bfloat16
    got = resample2d.resample2d(_nchw(img), _nchw(flow))
    np.testing.assert_allclose(_nhwc(got), _f32(want), rtol=0.02, atol=0.02)


def test_bf16_channel_norm_matches_jax():
    """bf16 squares, a float32 sum, a bf16 result, in both packages."""
    x = _bf16((2, 16, 24, 5), 19, 3.0)
    got = channelnorm.channel_norm(_nchw(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 16, 24)
    want = jax_cn.channel_norm(_jnp(x))
    assert want.dtype == jnp.bfloat16
    _one_ulp(_nhwc(got), _f32(want), "channel norm")


def test_bf16_stage_glue_matches_jax():
    x, x2 = _bf16((1, 16, 24, 6), 20), _bf16((1, 16, 24, 3), 21)
    flow = _bf16((1, 16, 24, 2), 22, 5.0)
    got = stage_glue.stage_glue(_nchw(x), _nchw(x2), _nchw(flow), 20.0)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 12, 16, 24)
    want = jax_glue.stage_glue(_jnp(x), _jnp(x2), _jnp(flow), 20.0)
    assert want.dtype == jnp.bfloat16
    _one_ulp(_nhwc(got), _f32(want), "stage glue")


def test_bf16_fusion_glue_matches_jax():
    x1, x2 = _bf16((1, 16, 24, 3), 23), _bf16((1, 16, 24, 3), 24)
    sd, s2 = _bf16((1, 16, 24, 2), 25, 4.0), _bf16((1, 16, 24, 2), 26, 4.0)
    got = stage_glue.fusion_glue(_nchw(x1), _nchw(x2), _nchw(sd), _nchw(s2))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 11, 16, 24)
    want = jax_glue.fusion_glue(_jnp(x1), _jnp(x2), _jnp(sd), _jnp(s2))
    assert want.dtype == jnp.bfloat16
    _one_ulp(_nhwc(got), _f32(want), "fusion glue")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_bf16_upsample_matches_jax(mode):
    """torch's bf16 upsample computes in float32 and rounds once: one ulp
    of the JAX op on the upcast input, rounded once.  The JAX bf16 bilinear
    op rounds after each axis and each lerp term, which moves a result by
    up to an ulp of the inputs, not of the (possibly much smaller) result:
    it is held at one ulp of the largest magnitude.  Nearest copies."""
    x = _bf16((1, 8, 12, 2), 27, 10.0)
    port = {"bilinear": upsample.upsample_bilinear,
            "nearest": upsample.upsample_nearest}[mode]
    got = _nhwc(port(_nchw(x)))
    want = jax_up.upsample(_jnp(x), 4, mode)
    assert want.dtype == jnp.bfloat16
    if mode == "nearest":
        _one_ulp(got, _f32(want), "nearest upsample")
        return
    rounded = _f32(jax_up.upsample(jnp.asarray(x), 4, mode).astype(
        jnp.bfloat16))
    _one_ulp(got, rounded, "bilinear upsample, JAX f32 rounded once")
    want = _f32(want)
    print(f"bilinear upsample, JAX bf16: max abs diff "
          f"{np.abs(got - want).max():.3e}, largest magnitude "
          f"{np.abs(want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(want).max())


# ---------------------------------------------------------------- FlowNetC

def test_bf16_flownetc_matches_jax():
    """The sub-net that holds the correlation, on its five multi-scale
    outputs (training tuple; no BatchNorm, so train mode computes the
    inference forward)."""
    rng = np.random.RandomState(30)
    xs = [rng.randn(1, H, W, 3).astype(np.float32) for _ in range(2)]
    jm = jax_models.FlowNetC(dtype=jnp.bfloat16)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 *map(jnp.asarray, xs))
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, True))(
        variables, *map(jnp.asarray, xs))
    port = set_compute_dtype(FlowNetC(), torch.bfloat16).train()
    port.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables), "FlowNetC"),
        strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))) for x in xs))
    assert len(got) == len(want) == 5
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _contract(_nhwc(g), _f32(w), f"FlowNetC flow{k + 2}")


# ---------------------------------------------------------------- the models

MODEL_NAMES = ("FlowNet2", "FlowNet2C")


@pytest.fixture(scope="module", params=MODEL_NAMES)
def flows(request):
    """(name, {"jax" / "port": {"f32" / "bf16": flow}}) on one pair, both
    packages' models built from one JAX PRNGKey(0) init."""
    name = request.param
    pair = np.random.RandomState(0).rand(1, 2, H, W, 3).astype(
        np.float32) * 255.0
    out = {"jax": {}, "port": {}}
    variables = None
    for tag, jdt, tdt in (("f32", None, None),
                          ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = getattr(jax_models, name)(dtype=jdt)
        if variables is None:
            variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
                jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3))))
        out["jax"][tag] = _f32(jax.jit(jm.apply)(variables,
                                                 jnp.asarray(pair)))
        port = MODELS[name](dtype=tdt).eval()
        port.load_state_dict(from_jax_variables(variables, name),
                             strict=True)
        with torch.inference_mode():
            flow = port(torch.from_numpy(pair))
        assert flow.dtype == (tdt or torch.float32)
        out["port"][tag] = flow.float().numpy()
    return name, out


def test_bf16_model_matches_jax_bf16(flows):
    name, out = flows
    assert out["port"]["bf16"].shape == (1, H, W, 2)
    _contract(out["port"]["bf16"], out["jax"]["bf16"],
              f"{name}: port bf16 against JAX bf16")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_bf16_model_tracks_its_f32_model(flows, package):
    name, out = flows
    _contract(out[package]["bf16"], out[package]["f32"],
              f"{name}: {package} bf16 against {package} f32")


# ---------------------------------------------------------------- plumbing

@pytest.mark.parametrize("name", sorted(MODELS))
def test_get_model_bf16_keeps_float32_parameters(name):
    """Same state_dict keys as the float32 model, every parameter float32,
    bf16 flow out of the inference forward."""
    m32 = get_model(name, device="cpu", seed=1)
    m16 = get_model(name, device="cpu", seed=1, dtype=torch.bfloat16)
    s32, s16 = m32.state_dict(), m16.state_dict()
    assert list(s16) == list(s32)
    assert all(v.dtype == torch.float32 for v in s16.values())
    assert all(torch.equal(s16[k], s32[k]) for k in s32)
    pair = torch.from_numpy(np.random.RandomState(2).rand(
        1, 2, H, W, 3).astype(np.float32) * 255.0)
    with torch.inference_mode():
        flow = m16(pair)
    assert flow.dtype == torch.bfloat16 and flow.shape == (1, H, W, 2)
    assert torch.isfinite(flow.float()).all()


def test_one_state_dict_loads_into_both_dtypes():
    """A float32 model's state_dict loads, strict, into a bf16 model, which
    then computes what a bf16 model built with those weights computes."""
    state = get_model("FlowNet2C", device="cpu", seed=3).state_dict()
    loaded = get_model("FlowNet2C", device="cpu", seed=4,
                       dtype=torch.bfloat16)
    loaded.load_state_dict(state, strict=True)
    built = get_model("FlowNet2C", device="cpu", seed=3,
                      dtype=torch.bfloat16)
    pair = torch.from_numpy(np.random.RandomState(5).rand(
        1, 2, H, W, 3).astype(np.float32) * 255.0)
    with torch.inference_mode():
        assert torch.equal(loaded(pair), built(pair))


def test_bf16_train_step_and_inference_steps_serve():
    """A bf16 model's train step runs (float32 parameters and gradients,
    a float32 loss; tests/test_torch_bf16_train.py holds it against the
    JAX package), and its inference steps serve bf16 flow."""
    model = get_model("FlowNet2S", device="cpu", dtype=torch.bfloat16)
    factory = StepFactory(model, MultiScale(), get_optimizer("Adam", 1e-4))
    pair = torch.from_numpy(np.random.RandomState(6).rand(
        2, 2, H, W, 3).astype(np.float32) * 255.0)
    before = [p.detach().clone() for p in model.parameters()]
    metrics = factory.train_step()(pair, torch.zeros(2, H, W, 2))
    assert metrics["loss"].dtype == torch.float32
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["epe"])
    for p, b in zip(model.parameters(), before):
        assert p.dtype == p.grad.dtype == torch.float32
        assert not torch.equal(p.detach(), b)
    flow = factory.infer_step()(pair)
    assert flow.dtype == torch.bfloat16 and flow.shape == (2, H, W, 2)
    pred, sums = factory.infer_metrics_step()(pair, torch.zeros(2, H, W, 2),
                                              1)
    assert torch.equal(pred, flow) and sums["count"] == 1
    assert torch.isfinite(sums["epe_sum"])


def test_bf16_batch_norm_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        get_model("FlowNet2C", device="cpu", dtype=torch.bfloat16,
                  batch_norm=True)
