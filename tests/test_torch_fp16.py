"""The port's float16 model against the JAX package's fp16 model, on the
CPU, on the same seeded numpy inputs.

The JAX command line's ``--precision fp16`` builds its models with
``dtype=jnp.float16``: float32 parameters cast at use, the frames cast once
after normalisation, the convolutions, the glue and the warps in fp16, and
a train step with a static loss scale that skips non-finite updates.  Its
correlation sums the fp16 products in float32 and rounds once
(``ops/correlation.py``, ``preferred_element_type=float32``); its warp is
the XLA path, which casts the bilinear weights to fp16 and multiplies in
fp16.  The port follows its kernels' rule for both: the plain versions
(which the CUDA kernels are held to on the card, ``chip_smoke.py`` phases
2, 3c and 4c) upcast, compute in float32 and round once.

Tolerances:
- the correlation, forward and backward, whole map and one band against
  its halo slab: one fp16 ulp of the largest magnitude (atol 2**-10 of
  max |ref|, rtol 2**-10), since both packages sum in float32 and round
  once, in other orders (read: at most 0.39 of it, the backward and the
  band bit-equal);
- the warp's forward against the JAX XLA warp: four fp16 ulps of the
  largest magnitude (the JAX weights are rounded to fp16 and each of the
  four products is rounded, the port rounds once; read: 0.69 of one, with
  a third to a half of the values not bit-equal);
- against the TPU kernels in interpret mode (which upcast and sum in
  float32, as the port does): one fp16 ulp, at most 1% of the elements
  not bit-equal; K3's float32 tangents at 1e-6;
- the warp's fp16 flow gradient against the JAX XLA backward, which sums
  d_flow in fp16: 2e-3 in relative L2 (read: 5.2e-4 at flow x3, 3.6e-4
  at x40);
- the models: the JAX package's bf16 contract (``tests/test_models.py``
  ``TestBf16Precision``), mean |got - want| < 0.05 (mean |want| + 1e-3)
  + 5e-3, and the step's gradients per sub-net in relative L2 at the gates
  written beside their readings.

FlowNet2CS, the smallest wrapper that runs the correlation and the warp,
is the model here; the weights are the port's seeded init carried to the
JAX package by its own importer.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flownet2_tpu import losses as jax_losses
from flownet2_tpu import models as jax_models
from flownet2_tpu.checkpoints.torch_import import state_dict_to_variables

from flownet2_tpu_torch import losses, ops
from flownet2_tpu_torch.checkpoints import from_jax_variables
from flownet2_tpu_torch.models import get_model
from flownet2_tpu_torch.ops import (correlation, correlation_spatial,
                                    resample2d)
from flownet2_tpu_torch.train import StepFactory, get_optimizer

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)


def _jax_ops(name):
    # flownet2_tpu.ops re-exports functions under some of its module names
    return importlib.import_module(f"flownet2_tpu.ops.{name}")


jax_corr = _jax_ops("correlation")
jax_corr_spatial = _jax_ops("correlation_spatial")
jax_r2d = _jax_ops("resample2d")
jax_r2d_pallas = _jax_ops("resample2d_pallas")

H, W = 64, 128
FP16_ULP = 2.0 ** -10
ROUTES = ("grad_flow", "tangents")


def _fp16(shape, seed, scale=1.0):
    """Seeded normal values rounded to fp16, as float32 numpy (NHWC): both
    packages then start from the same fp16 values."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return x.astype(np.float16).astype(np.float32)


def _jnp(x):
    return jnp.asarray(x, jnp.float16)


def _nchw(x):
    """An NHWC float32 numpy array of fp16 values as an NCHW fp16 tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2))).half()


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got, want, what, ulps=1, flips=None):
    """Every element within ``ulps`` fp16 ulps of the largest magnitude of
    the reference (and rtol ``ulps`` * 2**-10); with ``flips``, at most
    that share of the elements not bit-equal."""
    assert got.shape == want.shape, (got.shape, want.shape)
    top = float(np.abs(want).max())
    assert top > 0, what
    share = float(np.mean(got != want))
    diff = float(np.abs(got - want).max())
    print(f"{what}: max abs diff {diff:.3e} ({diff / (top * FP16_ULP):.2f} "
          f"ulp of the largest magnitude), not bit-equal {share:.4%}")
    np.testing.assert_allclose(got, want, rtol=ulps * FP16_ULP,
                               atol=ulps * FP16_ULP * top, err_msg=what)
    if flips is not None:
        assert share <= flips, f"{what}: {share:.2%} of the elements differ"


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _contract(got, want, what):
    """The JAX package's bf16 contract, with the relative L2 printed."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).mean()
    limit = 0.05 * (np.abs(want).mean() + 1e-3) + 5e-3
    print(f"{what}: mean error {err:.4g} against {limit:.4g}, relative L2 "
          f"{_rel_l2(got, want):.3e}")
    assert np.isfinite(got).all()
    assert err < limit, (what, err, limit)


# ------------------------------------------------------- the correlation

CORR_CASES = [(20, 2, (1, 24, 32, 16)), (4, 2, (1, 20, 64, 12))]


@pytest.mark.parametrize("maxd,s2,shape", CORR_CASES)
def test_fp16_correlation_matches_jax(maxd, s2, shape):
    """The cost volume of fp16 f1, f2 (FlowNetC's configuration and
    another): float32 sums of the upcast products, rounded once to fp16,
    against the JAX package's correlation in fp16."""
    f1, f2 = _fp16(shape, 0), _fp16(shape, 1)
    ops.reset_counts()
    got = correlation.correlation(_nchw(f1), _nchw(f2), maxd, 1, maxd, 1,
                                  s2)
    assert got.dtype == torch.float16
    assert dict(ops.PLAIN_CALLS) == {"correlation": 1}
    want = jax_corr.correlation(_jnp(f1), _jnp(f2), maxd, 1, maxd, 1, s2)
    assert want.dtype == jnp.float16
    _ulps(_nhwc(got), _f32(want), f"correlation, maxd {maxd}")


@pytest.mark.parametrize("maxd,s2,shape", CORR_CASES)
def test_fp16_correlation_bwd_plain_matches_jax_vjp(maxd, s2, shape):
    """fp16 g, f1, f2: float32 sums of the upcast operands, divided by C
    and rounded once to fp16, as the JAX package's ``_corr_bwd``."""
    f1, f2 = _fp16(shape, 40), _fp16(shape, 41)
    disp = 2 * (maxd // s2) + 1
    g = _fp16(shape[:3] + (disp * disp,), 42)
    ops.reset_counts()
    got = correlation.correlation_bwd_plain(_nchw(g), _nchw(f1), _nchw(f2),
                                            maxd, s2)
    assert dict(ops.PLAIN_CALLS) == {"correlation_bwd": 1}
    _, vjp = jax.vjp(jax.jit(lambda a, b: jax_corr.correlation(
        a, b, maxd, 1, maxd, 1, s2, impl="mxu")), _jnp(f1), _jnp(f2))
    for k, (mine, ref) in enumerate(zip(got, vjp(_jnp(g)))):
        assert mine.dtype == torch.float16 and ref.dtype == jnp.float16
        _ulps(_nhwc(mine), _f32(ref), f"d_f{k + 1}, maxd {maxd}")


@pytest.mark.parametrize("band", ["top", "bottom"])
def test_fp16_corr_slab_and_grads_match_jax(band):
    """One band of four of a 16-row map against its halo slab (K7's plain
    versions), fp16: the output and both gradients against the JAX
    package's ``_corr_slab`` and ``jax.vjp`` of it in fp16."""
    maxd, s2 = 20, 2
    height, width, chans, local_h = 16, 24, 8, 4
    off = {"top": 0, "bottom": 12}[band]
    f1 = _fp16((2, height, width, chans), 1)
    f2 = _fp16((2, height, width, chans), 2)
    f1_loc = f1[:, off:off + local_h]
    slab = np.pad(f2, ((0, 0), (maxd, maxd), (0, 0), (0, 0)))[
        :, off:off + local_h + 2 * maxd]
    g = _fp16((2, local_h, width, 21 * 21), 3)
    want, vjp = jax.vjp(
        lambda a, b: jax_corr_spatial._corr_slab(a, b, maxd, s2),
        _jnp(f1_loc), _jnp(slab))
    want1, want_slab = vjp(_jnp(g))
    assert want.dtype == want1.dtype == want_slab.dtype == jnp.float16
    t1 = _nchw(f1_loc).requires_grad_()
    t_slab = _nchw(slab).requires_grad_()
    ops.reset_counts()
    got = correlation_spatial.corr_slab(t1, t_slab, maxd, s2)
    got.backward(_nchw(g))
    assert dict(ops.PLAIN_CALLS) == {"corr_slab": 1, "corr_slab_bwd": 1}
    for t in (got, t1.grad, t_slab.grad):
        assert t.dtype == torch.float16
    _ulps(_nhwc(got), _f32(want), f"{band} band, out")
    _ulps(_nhwc(t1.grad), _f32(want1), f"{band} band, d_f1")
    _ulps(_nhwc(t_slab.grad), _f32(want_slab), f"{band} band, d_slab")


# ------------------------------------------------------------- the warps

@pytest.mark.parametrize("scale", [3.0, 40.0])
def test_fp16_warp_matches_jax(scale):
    """One flow and two flows (within the image, and spilling past every
    edge): the float32 warp of the upcast image by the upcast flows,
    rounded once, against the JAX XLA warp in fp16."""
    img = _fp16((2, 24, 40, 3), 10)
    flows = [_fp16((2, 24, 40, 2), 11 + k, scale) for k in range(2)]
    ops.reset_counts()
    one = resample2d.resample2d(_nchw(img), _nchw(flows[0]))
    two = resample2d.resample2d_multi(
        _nchw(img), torch.stack([_nchw(f) for f in flows], dim=1))
    assert one.dtype == two.dtype == torch.float16
    assert dict(ops.PLAIN_CALLS) == {"resample2d": 1, "resample2d_multi": 1}
    for k, flow in enumerate(flows):
        want = jax_r2d.resample2d(_jnp(img), _jnp(flow))
        assert want.dtype == jnp.float16
        if k == 0:
            _ulps(_nhwc(one), _f32(want), f"warp, flow x{scale}", ulps=4)
        _ulps(_nhwc(two[:, k]), _f32(want),
              f"two-flow warp, flow {k}, x{scale}", ulps=4)


def _warp_inputs(nflows, seed):
    """An fp16 image (2, 16, 128, 3) and ``nflows`` fp16 flows of +-4 px
    (NHWC numpy), the tile-aligned shape of the Pallas kernels."""
    img = _fp16((2, 16, 128, 3), seed)
    flows = [np.clip(_fp16((2, 16, 128, 2), seed + 1 + k, 2.0), -4, 4)
             for k in range(nflows)]
    return img, flows


def _flows_nchw(flows):
    return torch.stack([_nchw(f) for f in flows], dim=1)


def test_fp16_tangents_plain_matches_pallas_kernel_interpret():
    """K3's plain version on an fp16 image and flows: ``out`` fp16 within
    one ulp, d1 and d2 float32 at 1e-6, against the TPU kernel for one flow
    and its two-flow channel-major form in interpret mode."""
    img, flows = _warp_inputs(2, 60)
    out, d1, d2 = resample2d.resample2d_tangents_plain(_nchw(img),
                                                       _flows_nchw(flows))
    assert out.dtype == torch.float16
    assert d1.dtype == d2.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        one = jax_r2d_pallas.resample2d_bilinear_tangents_pallas(
            _jnp(img), _jnp(flows[0]))
        two = jax_r2d_pallas.resample2d_bilinear_tangents_cm_multi(
            _jnp(img), jnp.stack([_jnp(f) for f in flows], axis=1))
    assert one[0].dtype == jnp.float16 and one[1].dtype == jnp.float32
    _ulps(_nhwc(out[:, 0]), _f32(one[0]), "tangents out, one flow",
          flips=0.01)
    for k in range(2):
        _ulps(_nhwc(out[:, k]), _f32(two[0][:, k]),
              f"tangents out, flow {k} of two", flips=0.01)
    for name, mine, k1, cm in (("d1", d1, one[1], two[2]),
                               ("d2", d2, one[2], two[3])):
        np.testing.assert_allclose(_nhwc(mine[:, 0]), np.asarray(k1),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        cm = np.asarray(cm)[..., :16, :128]
        np.testing.assert_allclose(mine.numpy(), cm, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name}, two flows")


@pytest.mark.parametrize("nflows", [1, 2])
def test_fp16_grad_flow_plain_matches_pallas_kernel_interpret(nflows):
    """K4's plain version on an fp16 image, flow and cotangent: the float32
    flow gradient rounded once to fp16, against the TPU kernel (which
    upcasts and returns f32) cast to fp16."""
    img, flows = _warp_inputs(nflows, 50)
    g = [_fp16((2, 16, 128, 3), 55 + k) for k in range(nflows)]
    got = resample2d.resample2d_grad_flow_plain(
        torch.stack([_nchw(x) for x in g], dim=1), _nchw(img),
        _flows_nchw(flows))
    assert got.dtype == torch.float16 and got.shape == (2, nflows, 2, 16,
                                                        128)
    for k in range(nflows):
        with pltpu.force_tpu_interpret_mode():
            want = jax_r2d_pallas.resample2d_grad_flow_pallas(
                _jnp(g[k]), _jnp(img), _jnp(flows[k]))
        assert want.dtype == jnp.float32
        _ulps(_nhwc(got[:, k]), _f32(want.astype(jnp.float16)),
              f"flow gradient, flow {k} of {nflows}", flips=0.01)


@pytest.mark.parametrize("scale", [3.0, 40.0])
def test_fp16_warp_flow_gradient_by_both_routes_matches_jax_xla(scale):
    """The flow gradient of an fp16 warp by the generic route (K4's plain
    version) and the tangent route (K3's float32 tangents, summed in
    float32): fp16, equal to one ulp, and within 2e-3 in relative L2 of
    the JAX package's XLA backward, which sums d_flow in fp16."""
    img = _fp16((2, 16, 24, 3), 70)
    flow = _fp16((2, 16, 24, 2), 71, scale)
    g = _fp16((2, 16, 24, 3), 72)
    grads = {}
    for route in ROUTES:
        leaf = _nchw(flow).unsqueeze(1).requires_grad_()
        warp = (resample2d.resample2d_tangents if route == "tangents"
                else resample2d.resample2d_multi)
        out = warp(_nchw(img), leaf)
        assert out.dtype == torch.float16
        out.backward(_nchw(g).unsqueeze(1))
        assert leaf.grad.dtype == torch.float16
        grads[route] = _nhwc(leaf.grad[:, 0])
    _ulps(grads["tangents"], grads["grad_flow"], "tangent route against the "
          "generic route")
    _, vjp = jax.vjp(lambda f: jax_r2d.resample2d(_jnp(img), f), _jnp(flow))
    (want,) = vjp(_jnp(g))
    assert want.dtype == jnp.float16
    for route, got in grads.items():
        rel = _rel_l2(got, _f32(want))
        print(f"{route} route against the JAX XLA backward, flow x{scale}: "
              f"relative L2 {rel:.3e}")
        assert rel <= 2e-3, (route, rel)


# --------------------------------------------------------------- the model

def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, 2, H, W, 3).astype(np.float32) * 255.0,
            rng.rand(1, H, W, 2).astype(np.float32) * 5.0)


LOSS_SCALE = 128.0


@pytest.fixture(scope="module")
def flownet2cs():
    """FlowNet2CS of the port's seeded weights in both packages: the fp16
    and float32 inference flows, and one MultiScale step of the fp16 model
    at loss scale 128 (the JAX StepFactory's: the loss times the scale,
    the gradients divided by it)."""
    name = "FlowNet2CS"
    made = get_model(name, device="cpu", seed=0)
    variables = state_dict_to_variables(
        {k: v.numpy() for k, v in made.state_dict().items()}, name)
    pair = np.random.RandomState(5).rand(1, 2, H, W, 3).astype(
        np.float32) * 255.0
    images, flow = _batch(6)
    out = {}
    for tag, jdt, tdt in (("f32", None, None),
                          ("fp16", jnp.float16, torch.float16)):
        jm = getattr(jax_models, name)(dtype=jdt)
        out[f"jax {tag}"] = _f32(jax.jit(jm.apply)(variables,
                                                   jnp.asarray(pair)))
        port = get_model(name, device="cpu", dtype=tdt)
        port.load_state_dict(from_jax_variables(variables, name),
                             strict=True)
        with torch.inference_mode():
            got = port(torch.from_numpy(pair))
        assert got.dtype == (tdt or torch.float32)
        out[f"port {tag}"] = got.float().numpy()

    jm = jax_models.FlowNet2CS(dtype=jnp.float16)

    def scaled_loss(params):
        flows = jm.apply({"params": params}, jnp.asarray(images),
                         training=True)
        lossvalue, epevalue = jax_losses.MultiScale()(flows,
                                                      jnp.asarray(flow))
        return lossvalue * LOSS_SCALE, (lossvalue, epevalue)

    grads, (j_loss, j_epe) = jax.jit(jax.grad(scaled_loss, has_aux=True))(
        variables["params"])
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g / LOSS_SCALE),
                                   grads)
    out["jax step"] = (float(j_loss), float(j_epe), {
        k: v.numpy() for k, v in from_jax_variables({"params": grads},
                                                    name).items()})
    model = get_model(name, device="cpu", dtype=torch.float16)
    model.load_state_dict(from_jax_variables(variables, name), strict=True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("Adam", 1e-4), loss_scale=LOSS_SCALE,
                          skip_nonfinite_updates=True)
    ops.reset_counts()
    metrics = factory.train_step()(torch.from_numpy(images),
                                   torch.from_numpy(flow))
    out["port step"] = (model, metrics, before, dict(ops.PLAIN_CALLS),
                        factory.skipped_updates)
    return out


def test_fp16_flownet2cs_forward_matches_jax_fp16(flownet2cs):
    """The fp16 flow within the bf16 contract of the JAX fp16 model's, and
    of the float32 models' (both packages' fp16 models track their float32
    ones alike)."""
    out = flownet2cs
    assert out["port fp16"].shape == (1, H, W, 2)
    np.testing.assert_allclose(out["port f32"], out["jax f32"], rtol=1e-3,
                               atol=1e-3)
    _contract(out["port fp16"], out["jax fp16"], "port fp16 against JAX fp16")
    for package in ("port", "jax"):
        _contract(out[f"{package} fp16"], out[f"{package} f32"],
                  f"{package} fp16 against its f32 model")


# FlowNet2CS, per sub-net, port fp16 against JAX fp16 at loss scale 128
# (the CPU readings at 64x128 in brackets): flownets_1 at 1e-2 [1.8e-3];
# flownetc only below 0.5 [0.15]: its gradient reaches it through the first
# warp's flow gradient, which jumps where a sample point crosses an integer,
# and two fp16 forwards differ in the last bit (the noise line, ROADMAP.md,
# section 3; the bf16 FlowNet2 step reads 0.49 there,
# tests/test_torch_bf16_train.py).  The loss [3.2e-5 relative] at 2e-3.
STEP_GATES = {"flownetc": 0.5, "flownets_1": 1e-2}
STEP_LOSS_RTOL = 2e-3


def test_fp16_flownet2cs_train_step_matches_jax(flownet2cs):
    """One fp16 step at loss scale 128: the loss unscaled and within 2e-3
    relative of the JAX fp16 step's, no update skipped, the parameters
    float32 and moved, each sub-net's float32 gradients within its gate in
    relative L2."""
    j_loss, j_epe, want = flownet2cs["jax step"]
    model, metrics, before, calls, skipped = flownet2cs["port step"]
    assert calls == {"correlation": 1, "correlation_bwd": 1, "resample2d": 1,
                     "resample2d_grad_flow": 1}
    assert skipped == 0 and metrics["skipped"].item() == 0.0
    print(f"loss: port {metrics['loss'].item():.6f}, JAX {j_loss:.6f}")
    np.testing.assert_allclose(metrics["loss"].item(), j_loss,
                               rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(metrics["epe"].item(), j_epe,
                               rtol=STEP_LOSS_RTOL)
    got = {}
    for n, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, n
        assert not torch.equal(p.detach(), before[n]), n
        got[n] = p.grad.numpy()
    assert set(got) == set(want)
    beyond = {}
    for subnet, gate in STEP_GATES.items():
        names = [n for n in want if n.split(".")[0] == subnet]
        rel = (sum(float(np.sum((got[n].astype(np.float64) - want[n]) ** 2))
                   for n in names)
               / sum(float(np.sum(want[n].astype(np.float64) ** 2))
                     for n in names)) ** 0.5
        print(f"{subnet}: port fp16 against JAX fp16 {rel:.3e} (gate "
              f"{gate:g})")
        if rel > gate:
            beyond[subnet] = rel
    assert not beyond, beyond


def test_fp16_step_skips_a_nonfinite_update():
    """A loss scale that overflows fp16 in the backward: the step leaves
    the parameters and the optimizer's count alone, says so in its
    metrics, and counts it; the next step at a sane scale updates."""
    model = get_model("FlowNet2S", device="cpu", dtype=torch.float16)
    images, flow = _batch(8)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("Adam", 1e-4), loss_scale=1e30,
                          skip_nonfinite_updates=True)
    metrics = factory.train_step()(torch.from_numpy(images),
                                   torch.from_numpy(flow))
    assert metrics["skipped"].item() == 1.0 and factory.skipped_updates == 1
    assert torch.isfinite(metrics["loss"])
    assert factory.optimizer.count == 0
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    factory.loss_scale = 128.0
    metrics = factory.train_step()(torch.from_numpy(images),
                                   torch.from_numpy(flow))
    assert metrics["skipped"].item() == 0.0 and factory.skipped_updates == 1
    assert factory.optimizer.count == 1
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters())
