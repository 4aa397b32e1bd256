"""The port's bfloat16 train step against the JAX package's bf16 model, on
the CPU, on the same seeded numpy inputs.

The JAX package trains a bf16 model (``dtype=jnp.bfloat16``) with float32
parameters as the master weights: its layers cast them at use, so their
gradients come back float32, the MultiScale loss compares the bf16 flow
with the float32 target in float32, and the optimizer steps in float32.
Its backward ops upcast bf16 operands, sum in float32 and round once: the
correlation's ``_corr_bwd``, and the Pallas warp kernels, whose tangents
d1, d2 stay float32 (``resample2d_pallas.py``).  The port's plain backward
versions do the same, and the CUDA kernels are held to them on the card
(``chip_smoke.py``, phases 2 and 4b).

Tolerances:
- the ops: one bf16 ulp (rtol 2**-7, atol 1e-6 of the reference's largest
  magnitude) and at most 1% of the elements not bit-equal; K3's float32
  tangents at 1e-6;
- the warp's bf16 flow gradient against the JAX package's XLA path: 1e-2
  in relative L2 (that path rounds in bf16 as it sums, the kernels do
  not);
- the slice: the loss in relative terms, the gradients in relative L2 per
  layer (FlowNet2C) or per sub-net (FlowNet2), each gate written beside
  the reading it was set from.  Two bf16 forwards that differ in the last
  bit differ by percents in their gradients: the warps' flow gradient
  jumps where a sample point crosses an integer, and a bf16 flow of
  magnitude 16-32 has an ulp of 0.125 (ROADMAP.md, section 3, "the noise
  line").

Weights come from the port's seeded init carried to the JAX package by
its own importer, as ``tests/test_torch_train.py`` does.
"""

import importlib
from unittest import mock

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
from flownet2_tpu_torch.ops import correlation, resample2d, stage_glue
from flownet2_tpu_torch.train import StepFactory, get_optimizer

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)


def _jax_ops(name):
    # flownet2_tpu.ops re-exports functions under some of its module names
    return importlib.import_module(f"flownet2_tpu.ops.{name}")


jax_corr = _jax_ops("correlation")
jax_corr_pallas = _jax_ops("correlation_pallas")
jax_r2d = _jax_ops("resample2d")
jax_r2d_pallas = _jax_ops("resample2d_pallas")

H, W = 64, 128
BF16_ULP = 2.0 ** -7
ROUTES = ("grad_flow", "tangents")


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
    """Every element within one bf16 ulp of the reference, at most 1% of
    them not bit-equal."""
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 1e-6 * float(np.abs(want).max())
    flips = float(np.mean(got != want))
    print(f"{what}: max abs diff {np.abs(got - want).max():.3e}, not "
          f"bit-equal {flips:.4%}")
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=atol,
                               err_msg=what)
    assert flips <= 0.01, f"{what}: {flips:.2%} of the elements differ"


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------- the correlation backward

@pytest.mark.parametrize("maxd,s2,shape", [(4, 2, (1, 12, 20, 64)),
                                           (20, 2, (1, 16, 24, 32))])
def test_bf16_correlation_bwd_plain_matches_jax_vjp(maxd, s2, shape):
    """bf16 g, f1, f2: float32 sums of the upcast operands, divided by C
    and rounded once to bf16, as the JAX package's ``_corr_bwd``."""
    f1, f2 = _bf16(shape, 40), _bf16(shape, 41)
    disp = 2 * (maxd // s2) + 1
    g = _bf16(shape[:3] + (disp * disp,), 42)
    ops.reset_counts()
    got = correlation.correlation_bwd_plain(_nchw(g), _nchw(f1), _nchw(f2),
                                            maxd, s2)
    assert dict(ops.PLAIN_CALLS) == {"correlation_bwd": 1}
    _, vjp = jax.vjp(jax.jit(lambda a, b: jax_corr.correlation(
        a, b, maxd, 1, maxd, 1, s2, impl="mxu")), _jnp(f1), _jnp(f2))
    for k, (mine, ref) in enumerate(zip(got, vjp(_jnp(g)))):
        assert mine.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        _one_ulp(_nhwc(mine), _f32(ref), f"d_f{k + 1}, maxd {maxd}")


def test_bf16_correlation_bwd_plain_matches_pallas_kernel_interpret():
    """Against the TPU kernels K5, K6 in interpret mode on bf16 operands
    (bf16 products, f32 sums, f32 out), cast to bf16 as the JAX package's
    op casts them (``ops/correlation.py:296``)."""
    maxd, s2 = 4, 2
    f1, f2 = _bf16((1, 8, 16, 32), 43), _bf16((1, 8, 16, 32), 44)
    g = _bf16((1, 8, 16, 25), 45)
    with pltpu.force_tpu_interpret_mode():
        want = jax_corr_pallas.correlation_pallas_bwd(
            _jnp(g), _jnp(f1), _jnp(f2), maxd, maxd, s2)
    got = correlation.correlation_bwd_plain(_nchw(g), _nchw(f1), _nchw(f2),
                                            maxd, s2)
    for k, (mine, ref) in enumerate(zip(got, want)):
        assert ref.dtype == jnp.float32
        _one_ulp(_nhwc(mine), _f32(ref.astype(jnp.bfloat16)),
                 f"d_f{k + 1} against the TPU kernel")


# ------------------------------------------------------------- the warps

def _warp_inputs(nflows, seed):
    """A bf16 image (2, 16, 128, 3) and ``nflows`` bf16 flows of +-4 px
    (NHWC numpy), the tile-aligned shape of the Pallas kernels."""
    img = _bf16((2, 16, 128, 3), seed)
    flows = [np.clip(_bf16((2, 16, 128, 2), seed + 1 + k, 2.0), -4, 4)
             for k in range(nflows)]
    return img, flows


def _flows_nchw(flows):
    return torch.stack([_nchw(f) for f in flows], dim=1)


@pytest.mark.parametrize("nflows", [1, 2])
def test_bf16_grad_flow_plain_matches_pallas_kernel_interpret(nflows):
    """K4's plain version on a bf16 image, flow and cotangent: the float32
    flow gradient rounded once to bf16, against the TPU kernel (which
    upcasts the cotangent and returns f32) cast to bf16."""
    img, flows = _warp_inputs(nflows, 50)
    g = [_bf16((2, 16, 128, 3), 55 + k) for k in range(nflows)]
    got = resample2d.resample2d_grad_flow_plain(
        torch.stack([_nchw(x) for x in g], dim=1), _nchw(img),
        _flows_nchw(flows))
    assert got.dtype == torch.bfloat16 and got.shape == (2, nflows, 2, 16,
                                                          128)
    for k in range(nflows):
        with pltpu.force_tpu_interpret_mode():
            want = jax_r2d_pallas.resample2d_grad_flow_pallas(
                _jnp(g[k]), _jnp(img), _jnp(flows[k]))
        assert want.dtype == jnp.float32
        _one_ulp(_nhwc(got[:, k]), _f32(want.astype(jnp.bfloat16)),
                 f"flow gradient, flow {k} of {nflows}")


def test_bf16_tangents_plain_matches_pallas_kernel_interpret():
    """K3's plain version on a bf16 image and flows: ``out`` bf16 within
    one ulp, d1 and d2 float32 at 1e-6, against the TPU kernel for one flow
    and its two-flow channel-major form."""
    img, flows = _warp_inputs(2, 60)
    out, d1, d2 = resample2d.resample2d_tangents_plain(_nchw(img),
                                                       _flows_nchw(flows))
    assert out.dtype == torch.bfloat16
    assert d1.dtype == d2.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        one = jax_r2d_pallas.resample2d_bilinear_tangents_pallas(
            _jnp(img), _jnp(flows[0]))
        two = jax_r2d_pallas.resample2d_bilinear_tangents_cm_multi(
            _jnp(img), jnp.stack([_jnp(f) for f in flows], axis=1))
    assert one[0].dtype == jnp.bfloat16 and one[1].dtype == jnp.float32
    _one_ulp(_nhwc(out[:, 0]), _f32(one[0]), "tangents out, one flow")
    for k in range(2):
        _one_ulp(_nhwc(out[:, k]), _f32(two[0][:, k]),
                 f"tangents out, flow {k} of two")
    for name, mine, k1, cm in (("d1", d1, one[1], two[2]),
                               ("d2", d2, one[2], two[3])):
        np.testing.assert_allclose(_nhwc(mine[:, 0]), np.asarray(k1),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        cm = np.asarray(cm)[..., :16, :128]
        np.testing.assert_allclose(mine.numpy(), cm, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name}, two flows")


@pytest.mark.parametrize("scale", [3.0, 40.0])
def test_bf16_warp_flow_gradient_by_both_routes_matches_jax_xla(scale):
    """The flow gradient of a bf16 warp by the generic route (K4's plain
    version) and the tangent route (K3's float32 tangents, summed in
    float32): bf16, equal to one ulp, and within 1e-2 in relative L2 of
    the JAX package's XLA backward on the CPU (4.1e-3 read at flow x3)."""
    img = _bf16((2, 16, 24, 3), 70)
    flow = _bf16((2, 16, 24, 2), 71, scale)
    g = _bf16((2, 16, 24, 3), 72)
    grads = {}
    for route in ROUTES:
        leaf = _nchw(flow).unsqueeze(1).requires_grad_()
        warp = (resample2d.resample2d_tangents if route == "tangents"
                else resample2d.resample2d_multi)
        out = warp(_nchw(img), leaf)
        assert out.dtype == torch.bfloat16
        out.backward(_nchw(g).unsqueeze(1))
        assert leaf.grad.dtype == torch.bfloat16
        grads[route] = _nhwc(leaf.grad[:, 0])
    _one_ulp(grads["tangents"], grads["grad_flow"], "tangent route against "
             "the generic route")
    _, vjp = jax.vjp(lambda f: jax_r2d.resample2d(_jnp(img), f),
                     _jnp(flow))
    (want,) = vjp(_jnp(g))
    assert want.dtype == jnp.bfloat16
    for route, got in grads.items():
        rel = _rel_l2(got, _f32(want))
        print(f"{route} route against the JAX XLA backward, flow x{scale}: "
              f"relative L2 {rel:.3e}")
        assert rel <= 1e-2, (
            f"{route}: {rel:.2e} in relative L2 against the JAX XLA warp "
            "backward, which casts the weights and corners to bf16 and sums "
            "d_flow in bf16; the port (as the TPU kernel) sums in f32 and "
            "rounds once")


# ------------------------------------------------------------- the slice

def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, 2, H, W, 3).astype(np.float32) * 255.0,
            rng.rand(1, H, W, 2).astype(np.float32) * 5.0)


def _jax_step(name, variables, images, flow, dtype):
    """Loss, EPE and the float32 gradients of one JAX MultiScale step of
    ``name`` at ``dtype``, as port state_dict-keyed numpy arrays."""
    jm = getattr(jax_models, name)(dtype=dtype)

    def loss(params):
        out = jm.apply({"params": params}, jnp.asarray(images),
                       training=True)
        return jax_losses.MultiScale()(out, jnp.asarray(flow))

    (j_loss, j_epe), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(g.dtype == jnp.float32 for g in leaves)
    return float(j_loss), float(j_epe), {
        k: v.numpy() for k, v in from_jax_variables(
            {"params": jax.tree_util.tree_map(np.asarray, grads)},
            name).items()}


def _port_step(name, variables, images, flow, route="grad_flow",
               bwd=None):
    """One port train step of the bf16 model ``name`` on the JAX
    variables, by warp ``route``; ``bwd`` replaces the plain correlation
    backward.  Returns the model, its metrics, its parameters before the
    step and the plain-op calls."""
    model = get_model(name, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(from_jax_variables(variables, name), strict=True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = StepFactory(model, losses.MultiScale(),
                       get_optimizer("Adam", 1e-4)).train_step()
    ops.reset_counts()
    with mock.patch.object(stage_glue, "TRAIN_WARP", route), \
            mock.patch.object(correlation, "correlation_bwd_plain",
                              bwd or correlation.correlation_bwd_plain):
        metrics = step(torch.from_numpy(images), torch.from_numpy(flow))
    return model, metrics, before, dict(ops.PLAIN_CALLS)


def _grads(model) -> dict:
    grads = {}
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        assert p.grad.dtype == torch.float32, (n, p.grad.dtype)
        grads[n] = p.grad.numpy()
    return grads


def _group_rel(got: dict, want: dict, key) -> dict:
    """Relative L2 of the gradients grouped by ``key(name)``."""
    out = {}
    for group in sorted({key(n) for n in want}):
        names = [n for n in want if key(n) == group]
        diff = sum(float(np.sum((got[n].astype(np.float64) - want[n]) ** 2))
                   for n in names)
        norm = sum(float(np.sum(want[n].astype(np.float64) ** 2))
                   for n in names)
        out[group] = (diff / max(norm, 1e-60)) ** 0.5
    return out


def _layer(name: str) -> str:
    """A parameter's layer: its name without ``.weight`` / ``.bias``."""
    return name.rsplit(".", 1)[0]


# FlowNet2C, per layer, port bf16 against JAX bf16 (the CPU reading at 64x128
# in brackets): every layer at 7e-2 [1.9e-3 to 3.1e-2], but conv1 at 0.3
# [0.137] and upsampled_flow3_to_2 at 0.15 [7.4e-2], the layers nearest the
# frames and the finest flow
FLOWNETC_GATE = 7e-2
FLOWNETC_LAYER_GATES = {"conv1.0": 0.3, "upsampled_flow3_to_2": 0.15}
FLOWNETC_LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def flownetc_run():
    made = get_model("FlowNet2C", device="cpu", seed=0)
    variables = state_dict_to_variables(
        {k: v.numpy() for k, v in made.state_dict().items()}, "FlowNet2C")
    images, flow = _batch(3)
    return {"variables": variables, "batch": (images, flow),
            "jax": _jax_step("FlowNet2C", variables, images, flow,
                             jnp.bfloat16),
            "port": _port_step("FlowNet2C", variables, images, flow)}


def _flownetc_layers_beyond_gate(got: dict, want: dict) -> list:
    rel = _group_rel(got, want, _layer)
    for layer, r in rel.items():
        print(f"FlowNet2C {layer}: {r:.3e}")
    return [layer for layer, r in rel.items()
            if r > FLOWNETC_LAYER_GATES.get(layer, FLOWNETC_GATE)]


def test_bf16_flownet2c_train_step_matches_jax(flownetc_run):
    """Loss at 1e-3 relative; every gradient float32; each layer's
    gradients within its gate in relative L2."""
    j_loss, j_epe, want = flownetc_run["jax"]
    model, metrics, _, calls = flownetc_run["port"]
    assert calls == {"correlation": 1, "correlation_bwd": 1}
    print(f"loss: port {metrics['loss'].item():.6f}, JAX {j_loss:.6f}")
    np.testing.assert_allclose(metrics["loss"].item(), j_loss,
                               rtol=FLOWNETC_LOSS_RTOL)
    np.testing.assert_allclose(metrics["epe"].item(), j_epe,
                               rtol=FLOWNETC_LOSS_RTOL)
    got = _grads(model)
    assert set(got) == set(want)
    assert _flownetc_layers_beyond_gate(got, want) == []


def test_bf16_flownet2c_gate_catches_a_wrong_correlation_backward(
        flownetc_run):
    """The per-layer gate can fail: with the port's correlation backward
    doubled, conv3, whose output the correlation takes, moves beyond it
    (read on the CPU: 9.8e-2 against 8.3e-3), and no other layer does.  The
    correlation is a small share of the gradient further up: conv2 moves
    from 6.0e-3 to 1.3e-2, conv1 from 0.137 to 0.141, both inside their
    gates."""
    plain = correlation.correlation_bwd_plain

    def doubled(*args, **kwargs):
        return tuple(None if d is None else 2 * d
                     for d in plain(*args, **kwargs))

    model = _port_step("FlowNet2C", flownetc_run["variables"],
                       *flownetc_run["batch"], bwd=doubled)[0]
    beyond = _flownetc_layers_beyond_gate(_grads(model),
                                          flownetc_run["jax"][2])
    assert beyond == ["conv3.0"], beyond


# FlowNet2, per sub-net, port bf16 against JAX bf16 (the CPU readings at
# 64x128 in brackets): flownets_2, flownets_d and flownetfusion at 5e-2
# [1.2e-2, 5.9e-3, 4.6e-3]; flownetc and flownets_1 only below 1.0 [0.49,
# 0.51]: they sit on the noise line, where the JAX package's own bf16 step
# reads 1.20 and 1.45 against its f32 step.
FLOWNET2_GATES = {"flownets_2": 5e-2, "flownets_d": 5e-2,
                  "flownetfusion": 5e-2, "flownetc": 1.0, "flownets_1": 1.0}
FLOWNET2_LOSS_RTOL = 2e-3


@pytest.fixture(scope="module")
def flownet2_run():
    made = get_model("FlowNet2", device="cpu", seed=0)
    variables = state_dict_to_variables(
        {k: v.numpy() for k, v in made.state_dict().items()}, "FlowNet2")
    images, flow = _batch(3)
    return {"jax": _jax_step("FlowNet2", variables, images, flow,
                             jnp.bfloat16),
            "jax_f32": _jax_step("FlowNet2", variables, images, flow, None),
            **{route: _port_step("FlowNet2", variables, images, flow, route)
               for route in ROUTES}}


def _subnet(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("route", ROUTES)
def test_bf16_flownet2_train_step_matches_jax(flownet2_run, route):
    """Both training warp routes: the loss at 2e-3 relative, every gradient
    float32, each sub-net within its gate in relative L2."""
    j_loss, j_epe, want = flownet2_run["jax"]
    model, metrics, before, calls = flownet2_run[route]
    warp = ({"resample2d_tangents": 2, "resample2d_tangents_multi": 1}
            if route == "tangents" else
            {"resample2d": 2, "resample2d_multi": 1,
             "resample2d_grad_flow": 2, "resample2d_grad_flow_multi": 1})
    assert calls == {"correlation": 1, "correlation_bwd": 1, **warp}
    print(f"{route}: loss port {metrics['loss'].item():.6f}, JAX bf16 "
          f"{j_loss:.6f}, JAX f32 {flownet2_run['jax_f32'][0]:.6f}")
    np.testing.assert_allclose(metrics["loss"].item(), j_loss,
                               rtol=FLOWNET2_LOSS_RTOL)
    np.testing.assert_allclose(metrics["epe"].item(), j_epe,
                               rtol=FLOWNET2_LOSS_RTOL)
    got = _grads(model)
    assert set(got) == set(want)
    rel = _group_rel(got, want, _subnet)
    own = _group_rel(flownet2_run["jax"][2], flownet2_run["jax_f32"][2],
                     _subnet)
    for subnet, r in rel.items():
        print(f"{route} {subnet}: port bf16 against JAX bf16 {r:.3e} (gate "
              f"{FLOWNET2_GATES[subnet]:g}); JAX bf16 against JAX f32 "
              f"{own[subnet]:.3e}")
    beyond = {s: r for s, r in rel.items() if r > FLOWNET2_GATES[s]}
    assert not beyond, beyond


def test_bf16_flownet2_step_moves_float32_parameters(flownet2_run):
    """After the step the parameters are float32 and have moved, and both
    routes gave the same loss (their forwards are the same arithmetic)."""
    for route in ROUTES:
        model, _, before, _ = flownet2_run[route]
        moved = 0
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32, name
            moved += int(not torch.equal(p.detach(), before[name]))
        assert moved == len(before), f"{route}: {moved} of {len(before)} moved"
    losses_ = [flownet2_run[r][1]["loss"].item() for r in ROUTES]
    assert losses_[0] == losses_[1], losses_
