"""The port's training slice (losses, optimizers, the train step) against
the JAX package, on the CPU, on the same numpy inputs.

The slice test takes one FlowNet2 train step at 64x128 on weights made by
the port, carried to the JAX package by its own importer and back into a
second port model by ``from_jax_variables``, and holds the loss, the EPE
and every parameter's gradient to ``jax.value_and_grad`` of the JAX
package's MultiScale on ``FlowNet2().apply(..., training=True)``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flownet2_tpu import losses as jax_losses
from flownet2_tpu.checkpoints.torch_import import state_dict_to_variables
from flownet2_tpu.models import FlowNet2 as JaxFlowNet2
from flownet2_tpu.ops.correlation import correlation as jax_correlation
from flownet2_tpu.train import optim as jax_optim
from flownet2_tpu.train.state import StepFactory as JaxStepFactory
from flownet2_tpu.train.state import TrainState as JaxTrainState

from flownet2_tpu_torch import losses, ops
from flownet2_tpu_torch.checkpoints import from_jax_variables
from flownet2_tpu_torch.models import FlowNet2, get_model
from flownet2_tpu_torch.ops import correlation, stage_glue
from flownet2_tpu_torch.train import LRSchedule, StepFactory, get_optimizer

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

H, W = 64, 128
# Loss and EPE agree to float32 summation order.  The gradients are held at
# two levels: each sub-net's tensors together in relative L2 at 1e-3, and
# each single tensor in relative L2 at 0.1, which a missing, doubled or
# sign-flipped term (0.5 and more) cannot pass.
#
# A tight per-tensor gate sits on the noise line.  The two packages'
# forwards differ in the last bit (another summation order in the
# convolutions and the correlation), and the gradient is discontinuous in
# the forward's values (floor() in the warps, the LeakyReLU kinks), so a few
# pixels take another branch.  That error does not scale with the tensor: a
# tensor whose gradient cancels to a small total moves by percents.  The
# first gate here, 1e-3 of each tensor's largest |g|, passed on one machine
# and read 1.27e-3 (flownets_d.conv4.0.weight) up to 1.05e-2
# (flownets_d.predict_flow5.bias, max |g| 1e-6) on another, every time:
# FlowNetSD's near-zero flow sits on the warp's integer coordinates, and it
# gets 0.1% of the gradient's norm.  Its tensors together read 1.5e-4 there,
# the other sub-nets 1e-6 to 1.1e-4.  On the card the same step read 2.3e-2
# in flownetc.predict_flow6.bias (two elements) against the CPU, and at
# full size up to 5e-2 between two runs of one model and 8e-2 against the
# plain-op model: PERF.md, Findings ("Gradients on the card", "Gates on the
# noise line").
LOSS_TOL = 1e-4
GRAD_SUBNET_TOL = 1e-3
GRAD_TENSOR_TOL = 0.1


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------------------ losses

def _flow_outputs(seed):
    """A multi-scale output at 64x128 (finest 16x32, as FlowNetS gives at
    start scale 4) and its full-resolution target."""
    outs = tuple(_rand((2, H // s, W // s, 2), seed + i)
                 for i, s in enumerate((4, 8, 16, 32, 64)))
    return outs, _rand((2, H, W, 2), seed + 9, 5.0)


@pytest.mark.parametrize("name,kwargs", [
    ("L1Loss", {}), ("L2Loss", {}), ("MultiScale", {}),
    ("MultiScale", {"norm": "L2", "num_scales": 3, "l_weight": 0.5})])
def test_losses_match_jax(name, kwargs):
    """Single outputs and MultiScale's tuple branch, mean and per-sample
    forms, f32."""
    outs, target = _flow_outputs(1)
    full = _rand((2, H, W, 2), 20)
    port = losses.get_loss(name, **kwargs)
    ref = jax_losses.get_loss(name, **kwargs)
    assert port.loss_labels == ref.loss_labels
    cases = [(full, target)]
    if name == "MultiScale":
        cases.append((outs, target))
    for output, tgt in cases:
        t_out = (tuple(map(torch.from_numpy, output))
                 if isinstance(output, tuple) else torch.from_numpy(output))
        j_out = (tuple(map(jnp.asarray, output))
                 if isinstance(output, tuple) else jnp.asarray(output))
        for form in ("__call__", "per_sample"):
            got = getattr(port, form)(t_out, torch.from_numpy(tgt))
            want = getattr(ref, form)(j_out, jnp.asarray(tgt))
            for a, b in zip(got, want):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="available"):
        losses.get_loss("L3")
    with pytest.raises(KeyError, match="available"):
        get_optimizer("Lion", 1e-3)


# -------------------------------------------------------------- optimizers

@pytest.mark.parametrize("name,kwargs", [
    ("Adam", {}), ("AdamW", {}), ("SGD", {}), ("Momentum", {}),
    ("RMSprop", {}), ("Adagrad", {}),
    ("Adam", {"b1": 0.8, "eps": 1e-6}), ("SGD", {"momentum": 0.5,
                                                 "nesterov": True})])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_updates_match_optax(name, kwargs, clip):
    """Three steps on identical gradients, with a step schedule that decays
    after the first step and, in half the cases, a global-norm clip that
    the gradients exceed: the parameters after each step agree with the
    JAX package's optax transform, f32."""
    schedule = LRSchedule(0.1, frequency=1, fraction=2.0)
    params = [_rand((3, 4), 80), _rand((5,), 81)]
    grads = [[_rand(p.shape, 90 + 10 * k + i) for i, p in enumerate(params)]
             for k in range(3)]
    tx = jax_optim.get_optimizer(name, 0.1, jax_optim.LRSchedule(
        0.1, frequency=1, fraction=2.0), grad_clip=clip, **kwargs)
    j_params = [jnp.asarray(p) for p in params]
    state = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                for p in params]
    opt = get_optimizer(name, 0.1, schedule, grad_clip=clip, **kwargs)
    opt.init(t_params)
    for k in range(3):
        updates, state = tx.update([jnp.asarray(g) for g in grads[k]],
                                   state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for p, g in zip(t_params, grads[k]):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for a, b in zip(t_params, j_params):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
    assert opt.count == 3


def test_lr_schedule_matches_jax():
    ours = LRSchedule(1e-4, frequency=3, fraction=10.0)
    ref = jax_optim.LRSchedule(1e-4, frequency=3, fraction=10.0)
    for step in range(0, 20, 2):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6)
    assert ours(19) == 1e-6   # the floor
    assert LRSchedule(3e-4)(1000) == 3e-4


# ----------------------------------------------------------- the train step

def _batch(batch, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, 2, H, W, 3).astype(np.float32) * 255.0,
            rng.rand(batch, H, W, 2).astype(np.float32) * 5.0)


ROUTES = ("grad_flow", "tangents")


def _sq(x) -> float:
    return float((np.asarray(x, dtype=np.float64) ** 2).sum())


def assert_grads_close(got: dict, want: dict) -> None:
    """The gradients ``got`` against ``want`` (numpy arrays by parameter
    name, the sub-net's name first) at the gate above; the two must differ
    somewhere, or the comparison compared a thing with itself."""
    assert set(got) == set(want)
    diffs = {name: got[name].astype(np.float64) - w
             for name, w in want.items()}
    for subnet in sorted({name.split(".")[0] for name in want}):
        names = [n for n in want if n.split(".")[0] == subnet]
        rel = np.sqrt(sum(_sq(diffs[n]) for n in names)
                      / max(sum(_sq(want[n]) for n in names), 1e-60))
        assert rel <= GRAD_SUBNET_TOL, f"{subnet}: {rel:.2e} in relative L2"
    for name, w in want.items():
        rel = np.sqrt(_sq(diffs[name]) / max(_sq(w), 1e-60))
        assert rel <= GRAD_TENSOR_TOL, f"{name}: {rel:.2e} in relative L2"
    assert any(np.any(d != 0) for d in diffs.values())


@pytest.fixture(scope="module")
def slice_run():
    """One train step of the JAX package and, per training warp route, of
    the port, from the same weights and batch."""
    made = get_model("FlowNet2", device="cpu", seed=0)
    variables = state_dict_to_variables(
        {k: v.numpy() for k, v in made.state_dict().items()}, "FlowNet2")
    images, flow = _batch(1, 3)

    def jax_loss(params):
        out = JaxFlowNet2().apply({"params": params}, jnp.asarray(images),
                                  training=True)
        lossvalue, epevalue = jax_losses.MultiScale()(out, jnp.asarray(flow))
        return lossvalue, epevalue

    (j_loss, j_epe), j_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(variables["params"])
    run = {"want": (float(j_loss), float(j_epe), from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, j_grads)},
        "FlowNet2")), "batch": (images, flow), "variables": variables}
    backward = correlation._Correlation.backward

    def keep_correlation_operands(ctx, g):
        # FlowNetC's correlation inputs and the cotangent that reaches it
        run.setdefault("correlation", tuple(
            t.detach().clone() for t in (g, *ctx.saved_tensors)))
        return backward(ctx, g)

    for route in ROUTES:
        model = FlowNet2()
        model.load_state_dict(from_jax_variables(variables, "FlowNet2"),
                              strict=True)
        factory = StepFactory(model, losses.MultiScale(),
                              get_optimizer("Adam", 1e-4))
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        ops.reset_counts()
        with mock.patch.object(stage_glue, "TRAIN_WARP", route), \
                mock.patch.object(correlation._Correlation, "backward",
                                  staticmethod(keep_correlation_operands)):
            metrics = factory.train_step()(torch.from_numpy(images),
                                           torch.from_numpy(flow))
        run[route] = dict(model=model, metrics=metrics, before=before,
                          counts=(dict(ops.PLAIN_CALLS), dict(ops.LAUNCHES)))
    return run


@pytest.mark.parametrize("route", ROUTES)
def test_flownet2_train_step_matches_jax(slice_run, route):
    """Both training warp routes: loss, EPE and every gradient."""
    model, metrics = slice_run[route]["model"], slice_run[route]["metrics"]
    j_loss, j_epe, want_grads = slice_run["want"]
    assert np.isfinite(j_loss) and np.isfinite(j_epe)
    np.testing.assert_allclose(metrics["loss"].item(), j_loss, rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["epe"].item(), j_epe, rtol=LOSS_TOL)
    params = dict(model.named_parameters())
    assert set(params) == set(want_grads)
    assert_grads_close({name: p.grad.numpy() for name, p in params.items()},
                       {name: g.numpy() for name, g in want_grads.items()})


def test_flownetc_gradient_gap_sits_on_the_noise_line(slice_run):
    """Where the FlowNetC gap of the test above comes from: on some CPUs
    FlowNetC's gradients read 3.4e-3 in relative L2 against the JAX step
    (and FlowNetS_1's 1.5e-3), above the 1e-3 gate.  Not the correlation:
    its plain backward agrees with ``jax.vjp`` of the JAX op at this step's
    own inputs and cotangent to 1e-6 in relative L2 (it reads 1e-7).  The
    warp: one sample point of the warp by FlowNetC's flow lies on an
    integer column, where the flow gradient jumps (floor picks the corner),
    and a flow a few ulps to the other side of it, as a forward that
    differs in the last bit gives, moves FlowNetC's gradient by more than
    the gate (2.2e-3).  The gate above stays as it is."""
    g, f1, f2 = slice_run["correlation"]
    got = correlation.correlation_bwd_plain(g, f1, f2, 20, 2)

    def nhwc(t):
        return jnp.asarray(t.permute(0, 2, 3, 1).numpy())

    _, vjp = jax.vjp(lambda a, b: jax_correlation(a, b, 20, 1, 20, 1, 2),
                     nhwc(f1), nhwc(f2))
    for mine, ref in zip(got, vjp(nhwc(g))):
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        assert np.abs(ref).max() > 0
        rel = np.sqrt(_sq(mine.numpy().astype(np.float64) - ref) / _sq(ref))
        assert rel <= 1e-6, f"correlation backward {rel:.2e} in relative L2"

    warp = stage_glue._warp

    def flownetc_grads(move):
        """FlowNetC's gradients of the step, with ``move`` applied to the
        flow of the first warp (FlowNetC's)."""
        calls = []

        def first_warp_moved(x2, flows):
            if not calls:
                calls.append(flows.detach().clone())
                flows = move(flows)
            return warp(x2, flows)

        model = FlowNet2()
        model.load_state_dict(
            from_jax_variables(slice_run["variables"], "FlowNet2"))
        with mock.patch.object(stage_glue, "_warp", first_warp_moved):
            StepFactory(model, losses.MultiScale(), get_optimizer(
                "SGD", 0.0)).train_step()(
                    *map(torch.from_numpy, slice_run["batch"]))
        return calls[0], {n: p.grad.numpy()
                          for n, p in model.named_parameters()
                          if n.startswith("flownetc.")}

    flows, before = flownetc_grads(lambda f: f)
    # the column sample point x + dx nearest to an integer, and a flow that
    # puts it on the integer's other side
    dx = flows[0, 0, 0].numpy()
    sample = np.arange(dx.shape[1], dtype=np.float32) + dx
    y, x = np.unravel_index(np.argmin(np.abs(sample - np.round(sample))),
                            sample.shape)
    edge = np.round(sample[y, x])
    side = sample[y, x] >= edge
    moved = dx[y, x]
    while (np.float32(x) + moved >= edge) == side:
        moved = np.nextafter(moved, np.float32(-np.inf if side else np.inf))

    def across(f):
        f = f.clone()
        with torch.no_grad():
            f[0, 0, 0, y, x] = float(moved)
        return f

    _, after = flownetc_grads(across)
    jump = np.sqrt(sum(_sq(after[n].astype(np.float64) - before[n])
                       for n in before) / sum(_sq(b) for b in before.values()))
    assert jump > GRAD_SUBNET_TOL, (
        f"a flow across the integer at one sample moved FlowNetC by "
        f"{jump:.2e}")


def test_train_step_takes_plain_versions_and_updates_in_place(slice_run):
    """On the CPU the step runs every op's plain version, the warps by the
    default route (the generic warp and its flow gradient: two single-flow
    and one two-flow call each), launches no kernel, and Adam moves every
    parameter by about lr."""
    plain, launches = slice_run["grad_flow"]["counts"]
    assert plain == {"correlation": 1, "correlation_bwd": 1,
                     "resample2d": 2, "resample2d_multi": 1,
                     "resample2d_grad_flow": 2,
                     "resample2d_grad_flow_multi": 1}
    assert slice_run["tangents"]["counts"] == (
        {"correlation": 1, "correlation_bwd": 1, "resample2d_tangents": 2,
         "resample2d_tangents_multi": 1}, {})
    assert launches == {}
    assert stage_glue.TRAIN_WARP == "grad_flow"
    model, before = (slice_run["grad_flow"]["model"],
                     slice_run["grad_flow"]["before"])
    assert model.training
    for name, p in model.named_parameters():
        step = (p.detach() - before[name]).abs().max().item()
        assert 0.0 < step <= 1.01e-4, name


def test_step_factory_options_and_eval_step():
    """loss_scale divides the gradients back; skip_nonfinite_updates leaves
    the parameters and the optimizer alone on a non-finite gradient; the
    eval step sums the first n_valid samples' per-sample metrics."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(2, 2, 3, padding=1))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, images):
            return self.net(images[:, 0, :, :, :2].permute(0, 3, 1, 2)) \
                .permute(0, 2, 3, 1)

    images = torch.from_numpy(_rand((3, 2, 8, 8, 3), 100))
    flow = torch.from_numpy(_rand((3, 8, 8, 2), 101))
    grads = {}
    for scale in (1.0, 128.0):
        model = Model()
        factory = StepFactory(model, losses.L1Loss(),
                              get_optimizer("SGD", 0.0), loss_scale=scale)
        factory.train_step()(images, flow)
        grads[scale] = [p.grad.clone() for p in model.parameters()]
    for a, b in zip(grads[1.0], grads[128.0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)

    model = Model()
    factory = StepFactory(model, losses.L1Loss(), get_optimizer("Adam", 0.1),
                          skip_nonfinite_updates=True)
    before = [p.detach().clone() for p in model.parameters()]
    bad = images.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    metrics = factory.train_step()(bad, flow)
    assert not torch.isfinite(metrics["loss"])
    assert factory.optimizer.count == 0
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    factory.train_step()(images, flow)
    assert factory.optimizer.count == 1

    sums = factory.eval_step()(images, flow, 2)
    assert not model.training and sums["count"] == 2
    with torch.no_grad():
        pred = model(images)
    loss_ps, epe_ps = losses.L1Loss().per_sample(pred, flow)
    torch.testing.assert_close(sums["loss_sum"], loss_ps[:2].sum())
    torch.testing.assert_close(sums["epe_sum"], epe_ps[:2].sum())


def test_infer_steps_match_jax():
    """infer_step and infer_metrics_step against the JAX package's on the
    same weights and batch at 64x128: the flow of FlowNet2 in eval mode,
    and the MultiScale loss and EPE summed over the first n_valid samples
    (a padded tail batch); the model is left in eval mode."""
    made = get_model("FlowNet2", device="cpu", seed=1)
    variables = state_dict_to_variables(
        {k: v.numpy() for k, v in made.state_dict().items()}, "FlowNet2")
    images, flow = _batch(2, 5)
    j_factory = JaxStepFactory(JaxFlowNet2(), jax_losses.MultiScale(),
                               optax.adam(1e-4))
    state = JaxTrainState.create(variables, j_factory.tx)
    j_flow = np.asarray(j_factory.infer_step()(state, jnp.asarray(images)))
    j_pred, j_sums = j_factory.infer_metrics_step()(
        state, jnp.asarray(images), jnp.asarray(flow), 1)

    model = FlowNet2()
    model.load_state_dict(from_jax_variables(variables, "FlowNet2"),
                          strict=True)
    model.train()
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("Adam", 1e-4))
    got = factory.infer_step()(torch.from_numpy(images))
    assert not model.training and not got.requires_grad
    assert got.shape == (2, H, W, 2)
    np.testing.assert_allclose(got.numpy(), j_flow, rtol=1e-4, atol=1e-4)
    pred, sums = factory.infer_metrics_step()(torch.from_numpy(images),
                                              torch.from_numpy(flow), 1)
    assert torch.equal(pred, got)
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), rtol=1e-4,
                               atol=1e-4)
    assert sums["count"] == int(j_sums["count"]) == 1
    for key in ("loss_sum", "epe_sum"):
        np.testing.assert_allclose(sums[key].item(), float(j_sums[key]),
                                   rtol=LOSS_TOL)
    # the second sample is padding: its metrics are not in the sums
    loss_ps, epe_ps = losses.MultiScale().per_sample(pred,
                                                     torch.from_numpy(flow))
    torch.testing.assert_close(sums["loss_sum"], loss_ps[0])
    torch.testing.assert_close(sums["epe_sum"], epe_ps[0])
    assert loss_ps[1] != 0
