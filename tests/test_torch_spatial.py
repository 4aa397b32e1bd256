"""The port's row-band (height-split) correlation and warp against the JAX
package's spatial compositions, on the CPU, on the same numpy inputs.

The JAX package shards the height over the ``spatial`` axis of a CPU mesh
of eight virtual devices (tests/conftest.py); the port cuts the same work
into ``set_spatial_shards(S)`` bands on one device.  On the CPU the port's
local ops take their plain PyTorch versions; the CUDA kernels (K7 and the
local-rows forms of K2, K3, K4) are held against those same plain versions
on the card by chip_smoke.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flownet2_tpu.parallel import make_mesh

from flownet2_tpu_torch import losses, ops
from flownet2_tpu_torch.models import get_model
from flownet2_tpu_torch.ops import correlation, correlation_spatial
from flownet2_tpu_torch.ops import resample2d, resample2d_spatial
from flownet2_tpu_torch.ops import sharding_hints
from flownet2_tpu_torch.train import StepFactory, get_optimizer

from test_torch_train import assert_grads_close

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)


def _jax_ops(name):
    # flownet2_tpu.ops re-exports functions under some of its module names
    return importlib.import_module(f"flownet2_tpu.ops.{name}")


jax_corr = _jax_ops("correlation")
jax_corr_spatial = _jax_ops("correlation_spatial")
jax_r2d = _jax_ops("resample2d")
jax_hints = _jax_ops("sharding_hints")


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(autouse=True)
def _restore_settings():
    yield
    sharding_hints.set_spatial_shards(1)
    sharding_hints.clear_dispatch_log()
    sharding_hints._WARNED_REASONS.clear()
    jax_hints.set_active_mesh(None, False)


def _sharded(mesh, *arrays):
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", "spatial"))
    return [jax.device_put(jnp.asarray(a), spec) for a in arrays]


# ------------------------------------------------------- the local slab op

@pytest.mark.parametrize("maxd,s2", [(20, 2), (4, 1)])
@pytest.mark.parametrize("band", ["top", "middle", "bottom"])
def test_corr_slab_and_grads_match_jax(band, maxd, s2):
    """One band of four of a 16-row map (Hloc 4 < maxd 20) against its
    halo slab: the output and both gradients against the JAX package's
    ``_corr_slab`` and ``jax.vjp`` of it, f32, 1e-5.  The top and the
    bottom band's slabs hold the map's zero padding."""
    height, width, chans, local_h = 16, 24, 8, 4
    off = {"top": 0, "middle": 4, "bottom": 12}[band]
    f1 = _rand((2, height, width, chans), 1)
    f2 = _rand((2, height, width, chans), 2)
    f1_loc = f1[:, off:off + local_h]
    slab = np.pad(f2, ((0, 0), (maxd, maxd), (0, 0), (0, 0)))[
        :, off:off + local_h + 2 * maxd]
    disp = 2 * (maxd // s2) + 1
    g = _rand((2, local_h, width, disp * disp), 3)

    want, vjp = jax.vjp(
        lambda a, b: jax_corr_spatial._corr_slab(a, b, maxd, s2),
        jnp.asarray(f1_loc), jnp.asarray(slab))
    want1, want_slab = vjp(jnp.asarray(g))

    t1 = _nchw(f1_loc).requires_grad_()
    t_slab = _nchw(slab).requires_grad_()
    ops.reset_counts()
    got = correlation_spatial.corr_slab(t1, t_slab, maxd, s2)
    got.backward(_nchw(g))
    assert dict(ops.PLAIN_CALLS) == {"corr_slab": 1, "corr_slab_bwd": 1}
    assert not ops.LAUNCHES
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(t1.grad), np.asarray(want1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(t_slab.grad), np.asarray(want_slab),
                               rtol=1e-5, atol=1e-5)
    # the halo rows that lie in the map's padding get a gradient too (the
    # composition's crop drops it): it is not all zero there
    if band == "top":
        assert np.abs(_nhwc(t_slab.grad)[:, :maxd]).max() > 0


def test_corr_slab_needs_only_what_is_asked():
    f1 = torch.from_numpy(_rand((1, 4, 6, 10), 4))
    slab = torch.from_numpy(_rand((1, 4, 6 + 8, 10), 5)).requires_grad_()
    correlation_spatial.corr_slab(f1, slab, 4, 2).sum().backward()
    both = correlation_spatial.corr_slab_bwd_plain(
        torch.ones(1, 25, 6, 10), f1, slab.detach(), 4, 2)
    assert f1.grad is None
    assert torch.equal(slab.grad, both[1])
    only = correlation_spatial.corr_slab_bwd_plain(
        torch.ones(1, 25, 6, 10), f1, slab.detach(), 4, 2,
        needs=(True, False))
    assert only[1] is None and torch.equal(only[0], both[0])


@pytest.mark.parametrize("maxd,s2", [(20, 2), (4, 1)])
def test_one_band_slab_grads_are_whole_map_grads(maxd, s2):
    """One band that spans the whole map (a ragged 10x27 one, below maxd
    20), against its f2 padded by maxd rows: d_slab's rows [maxd, maxd + H)
    are ``correlation_bwd_plain``'s d_f2 and its d_f1 is the whole map's,
    f32.  The two plain versions slice differently padded tensors, so they
    are held to 1e-6 here; on the card the kernels are held bit for bit."""
    height, width, chans = 10, 27, 6
    f1 = torch.from_numpy(_rand((2, chans, height, width), 6))
    f2 = torch.from_numpy(_rand((2, chans, height, width), 7))
    disp = 2 * (maxd // s2) + 1
    g = torch.from_numpy(_rand((2, disp * disp, height, width), 8))
    slab = torch.nn.functional.pad(f2, (0, 0, maxd, maxd))
    d_f1, d_slab = correlation_spatial.corr_slab_bwd_plain(g, f1, slab, maxd,
                                                           s2)
    want_f1, want_f2 = correlation.correlation_bwd_plain(g, f1, f2, maxd, s2)
    assert d_slab.shape == (2, chans, height + 2 * maxd, width)
    torch.testing.assert_close(d_slab[:, :, maxd:maxd + height], want_f2,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(d_f1, want_f1, rtol=1e-6, atol=1e-6)
    assert want_f2.abs().max() > 0.1


# -------------------------------------------------- the band compositions

@pytest.mark.parametrize("shards", [2, 4])
def test_correlation_bands_match_jax_spatial_mesh(shards):
    """The cost volume and both gradients under ``shards`` bands against
    the JAX package under ``make_mesh(spatial=shards)``, 1e-5; against the
    port's whole-map op the forward and d_f1 are bit-equal and d_f2 (one
    more add per halo row) within 1e-5."""
    f1 = _rand((4, 16, 64, 8), 11)
    f2 = _rand((4, 16, 64, 8), 12)

    def loss(a, b):
        return jnp.sum(jnp.sin(jax_corr.correlation(a, b, 20, 1, 20, 1, 2)))

    mesh = make_mesh(spatial=shards)
    jax_hints.clear_dispatch_log()
    f1s, f2s = _sharded(mesh, f1, f2)
    want = jax.jit(
        lambda a, b: jax_corr.correlation(a, b, 20, 1, 20, 1, 2))(f1s, f2s)
    want1, want2 = jax.jit(jax.grad(loss, argnums=(0, 1)))(f1s, f2s)
    assert "halo-slab" in jax_hints.dispatch_log()["correlation"]

    def run():
        t1, t2 = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
        out = correlation.correlation(t1, t2)
        torch.sum(torch.sin(out)).backward()
        return out.detach(), t1.grad, t2.grad

    whole = run()
    assert sharding_hints.dispatch_log()["correlation"] == \
        "whole map, kernel=plain"
    ops.reset_counts()
    with sharding_hints.scoped_spatial_shards(shards):
        got = run()
    assert sharding_hints.spatial_shards() == 1
    assert sharding_hints.dispatch_log()["correlation"] == \
        f"bands(spatial={shards})+halo-slab, kernel=plain"
    assert dict(ops.PLAIN_CALLS) == {"corr_slab": shards,
                                     "corr_slab_bwd": shards}
    assert not ops.LAUNCHES
    for a, b in zip(got, (want, want1, want2)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(got[0], whole[0])
    assert torch.equal(got[1], whole[1])
    np.testing.assert_allclose(got[2].numpy(), whole[2].numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("route", ["grad_flow", "tangents"])
@pytest.mark.parametrize("shards", [2, 4])
def test_warp_bands_match_jax_spatial_mesh(shards, route):
    """The warp and its flow gradient under ``shards`` bands, with flows
    that cross the band boundaries both ways: bit-equal to the port's
    whole-image op, and within 4 ulp of the result's largest magnitude of
    the JAX package under ``make_mesh(spatial=shards)`` (XLA associates the
    four-term sums differently: 4 of 98,304 values differ by 2 ulp).  The
    image gradient sums the bands' scatters: 1e-5."""
    img = _rand((4, 64, 128, 3), 7)
    flow = _rand((4, 64, 128, 2), 8, 30.0)

    def loss(i, f):
        return jnp.sum(jnp.sin(jax_r2d.resample2d(i, f, 1, True)))

    mesh = make_mesh(spatial=shards)
    jax_hints.clear_dispatch_log()
    img_s, flow_s = _sharded(mesh, img, flow)
    want = np.asarray(jax.jit(
        lambda i, f: jax_r2d.resample2d(i, f, 1, True))(img_s, flow_s))
    want_img, want_flow = map(np.asarray, jax.jit(
        jax.grad(loss, argnums=(0, 1)))(img_s, flow_s))
    assert "halo-gather" in jax_hints.dispatch_log()["resample2d"]

    warp = (resample2d.resample2d_tangents if route == "tangents"
            else resample2d.resample2d_multi)

    def run():
        t_img = _nchw(img).requires_grad_()
        t_flow = _nchw(flow).requires_grad_()
        out = warp(t_img, t_flow.unsqueeze(1))[:, 0]
        torch.sum(torch.sin(out)).backward()
        return out.detach(), t_flow.grad, t_img.grad

    whole = run()
    ops.reset_counts()
    sharding_hints.set_spatial_shards(shards)
    got = run()
    assert sharding_hints.dispatch_log()["resample2d"] == \
        f"bands(spatial={shards})+halo-gather, kernel=plain"
    names = ({"resample2d_tangents": shards} if route == "tangents" else
             {"resample2d": shards, "resample2d_grad_flow": shards})
    assert dict(ops.PLAIN_CALLS) == names
    assert not ops.LAUNCHES
    assert torch.equal(got[0], whole[0])
    assert torch.equal(got[1], whole[1])
    np.testing.assert_allclose(got[2].numpy(), whole[2].numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, b in ((got[0], want), (got[1], want_flow)):
        np.testing.assert_allclose(_nhwc(a), b, rtol=0,
                                   atol=4 * np.spacing(np.abs(b).max()))
    np.testing.assert_allclose(_nhwc(got[2]), want_img, rtol=1e-5, atol=1e-5)


def test_two_flow_warp_bands_are_one_call_per_band():
    """The fusion glue's two-flow warp stays one call per band, bit-equal
    to the whole-image call."""
    img = _nchw(_rand((2, 16, 32, 3), 21))
    flows = torch.stack([_nchw(_rand((2, 16, 32, 2), 22, 6.0)),
                         _nchw(_rand((2, 16, 32, 2), 23, 40.0))], dim=1)
    whole = resample2d.resample2d_multi(img, flows)
    ops.reset_counts()
    with sharding_hints.scoped_spatial_shards(4):
        got = resample2d.resample2d_multi(img, flows)
    assert dict(ops.PLAIN_CALLS) == {"resample2d_multi": 4}
    assert torch.equal(got, whole)
    rows = resample2d_spatial.warp_rows(img, flows[:, :, :, 4:8].contiguous(),
                                        4)
    assert torch.equal(rows, whole[:, :, :, 4:8])


def test_correlation_bands_match_pallas_rows_kernels_interpret():
    """The JAX package's Pallas row-slab kernels, forced on in interpret
    mode on a two-device spatial mesh (the wide, column-chunked path:
    96 + 2*20 > 128), against the port under two bands, at the kernels'
    bf16 operand tolerances (tests/test_pallas_sharding.py)."""
    f1 = _rand((1, 16, 96, 8), 12)
    f2 = _rand((1, 16, 96, 8), 13)

    def loss(a, b):
        return jnp.sum(jnp.sin(jax_corr.correlation(a, b, 20, 1, 20, 1, 2)))

    mesh = make_mesh(jax.devices()[:2], spatial=2)
    f1s, f2s = _sharded(mesh, f1, f2)
    jax_corr_spatial.set_force_pallas(True)
    jax_hints.clear_dispatch_log()
    try:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax.jit(lambda a, b: jax_corr.correlation(
                a, b, 20, 1, 20, 1, 2))(f1s, f2s))
            want1, want2 = map(np.asarray, jax.jit(
                jax.grad(loss, argnums=(0, 1)))(f1s, f2s))
    finally:
        jax_corr_spatial.set_force_pallas(None)
    assert "pallas-rows" in jax_hints.dispatch_log()["correlation"]

    t1, t2 = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
    with sharding_hints.scoped_spatial_shards(2):
        got = correlation.correlation(t1, t2)
        torch.sum(torch.sin(got)).backward()
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(_nhwc(t1.grad), want1, atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(_nhwc(t2.grad), want2, atol=3e-2, rtol=1e-2)


def test_ragged_height_declines_with_one_warning(capsys):
    """A height the number of bands does not divide: both compositions
    decline, each says so once, and the ops compute through their
    whole-map versions, as the JAX package's do."""
    f1, f2 = _rand((4, 15, 32, 8), 13), _rand((4, 15, 32, 8), 14)
    img, flow = _rand((4, 15, 32, 3), 15), _rand((4, 15, 32, 2), 16, 5.0)
    mesh = make_mesh(spatial=2)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    jax_hints.clear_dispatch_log()
    want = np.asarray(jax.jit(
        lambda a, b: jax_corr.correlation(a, b, 4, 1, 4, 1, 2))(
            jax.device_put(jnp.asarray(f1), rep),
            jax.device_put(jnp.asarray(f2), rep)))
    assert "halo-slab" not in jax_hints.dispatch_log().get("correlation", "")
    want_warp = np.asarray(jax_r2d._resample2d_core(
        jnp.asarray(img), jnp.asarray(flow), 1, True))

    capsys.readouterr()
    ops.reset_counts()
    sharding_hints.set_spatial_shards(2)
    for _ in range(2):
        got = correlation.correlation(_nchw(f1), _nchw(f2), 4, 1, 4, 1, 2)
        got_warp = resample2d.resample2d(_nchw(img), _nchw(flow))
    assert dict(ops.PLAIN_CALLS) == {"correlation": 2, "resample2d": 2}
    assert sharding_hints.dispatch_log() == {
        "correlation": "whole map, kernel=plain",
        "resample2d": "whole image, kernel=plain"}
    err = capsys.readouterr().err
    assert err.count("row-band composition declined") == 2
    assert err.count("correlation height 15 ragged on spatial=2") == 1
    assert err.count("warp height 15 ragged on spatial=2") == 1
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got_warp), want_warp, rtol=1e-5,
                               atol=1e-5)


def test_other_correlation_configurations_stay_whole():
    """A displacement the stride does not divide, and the general
    configurations, do not take the band composition."""
    f1, f2 = _nchw(_rand((1, 8, 12, 4), 17)), _nchw(_rand((1, 8, 12, 4), 18))
    whole = [correlation.correlation(f1, f2, *cfg)
             for cfg in ((3, 1, 3, 1, 2), (4, 3, 4, 1, 2))]
    ops.reset_counts()
    sharding_hints.set_spatial_shards(2)
    got = [correlation.correlation(f1, f2, *cfg)
           for cfg in ((3, 1, 3, 1, 2), (4, 3, 4, 1, 2))]
    assert dict(ops.PLAIN_CALLS) == {"correlation": 2}
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def test_spatial_shards_setting():
    assert sharding_hints.spatial_shards() == 1
    with sharding_hints.scoped_spatial_shards(4):
        assert sharding_hints.spatial_shards() == 4
        with sharding_hints.scoped_spatial_shards(2):
            assert sharding_hints.spatial_shards() == 2
        assert sharding_hints.spatial_shards() == 4
    assert sharding_hints.spatial_shards() == 1
    for bad in (0, -2, 1.5):
        with pytest.raises(ValueError, match="positive integer"):
            sharding_hints.set_spatial_shards(bad)
    sharding_hints.record_dispatch("correlation", "x")
    assert sharding_hints.dispatch_log() == {"correlation": "x"}
    sharding_hints.clear_dispatch_log()
    assert sharding_hints.dispatch_log() == {}


# ------------------------------------------------------- the slice as a whole

H, W = 64, 128


@pytest.fixture(scope="module")
def flownet2_runs():
    """FlowNet2 at 64x128 from one seed, whole and under two bands: an
    inference forward, and one train step's loss, EPE and gradients."""
    rng = np.random.RandomState(31)
    images = torch.from_numpy(rng.rand(1, 2, H, W, 3).astype(np.float32)
                              * 255.0)
    flow = torch.from_numpy(rng.rand(1, H, W, 2).astype(np.float32) * 5.0)
    runs = {}
    for shards in (1, 2):
        model = get_model("FlowNet2", device="cpu", seed=0)
        sharding_hints.clear_dispatch_log()
        with sharding_hints.scoped_spatial_shards(shards):
            ops.reset_counts()
            with torch.inference_mode():
                out = model(images)
            fwd_counts = dict(ops.PLAIN_CALLS)
            factory = StepFactory(model, losses.MultiScale(),
                                  get_optimizer("Adam", 1e-4))
            ops.reset_counts()
            metrics = factory.train_step()(images, flow)
        runs[shards] = dict(
            out=out, fwd_counts=fwd_counts, metrics=metrics,
            step_counts=dict(ops.PLAIN_CALLS), launches=dict(ops.LAUNCHES),
            log=sharding_hints.dispatch_log(),
            grads={n: p.grad.numpy() for n, p in model.named_parameters()})
    return runs


def test_flownet2_forward_under_two_bands_equals_whole(flownet2_runs):
    whole, bands = flownet2_runs[1], flownet2_runs[2]
    assert bands["out"].shape == (1, H, W, 2)
    np.testing.assert_allclose(bands["out"].numpy(), whole["out"].numpy(),
                               rtol=0, atol=1e-6)
    assert whole["fwd_counts"] == {"correlation": 1, "resample2d": 2,
                                   "resample2d_multi": 1}
    assert bands["fwd_counts"] == {"corr_slab": 2, "resample2d": 4,
                                   "resample2d_multi": 2}
    assert "halo-slab" in bands["log"]["correlation"]
    assert "halo-gather" in bands["log"]["resample2d"]
    assert not bands["launches"]


def test_flownet2_train_step_under_two_bands_equals_whole(flownet2_runs):
    """StepFactory runs unchanged under two bands: loss and EPE at 1e-4,
    every gradient at the train-step test's gate (the forwards are
    bit-equal, so the gradients differ by d_f2's extra adds only)."""
    whole, bands = flownet2_runs[1], flownet2_runs[2]
    for key in ("loss", "epe"):
        np.testing.assert_allclose(bands["metrics"][key].item(),
                                   whole["metrics"][key].item(), rtol=1e-4)
    assert_grads_close(bands["grads"], whole["grads"])
    assert bands["step_counts"] == {
        "corr_slab": 2, "corr_slab_bwd": 2, "resample2d": 4,
        "resample2d_multi": 2, "resample2d_grad_flow": 4,
        "resample2d_grad_flow_multi": 2}
    assert whole["step_counts"] == {
        "correlation": 1, "correlation_bwd": 1, "resample2d": 2,
        "resample2d_multi": 1, "resample2d_grad_flow": 2,
        "resample2d_grad_flow_multi": 1}

