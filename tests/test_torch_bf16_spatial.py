"""The port's row bands in bfloat16 against the JAX package's, on the CPU,
on the same seeded numpy inputs.

Under ``set_spatial_shards(S)`` the port runs the correlation as row bands
against halo slabs of f2 (``ops/correlation_spatial.py``) and the warps as
row bands over the full-height image (``ops/resample2d_spatial.py``).  In
bfloat16 each band's plain version upcasts its operands, sums in float32
and rounds once, as the JAX package's ``_corr_slab`` and its XLA band warp
do, and as the CUDA kernels (K7 and the local-rows K2, K3, K4) do on the
card (``chip_smoke.py``, phases 2, 3b and 5b).  So a band that spans the
map is the whole-map op's bits, and every band's rows are the whole map's.

Tolerances:
- against the JAX package's ops, forwards and flow gradients: one bf16 ulp
  (rtol 2**-7, atol 1e-6 of the reference's largest magnitude), at most 1%
  of the elements not bit-equal: the two sum in other orders (XLA's dot
  over the channels, its fused loops) before the one rounding;
- the correlation's d_f2 under bands: each band's d_slab is rounded to bf16
  before the bands' halo rows are summed, in bf16, by the transposes of the
  slicing (both packages do it), so a halo value is the sum of two values
  that are each within one ulp; where the two nearly cancel that is more
  than one ulp of the sum: two ulp of the largest magnitude;
- the warps' image gradient: the JAX package's XLA scatter rounds to bf16
  as it sums (its whole-image op reads 1.33e-2 in relative L2 against the
  port's), the port sums each band's taps in float32 and rounds once, then
  adds the bands' bf16 images: 2e-2 in relative L2 against the JAX package
  (1.06e-2 read), 5e-3 against the port's whole-image op (2.5e-3 read);
- the slice: the forward bit-equal to the whole map, the train step at
  ``chip_smoke.py`` phase 5b's gates (loss and EPE within 5e-3 relative,
  each sub-net's gradients within 5e-2 in relative L2).

No test here compiles the JAX FlowNet2: tier-1's time is held by keeping
the slice at FlowNet2CS in the port alone.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flownet2_tpu.parallel import make_mesh

from flownet2_tpu_torch import losses, ops
from flownet2_tpu_torch.models import get_model
from flownet2_tpu_torch.ops import correlation, correlation_spatial
from flownet2_tpu_torch.ops import resample2d, resample2d_spatial
from flownet2_tpu_torch.ops import sharding_hints, stage_glue
from flownet2_tpu_torch.train import StepFactory, get_optimizer

from test_torch_bf16_train import (BF16_ULP, ROUTES, _bf16, _f32, _jnp, _nchw,
                                   _one_ulp, _rel_l2)

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


def _nhwc(t):
    """An NCHW tensor, gradient-tracking or not, as NHWC float32 numpy."""
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(autouse=True)
def _restore_settings():
    yield
    sharding_hints.set_spatial_shards(1)
    sharding_hints.clear_dispatch_log()
    jax_hints.set_active_mesh(None, False)


def _sharded(mesh, *arrays):
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", "spatial"))
    return [jax.device_put(_jnp(a), spec) for a in arrays]


# ------------------------------------ F1: the band plain versions round once

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("maxd,s2,shape", [(20, 2, (2, 16, 10, 27)),
                                           (4, 1, (1, 64, 16, 24))])
def test_one_band_is_the_whole_map_bit_for_bit(maxd, s2, shape, dtype):
    """One band that spans the map, against f2 padded by maxd rows: the
    forward is ``correlation_plain``'s bits, d_f1 and d_slab's rows
    [maxd, maxd + H) are ``correlation_bwd_plain``'s.  In bfloat16 the
    band versions once multiplied and summed in bf16 and missed in a third
    to two thirds of the values; in float32 they keep their bits."""
    dtype = getattr(torch, dtype)
    rng = np.random.RandomState(90)
    f1, f2 = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
              for _ in range(2))
    disp = 2 * (maxd // s2) + 1
    g = torch.from_numpy(rng.randn(shape[0], disp * disp, *shape[2:]).astype(
        np.float32)).to(dtype)
    height = shape[2]
    slab = F.pad(f2, (0, 0, maxd, maxd))
    ops.reset_counts()
    out = correlation_spatial.corr_slab_plain(f1, slab, maxd, s2)
    d_f1, d_slab = correlation_spatial.corr_slab_bwd_plain(g, f1, slab, maxd,
                                                           s2)
    assert dict(ops.PLAIN_CALLS) == {"corr_slab": 1, "corr_slab_bwd": 1}
    want = correlation.correlation_plain(f1, f2, maxd, 1, maxd, 1, s2)
    want1, want2 = correlation.correlation_bwd_plain(g, f1, f2, maxd, s2)
    for got in (out, d_f1, d_slab):
        assert got.dtype == dtype
    assert d_slab.shape == (shape[0], shape[1], height + 2 * maxd, shape[3])
    assert torch.equal(out, want)
    assert torch.equal(d_f1, want1)
    assert torch.equal(d_slab[:, :, maxd:maxd + height], want2)


# --------------------------------------------------- the local slab op

@pytest.mark.parametrize("maxd,s2", [(20, 2), (4, 1)])
@pytest.mark.parametrize("band", ["top", "middle", "bottom"])
def test_bf16_corr_slab_and_grads_match_jax(band, maxd, s2):
    """One band of four of a 16-row map against its halo slab, bf16: the
    output and both gradients against the JAX package's ``_corr_slab`` and
    ``jax.vjp`` of it in bf16, one ulp."""
    height, width, chans, local_h = 16, 24, 8, 4
    off = {"top": 0, "middle": 4, "bottom": 12}[band]
    f1 = _bf16((2, height, width, chans), 1)
    f2 = _bf16((2, height, width, chans), 2)
    f1_loc = f1[:, off:off + local_h]
    slab = np.pad(f2, ((0, 0), (maxd, maxd), (0, 0), (0, 0)))[
        :, off:off + local_h + 2 * maxd]
    disp = 2 * (maxd // s2) + 1
    g = _bf16((2, local_h, width, disp * disp), 3)

    want, vjp = jax.vjp(
        lambda a, b: jax_corr_spatial._corr_slab(a, b, maxd, s2),
        _jnp(f1_loc), _jnp(slab))
    want1, want_slab = vjp(_jnp(g))
    assert want.dtype == want1.dtype == want_slab.dtype == jnp.bfloat16

    t1 = _nchw(f1_loc).requires_grad_()
    t_slab = _nchw(slab).requires_grad_()
    ops.reset_counts()
    got = correlation_spatial.corr_slab(t1, t_slab, maxd, s2)
    got.backward(_nchw(g))
    assert dict(ops.PLAIN_CALLS) == {"corr_slab": 1, "corr_slab_bwd": 1}
    assert not ops.LAUNCHES
    for t in (got, t1.grad, t_slab.grad):
        assert t.dtype == torch.bfloat16
    _one_ulp(_nhwc(got), _f32(want), f"{band} band, out")
    _one_ulp(_nhwc(t1.grad), _f32(want1), f"{band} band, d_f1")
    _one_ulp(_nhwc(t_slab.grad), _f32(want_slab), f"{band} band, d_slab")


# -------------------------------------------------- the band compositions

def test_bf16_correlation_bands_match_jax_spatial_mesh():
    """The bf16 cost volume and both gradients under two bands against the
    JAX package under ``make_mesh(spatial=2)`` in bf16: the forward and
    d_f1 at one ulp, d_f2 at two ulp of its largest magnitude (the halo
    sums, module docstring); against the port's whole-map op the forward
    and d_f1 are bit-equal."""
    f1 = _bf16((2, 16, 64, 8), 11)
    f2 = _bf16((2, 16, 64, 8), 12)
    g = _bf16((2, 16, 64, 441), 13)

    def corr(a, b):
        return jax_corr.correlation(a, b, 20, 1, 20, 1, 2)

    mesh = make_mesh(jax.devices()[:2], spatial=2)
    jax_hints.clear_dispatch_log()
    f1s, f2s = _sharded(mesh, f1, f2)
    want, vjp = jax.vjp(jax.jit(corr), f1s, f2s)
    want1, want2 = vjp(_jnp(g))
    assert "halo-slab" in jax_hints.dispatch_log()["correlation"]
    assert want.dtype == want2.dtype == jnp.bfloat16

    def run():
        t1, t2 = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
        out = correlation.correlation(t1, t2)
        out.backward(_nchw(g))
        return out.detach(), t1.grad, t2.grad

    whole = run()
    ops.reset_counts()
    with sharding_hints.scoped_spatial_shards(2):
        got = run()
    assert sharding_hints.dispatch_log()["correlation"] == \
        "bands(spatial=2)+halo-slab, kernel=plain"
    assert dict(ops.PLAIN_CALLS) == {"corr_slab": 2, "corr_slab_bwd": 2}
    for t in got:
        assert t.dtype == torch.bfloat16
    _one_ulp(_nhwc(got[0]), _f32(want), "out")
    _one_ulp(_nhwc(got[1]), _f32(want1), "d_f1")
    want2 = _f32(want2)
    np.testing.assert_allclose(
        _nhwc(got[2]), want2, rtol=0,
        atol=2 * BF16_ULP * float(np.abs(want2).max()))
    assert torch.equal(got[0], whole[0])
    assert torch.equal(got[1], whole[1])


@pytest.mark.parametrize("route", ROUTES)
def test_bf16_warp_bands_match_jax_spatial_mesh(route):
    """The bf16 warp and its flow gradient under two bands, with flows that
    cross the band boundary both ways: bit-equal to the port's whole-image
    op, and within one ulp of the JAX package under
    ``make_mesh(spatial=2)`` in bf16 (its XLA band path upcasts and rounds
    once); the image gradient in relative L2 (module docstring)."""
    img = _bf16((2, 64, 128, 3), 7)
    flow = _bf16((2, 64, 128, 2), 8, 30.0)
    g = _bf16((2, 64, 128, 3), 9)

    mesh = make_mesh(jax.devices()[:2], spatial=2)
    jax_hints.clear_dispatch_log()
    img_s, flow_s = _sharded(mesh, img, flow)
    want, vjp = jax.vjp(jax.jit(
        lambda i, f: jax_r2d.resample2d(i, f, 1, True)), img_s, flow_s)
    want_img, want_flow = map(_f32, vjp(_jnp(g)))
    assert "halo-gather" in jax_hints.dispatch_log()["resample2d"]
    assert want.dtype == jnp.bfloat16

    warp = (resample2d.resample2d_tangents if route == "tangents"
            else resample2d.resample2d_multi)

    def run():
        t_img = _nchw(img).requires_grad_()
        t_flow = _nchw(flow).requires_grad_()
        out = warp(t_img, t_flow.unsqueeze(1))[:, 0]
        out.backward(_nchw(g))
        return out.detach(), t_flow.grad, t_img.grad

    whole = run()
    ops.reset_counts()
    with sharding_hints.scoped_spatial_shards(2):
        got = run()
    assert sharding_hints.dispatch_log()["resample2d"] == \
        "bands(spatial=2)+halo-gather, kernel=plain"
    names = ({"resample2d_tangents": 2} if route == "tangents" else
             {"resample2d": 2, "resample2d_grad_flow": 2})
    assert dict(ops.PLAIN_CALLS) == names
    for t in got:
        assert t.dtype == torch.bfloat16
    assert torch.equal(got[0], whole[0])
    assert torch.equal(got[1], whole[1])
    _one_ulp(_nhwc(got[0]), _f32(want), f"{route}, out")
    _one_ulp(_nhwc(got[1]), want_flow, f"{route}, d_flow")
    rel = _rel_l2(_nhwc(got[2]), want_img)
    rel_whole = _rel_l2(got[2].float().numpy(), whole[2].float().numpy())
    print(f"{route}, d_img: relative L2 {rel:.3e} against the JAX package, "
          f"{rel_whole:.3e} against the whole image")
    assert rel <= 2e-2
    assert rel_whole <= 5e-3


def test_bf16_band_warp_joins_the_offset_before_the_flow():
    """The second band of two of a 384-row image (offset 192 >= 128, where
    a bf16 value's ulp is 1 px) is bit-equal to the same rows of the
    whole-image bf16 warp, on both routes and for the flow gradient.  Had
    the offset been added to the bf16 flow, as the JAX package's TPU band
    path does (``_shift_dy``), the sample rows would round to whole
    pixels: that warp differs."""
    height, width, off = 384, 32, 192
    rows = slice(off, height)
    img = _nchw(_bf16((1, height, width, 3), 30))
    flows = torch.stack([_nchw(_bf16((1, height, width, 2), 31 + k, 4.0))
                         for k in range(2)], dim=1)
    g = _nchw(_bf16((1, height, width, 6), 33)).view(1, 2, 3, height, width)
    flows_loc = flows[:, :, :, rows].contiguous()
    g_loc = g[:, :, :, rows].contiguous()

    whole = (resample2d.resample2d_multi_plain(img, flows),
             *resample2d.resample2d_tangents_plain(img, flows),
             resample2d.resample2d_grad_flow_plain(g, img, flows))
    got = (resample2d_spatial.warp_rows(img, flows_loc, off),
           resample2d_spatial.warp_rows(img, flows_loc, off, tangents=True),
           *resample2d.resample2d_tangents_plain(img, flows_loc, off)[1:],
           resample2d.resample2d_grad_flow_plain(g_loc, img, flows_loc, off))
    assert got[0].dtype == got[4].dtype == torch.bfloat16
    for part, a, b in zip(("K2", "K3 out", "K3 d1", "K3 d2", "K4"), got,
                          whole):
        assert torch.equal(a, b[:, :, :, rows]), part

    shifted = flows_loc.clone()
    shifted[:, :, 1] += off   # rounded to bf16: whole pixels at 192
    assert not torch.equal(resample2d.resample2d_multi_plain(img, shifted),
                           whole[0][:, :, :, rows])


# ------------------------------------------------------- the slice as a whole

H, W = 64, 128


@pytest.fixture(scope="module")
def flownet2cs_runs():
    """FlowNet2CS in bf16 at 64x128 from one seed, whole and under two
    bands: an inference forward, and one MultiScale step's loss, EPE and
    gradients per training warp route, with the plain-op calls of each."""
    rng = np.random.RandomState(41)
    images = torch.from_numpy(rng.rand(1, 2, H, W, 3).astype(np.float32)
                              * 255.0)
    flow = torch.from_numpy(rng.rand(1, H, W, 2).astype(np.float32) * 5.0)
    made = get_model("FlowNet2CS", device="cpu", seed=0)
    runs = {}
    for shards in (1, 2):
        for route in ROUTES:
            model = get_model("FlowNet2CS", device="cpu",
                              dtype=torch.bfloat16)
            model.load_state_dict(made.state_dict())
            sharding_hints.clear_dispatch_log()
            with sharding_hints.scoped_spatial_shards(shards), \
                    pytest.MonkeyPatch.context() as mp:
                mp.setattr(stage_glue, "TRAIN_WARP", route)
                ops.reset_counts()
                with torch.inference_mode():
                    out = model(images)
                fwd_counts = dict(ops.PLAIN_CALLS)
                step = StepFactory(model, losses.MultiScale(),
                                   get_optimizer("Adam", 1e-4)).train_step()
                ops.reset_counts()
                metrics = step(images, flow)
            grads = {}
            for n, p in model.named_parameters():
                assert p.dtype == p.grad.dtype == torch.float32, n
                assert torch.isfinite(p.grad).all(), n
                grads[n] = p.grad.numpy()
            runs[shards, route] = dict(
                out=out, fwd_counts=fwd_counts, metrics=metrics,
                step_counts=dict(ops.PLAIN_CALLS),
                launches=dict(ops.LAUNCHES),
                log=sharding_hints.dispatch_log(), grads=grads)
    return runs


def test_bf16_flownet2cs_forward_under_two_bands_equals_whole(
        flownet2cs_runs):
    whole = flownet2cs_runs[1, "grad_flow"]
    bands = flownet2cs_runs[2, "grad_flow"]
    assert bands["out"].dtype == torch.bfloat16
    assert bands["out"].shape == (1, H, W, 2)
    assert torch.equal(bands["out"], whole["out"])
    assert whole["fwd_counts"] == {"correlation": 1, "resample2d": 1}
    assert bands["fwd_counts"] == {"corr_slab": 2, "resample2d": 2}
    assert bands["log"] == {
        "correlation": "bands(spatial=2)+halo-slab, kernel=plain",
        "resample2d": "bands(spatial=2)+halo-gather, kernel=plain"}
    assert not bands["launches"]


@pytest.mark.parametrize("route", ROUTES)
def test_bf16_flownet2cs_train_step_under_two_bands(flownet2cs_runs, route):
    """StepFactory runs the bf16 model unchanged under two bands, on both
    warp routes: loss and EPE within 5e-3 relative of the whole-map step,
    each sub-net's gradients within 5e-2 in relative L2 (the forwards are
    bit-equal, so the gradients differ by d_f2's halo sums only), and the
    plain-op calls of a band step."""
    whole = flownet2cs_runs[1, route]
    bands = flownet2cs_runs[2, route]
    for key in ("loss", "epe"):
        np.testing.assert_allclose(bands["metrics"][key].item(),
                                   whole["metrics"][key].item(), rtol=5e-3)
    got, want = bands["grads"], whole["grads"]
    assert set(got) == set(want)
    for subnet in ("flownetc", "flownets_1"):
        names = [n for n in want if n.split(".")[0] == subnet]
        rel = _rel_l2(np.concatenate([got[n].ravel() for n in names]),
                      np.concatenate([want[n].ravel() for n in names]))
        print(f"{route} {subnet}: two bands against the whole map, relative "
              f"L2 {rel:.3e}")
        assert rel <= 5e-2, subnet
    warp = ({"resample2d_tangents": 1} if route == "tangents" else
            {"resample2d": 1, "resample2d_grad_flow": 1})
    assert whole["step_counts"] == {"correlation": 1, "correlation_bwd": 1,
                                    **warp}
    assert bands["step_counts"] == {
        "corr_slab": 2, "corr_slab_bwd": 2,
        **{name: 2 * n for name, n in warp.items()}}
    assert not bands["launches"]
