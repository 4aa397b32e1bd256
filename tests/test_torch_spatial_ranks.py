"""Row bands across processes (``DataParallelPlan(spatial=S)``, the halo
exchanges of ``parallel/halo.py`` and the band forms of the convolutions,
the bilinear upsample, the correlation, the warp and the input
normalisation) against the port on one process and the JAX package's
(data, spatial) mesh, on the CPU.

The ranks are child processes over gloo, as in tests/test_torch_parallel.py:
a ``file://`` store in the test's temporary directory, a 60 s group timeout
and a join limit, so that a hang fails the test.  Each rank runs this file
as a script (``_rank_main``); one launch of two ranks and one of four do
every case of their rank count in turn, saving what they got with
``torch.save``.  The test process computes the JAX references (ops and
steps; JAX is imported inside the functions that use it, so the ranks
import none of it) before it starts the ranks, and the port's whole-map
ops and one-process runs while they run.  The temporary directory goes
when the module's tests are done.

Bands are cut on granules of 64 frame rows (``sharding_hints.band_edges``),
the first bands one granule taller where S does not divide the granules:
``plan.band_rows(384)`` at spatial 4 is 128, 128, 64 and 64 rows.  Every
case below but (d) also runs at such unequal edges.

Cases, and why:

(a) The ops as bands of 2 and of 4 (each rank one band), forward and
    gradient on the same seeded numpy inputs: ``Conv2d`` 7x7 s2, 5x5 s2,
    3x3 s1 and ``ConvTranspose2d`` 4x4 s2 (their halos are reckoned from
    the kernel, stride and padding: 3 and 2, 2 and 1, 1 and 1, 1 and 1),
    ``upsample_bilinear`` (one halo row, the edge row repeated at the
    image's edges), the correlation (f2 gathered, K7's slab) and the warp
    on both routes (the image gathered, its gradient sent home).  Within
    1e-5 of the port's whole-map op and of the JAX op; the weight gradients
    summed over the bands, as DDP sums them, within 1e-5 of their largest
    magnitude (each a sum of thousands of products).  The correlation's
    forward and d_f1 and the warp's forward and flow gradient are bit-equal
    to the same rows of the whole map: they run the same local sums.  The
    all-gathers made as all-reduces of zeroed slots, as gloo runs them on
    CUDA tensors, give the same bits.  The same again at unequal edges
    (``UNEVEN``: granules 2, 1 over 2 ranks and 2, 1, 1, 1 over 4, a granule
    a quarter of the op's base height), against the whole map and the JAX
    op under ``make_mesh(spatial=S)``, whose band paths take any height S
    divides.
(b) FlowNet2C, b2 128x64 (two bands of 64 rows, the least FlowNet2's total
    stride allows), one Adam 1e-4 step at spatial 2: every parameter within
    1e-5 and the loss within 1e-5 relative of the JAX step on one device
    and under ``make_mesh(jax.devices()[:2], spatial=2)``; the ranks
    bit-equal after each of two steps.  This is the proof that DDP's mean
    of the D * S ranks' gradients, each of a loss over its band's rows, is
    the global batch's gradient.  At unequal bands, 192 rows over 2 ranks
    (128, 64) and 320 over 4 (128, 64, 64, 64), each rank's loss weighted
    by S times its share of the rows: the same gates against the JAX step
    on one device and the port's step in one process.
(c) FlowNet2 at 128x64, spatial 2, against the port in one process (no JAX
    FlowNet2 compile): the gathered inference flow within EPE 1e-4, the
    train step's gradients per sub-net within 1e-4 in relative L2 (flownetc
    and flownets_1 printed, not gated: ROADMAP.md section 3's noise line).
(d) Data 2 x spatial 2 on four ranks: FlowNet2S with BatchNorm, one SGD step
    at lr 1 (why SGD: tests/test_torch_parallel.py), on a batch whose
    float32 step float32 resolves (``BN_BATCH``), against the JAX step on
    one device: parameters within 2e-5 (``BN_PARAM_TOL`` says why), the
    running statistics within 1e-5, with torch's
    unbiased variance scaled to Flax's biased one over the global batch's
    samples.  BatchNorm's statistics are summed over every rank, data and
    spatial.  The JAX step on the (2, 2) mesh is printed beside, not gated:
    with BatchNorm it leaves the JAX package's own one-device step by some
    3e-2 (ROADMAP.md section 3, F5).
(e) The Trainer, FlowNet2S on 5 pairs at batch 4 (a padded tail of 1), at
    spatial 2 and at 2 x 2: the validation and inference means within 1e-5
    of one process's, over 5 samples (a sample counted once, not once a
    band), and rank 0's .flo files, gathered over the bands and the stripes,
    within 1e-5 of the flows of one process; and at spatial 2 on 192-row
    frames (bands of 128 and 64 rows).
(f) The command line and the plan: as two ranks with ``--spatial_shards 2``
    its bands span the ranks and its flows are one process's (EPE 1e-5);
    ``--spatial_shards 2`` on 4 mocked cards starts 4 ranks, on 1 card
    none; 384 rows at spatial 4 give 128, 128, 64, 64 and 448 at spatial 2
    give 256, 192, while 320 rows at spatial 8 and 100 at spatial 2 raise
    ``ValueError``; the plan's rank, band and data-rank layout is the JAX
    mesh's ``(n / S, S)``.
(g) FlowNet2CS in bfloat16 at 128x128 (``BF16_W`` says why not 64
    columns) as two bands across two ranks: the bf16 halos, gathers and
    slots; the flow within the JAX package's bf16 contract of the
    one-process bf16 bands and of the JAX bf16 model, one step at
    ``tests/test_torch_bf16_spatial.py``'s gates.
"""

import contextlib
import datetime
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # when a rank runs this file as a script
    sys.path.insert(0, str(REPO))

from flownet2_tpu_torch import losses  # noqa: E402
from flownet2_tpu_torch.cli.main import _ranks_to_start  # noqa: E402
from flownet2_tpu_torch.cli.main import build_parser  # noqa: E402
from flownet2_tpu_torch.data import (DataLoader, DeviceLoader,  # noqa: E402
                                     flow_io, read_flo)
from flownet2_tpu_torch.models import MODELS, get_model  # noqa: E402
from flownet2_tpu_torch.nn.layers import Conv2d, ConvTranspose2d  # noqa: E402
from flownet2_tpu_torch.ops import correlation, resample2d  # noqa: E402
from flownet2_tpu_torch.ops import sharding_hints, stage_glue  # noqa: E402
from flownet2_tpu_torch.ops.upsample import upsample_bilinear  # noqa: E402
from flownet2_tpu_torch.parallel import (ENV_VARS,  # noqa: E402
                                         DataParallelPlan, all_gather_batch,
                                         data_ranks, halo, init_distributed)
from flownet2_tpu_torch.train import (StepFactory, Trainer,  # noqa: E402
                                      TrainerConfig, get_optimizer)

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

TOL = 1e-5
JOIN_S = 300
H, W = 128, 64          # two bands of 64 rows
# bands of unequal height (sharding_hints.band_edges): the frames of
# FlowNet2C's step and of the Trainer, 192 rows over 2 ranks (128, 64) and
# 320 over 4 (128, 64, 64, 64)
UNEVEN_H = {2: 192, 4: 320}
# the ops at unequal edges: each band's granules, a granule a quarter of the
# op's base height (3 quarters over 2 bands, 5 over 4)
UNEVEN = {2: (2, 1), 4: (2, 1, 1, 1)}
# (g) FlowNet2CS in bfloat16: the batch's seed and width.  128 columns, not
# 64: torch's CPU bf16 convolution returns wrong values, and NaN on later
# calls, where its output is one column wide (conv6 of a 64-column frame;
# a 3x3 stride-2 convolution of a (2, 1024, 4, 2) bf16 input reads
# 3.5 from its float32 value, then NaN)
BF16_SEED, BF16_W = 41, 128
BN_LR = 1.0
# (d)'s global batch: (seed, pairs).  BatchNorm's float32 backward sits on
# float32's noise line for some draws (a few percent of a tensor's largest
# gradient from its float64 value, in one process, so that no float32
# layout can be held at 1e-5); the test asserts that this draw's
# one-process float32 step is within 2e-5 of its float64 step
BN_BATCH = (3, 8)
# (d)'s parameters after the step: BatchNorm's variance, E[x^2] - E[x]^2 of
# sums taken over four ranks in another order than one device's, puts a few
# of conv3_1's weights just past 1e-5 from the JAX one-device step (where
# the JAX package's own (2, 2) mesh is some 3e-2 from it)
BN_PARAM_TOL = 2e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _batch(seed, b, h=H, w=W):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 2, h, w, 3).astype(np.float32) * 255.0,
            rng.randn(b, h, w, 2).astype(np.float32) * 2)


def _digest(module) -> str:
    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _clone_state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


class _Pairs:
    """``n`` seeded pairs in memory."""

    def __init__(self, n, seed, h=H, w=W):
        self.images, self.flow = _batch(seed, n, h, w)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.flow[i]


def _bn_state():
    """FlowNet2S with BatchNorm: seeded weights, and the BatchNorm scales,
    shifts and running statistics drawn off their defaults."""
    made = get_model("FlowNet2S", device="cpu", seed=5, batch_norm=True)
    rng = np.random.RandomState(6)
    state = {k: v.numpy().copy() for k, v in made.state_dict().items()}
    for key, value in state.items():
        if key.endswith((".1.weight", "running_var")):
            state[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith((".1.bias", "running_mean")):
            state[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
    return state


def _bn_model(state):
    model = MODELS["FlowNet2S"](batch_norm=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


# ------------------------------------------------------------ (a) the ops

def _conv_case(kind, k, s, cin, cout, h, w, seed):
    """(module, its NCHW input)."""
    torch.manual_seed(seed)
    if kind == "deconv":
        mod = ConvTranspose2d(cin, cout, k, s, 1)
    else:
        mod = Conv2d(cin, cout, k, s, (k - 1) // 2)
    with torch.no_grad():
        mod.bias.uniform_()
    return mod, _rand((2, cin, h, w), seed)


# name -> (kind, kernel, stride, in channels, out channels, h, w)
CONVS = {"conv7x7s2": ("conv", 7, 2, 3, 4, 64, 16),
         "conv5x5s2": ("conv", 5, 2, 4, 5, 64, 16),
         "conv3x3s1": ("conv", 3, 1, 4, 3, 64, 16),
         "deconv4x4s2": ("deconv", 4, 2, 4, 3, 32, 8)}
OPS = (*CONVS, "upsample_bilinear", "correlation", "warp_grad_flow",
       "warp_tangents")
# run again with the all-gathers made as all-reduces
SLOT_OPS = ("conv3x3s1", "correlation", "warp_grad_flow")


def _op_inputs(name, quarters=4):
    """(the op as a function of its NCHW tensors, the numpy inputs, the
    module whose weight gradient counts, or None); the inputs ``quarters``
    quarters of the op's base height high (4: the base height)."""
    def rows(base):
        return base * quarters // 4

    if name in CONVS:
        kind, k, s, cin, cout, h, w = CONVS[name]
        mod, x = _conv_case(kind, k, s, cin, cout, rows(h), w,
                            seed=OPS.index(name))
        return mod, (x,), mod
    if name == "upsample_bilinear":
        return upsample_bilinear, (_rand((2, 2, rows(16), 8), 20),), None
    if name == "correlation":
        return ((lambda a, b: correlation.correlation(a, b, 20, 1, 20, 1, 2)),
                (_rand((2, 8, rows(16), 64), 21),
                 _rand((2, 8, rows(16), 64), 22)), None)
    route = name[len("warp_"):]

    def warp(img, flow):
        with mock.patch.object(stage_glue, "TRAIN_WARP", route):
            return stage_glue._warp(img, flow.unsqueeze(1))[:, 0]
    return warp, (_rand((2, 3, rows(32), 64), 23),
                  _rand((2, 2, rows(32), 64), 24, 10.0)), None


def _op_cotangent(name, out_shape):
    return _rand(out_shape, 30 + OPS.index(name))


def _run_op(name, band=None, quarters=4):
    """The op's output, its inputs' gradients and its weight's, on the whole
    map or, under ``band``, on the band's input rows (the cotangent's rows
    follow the output's)."""
    fn, inputs, mod = _op_inputs(name, quarters)
    height = inputs[0].shape[2]
    # the band's edges are at the inputs' level
    a, b = (0, height) if band is None else band.edges[band.index]
    ts = [torch.from_numpy(np.ascontiguousarray(x[:, :, a:b]))
          .requires_grad_() for x in inputs]
    with sharding_hints.scoped_band(band):
        out = fn(*ts)
    # the cotangent is drawn at the whole map's output shape; the output's
    # rows scale with the input's
    scale = out.shape[2] / (b - a)
    g = _op_cotangent(name, (*out.shape[:2], round(height * scale),
                             out.shape[3]))
    g = g[:, :, round(a * scale):round(b * scale)]
    params = [mod.weight, mod.bias] if mod is not None else []
    grads = torch.autograd.grad(out, ts + params,
                                torch.from_numpy(np.ascontiguousarray(g)))
    return {"out": out.detach(), "grads": [t.detach() for t in grads[:len(ts)]],
            "params": [t.detach() for t in grads[len(ts):]]}


def _op_band(plan, name, unequal=False):
    """(name, this rank's band of the op's inputs, the inputs' quarters):
    equal bands of the base height, or bands at the unequal edges of
    ``UNEVEN``, a granule a quarter of the base height."""
    granules = UNEVEN[plan.spatial] if unequal else (1,) * plan.spatial
    quarters = sum(granules) if unequal else 4
    height = _op_inputs(name, quarters)[1][0].shape[2]
    stops = [height * n // sum(granules) for n in np.cumsum(granules)]
    edges = tuple(zip([0] + stops[:-1], stops))
    return (name, sharding_hints.Band(plan.spatial_group, plan.spatial,
                                      plan.band, edges), quarters)


def _rank_ops(plan):
    """Every op of (a) on this rank's band: equal bands, then bands at the
    unequal edges of ``UNEVEN``."""
    out = {}
    for name in OPS:
        out[name] = _run_op(*_op_band(plan, name))
        out[name + " (unequal)"] = _run_op(*_op_band(plan, name, True))
    out["dispatch"] = sharding_hints.dispatch_log()
    # the all-gathers as all-reduces of zeroed slots, as gloo runs them on
    # CUDA tensors
    with mock.patch.object(halo, "_gather_by_all_reduce",
                           lambda t, group: True):
        for name in SLOT_OPS:
            out[name + " (slots)"] = _run_op(*_op_band(plan, name))
            out[name + " (unequal) (slots)"] = _run_op(
                *_op_band(plan, name, True))
    return out


# ----------------------------------------------------- (b)-(e) the models

def _rank_flownet2c(plan, height=H):
    """Two FlowNet2C steps (Adam 1e-4) of two b2 batches of ``height``-row
    frames on the plan's bands."""
    model = get_model("FlowNet2C", device="cpu", seed=0)
    step = StepFactory(model, losses.MultiScale(), get_optimizer("Adam", 1e-4),
                       plan=plan).train_step()
    out = {"digests": [], "rows": plan.band_rows(height)}
    for k, seed in ((1, 1), (2, 2)):
        images, flow = _batch(seed, 2, height)
        m = step(torch.from_numpy(images), torch.from_numpy(flow))
        out["digests"].append(_digest(model))
        if k == 1:
            out["loss"] = float(m["loss"])
            if plan.rank == 0:
                out["state"] = _clone_state(model)
    return out


def _subnet_rel(got, want):
    diff2, norm2 = {}, {}
    for name, w in want.items():
        sub = name.split(".")[0]
        diff2[sub] = diff2.get(sub, 0.0) + float(
            (got[name].double() - w.double()).square().sum())
        norm2[sub] = norm2.get(sub, 0.0) + float(w.double().square().sum())
    return {sub: (diff2[sub] / norm2[sub]) ** 0.5 for sub in diff2}


def _rank_flownet2(plan):
    """FlowNet2 inference (the bands and the stripes gathered) and one train
    step's gradients at spatial 2; rank 0 first takes them in one process
    on the whole batch."""
    images, flow = (torch.from_numpy(a) for a in _batch(3, 2))
    model = get_model("FlowNet2", device="cpu", seed=0)
    if plan.rank == 0:
        model.eval()
        with torch.no_grad():
            want_flow = model(images)
        model.train()
        loss, _ = losses.MultiScale()(model(images), flow)
        loss.backward()
        want = {n: p.grad.clone() for n, p in model.named_parameters()}
        want_loss = float(loss)
        model.zero_grad(set_to_none=True)
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("SGD", 1e-4), plan=plan)
    got_flow = all_gather_batch(factory.infer_step()(images), plan)
    m = factory.train_step()(images, flow)
    out = {"digest": _digest(model)}
    if plan.rank == 0:
        out["epe"] = float(torch.sqrt(((got_flow - want_flow) ** 2)
                                      .sum(-1)).mean())
        out["flow_max"] = float(want_flow.abs().max())
        out["rel"] = _subnet_rel({n: p.grad for n, p in
                                  model.named_parameters()}, want)
        out["loss"] = (float(m["loss"]), want_loss)
    return out


def _rank_bn(plan):
    model = _bn_model(_bn_state())
    factory = StepFactory(model, losses.MultiScale(), get_optimizer("SGD", BN_LR),
                          plan=plan)
    images, flow = _batch(*BN_BATCH)
    local = BN_BATCH[1] // plan.data_size
    stripe = slice(plan.data_rank * local, (plan.data_rank + 1) * local)
    m = factory.train_step()(torch.from_numpy(images[stripe]),
                             torch.from_numpy(flow[stripe]))
    out = {"digest": _digest(model), "loss": float(m["loss"])}
    if plan.rank == 0:
        out["state"] = _clone_state(model)
    return out


def _rank_trainer(plan, root, height=H):
    """FlowNet2S validation and inference of 5 pairs of ``height``-row
    frames at batch 4; rank 0 writes the flows."""
    ds = _Pairs(5, seed=30, h=height)
    factory = StepFactory(get_model("FlowNet2S", device="cpu", seed=0),
                          losses.MultiScale(), get_optimizer("Adam", 1e-4),
                          plan=plan)
    save = root / f"trainer{plan.data_size}x{plan.spatial}_{height}"
    trainer = Trainer(factory, TrainerConfig(save_dir=str(save)))

    def loader():
        return DeviceLoader(DataLoader(
            ds, 4, drop_last=False, num_workers=1,
            process_count=plan.data_size, process_index=plan.data_rank),
            device="cpu")

    written = []
    write = flow_io.write_flo

    def counted(path, flow):
        written.append(os.path.basename(path))
        write(path, flow)

    val = trainer.validate(loader(), 0)
    with mock.patch.object(flow_io, "write_flo", counted):
        n, inf = trainer.inference(loader(), save_flow_dir=str(save / "flows"))
    return {"val": val, "infer": inf, "n": n, "written": written}


def _bf16_state():
    """FlowNet2CS's seeded weights, numpy."""
    made = get_model("FlowNet2CS", device="cpu", seed=0)
    return {k: v.numpy() for k, v in made.state_dict().items()}


def _bf16_run(plan=None):
    """(g) FlowNet2CS in bfloat16 of ``_bf16_state`` on a b2 batch at H x
    BF16_W:
    the inference flow (under a plan its bands and stripes gathered) and
    one Adam 1e-4 step's global loss, EPE and gradients; without a plan as
    two row bands on this process."""
    model = get_model("FlowNet2CS", device="cpu", dtype=torch.bfloat16)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _bf16_state().items()})
    images, flow = (torch.from_numpy(a)
                    for a in _batch(BF16_SEED, 2, w=BF16_W))
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("Adam", 1e-4), plan=plan)
    with sharding_hints.scoped_spatial_shards(1 if plan else 2):
        got = factory.infer_step()(images)
        dtype = str(got.dtype)
        if plan is not None:
            got = all_gather_batch(got.float(), plan)
        m = factory.train_step()(images, flow)
    out = {"flow": got.float(), "dtype": dtype,
           "loss": float(m["loss"]), "epe": float(m["epe"]),
           "digest": _digest(model)}
    if plan is None or plan.rank == 0:
        out["grads"] = {n: p.grad.clone()
                        for n, p in model.named_parameters()}
    return out


def _write_chairs(root, n, seed):
    """``n`` FlyingChairs-format pairs of H x W frames."""
    from PIL import Image

    from flownet2_tpu_torch.data import write_flo

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(n):
        for j in (1, 2):
            Image.fromarray(rng.randint(0, 256, (H, W, 3), np.uint8)).save(
                root / f"{i:05d}_img{j}.ppm")
        write_flo(root / f"{i:05d}_flow.flo",
                  (rng.randn(H, W, 2) * 2).astype(np.float32))


def _cli_argv(root, save, bands):
    """FlowNet2S inference of 3 FlyingChairs pairs at batch 2 (a padded
    tail of 1), --spatial_shards 2 or none."""
    return ["--model", "FlowNet2S", "--batch_size", "2", "--save", str(save),
            "--num_workers", "1", "--device", "cpu", "--inference",
            "--save_flow", "--inference_dataset", "FlyingChairs",
            "--inference_dataset_root", str(root / "chairs"),
            *(["--spatial_shards", "2"] if bands else [])]


def _rank_cli(root):
    """The command line in this rank of the running group, with
    --spatial_shards 2: the bands span the ranks."""
    from flownet2_tpu_torch.cli import main as cli_main

    sharding_hints.clear_dispatch_log()
    assert cli_main(_cli_argv(root, root / "cli_bands", True)) == 0
    return {"dispatch": sharding_hints.dispatch_log(),
            "spatial_shards": sharding_hints.spatial_shards()}


def _rank_main(rank, world, root):
    torch.set_num_threads(1)
    root = pathlib.Path(root)
    timeout = datetime.timedelta(seconds=60)
    assert init_distributed(backend="gloo", world_size=world, rank=rank,
                            init_method=f"file://{root / f'store{world}'}",
                            timeout=timeout)
    plan = DataParallelPlan.current("cpu", spatial=world, timeout=timeout)
    out = {"layout": (plan.data_size, plan.data_rank, plan.band),
           "ops": _rank_ops(plan),
           "flownet2c unequal": _rank_flownet2c(plan, UNEVEN_H[world])}
    if world == 2:
        out["flownet2c"] = _rank_flownet2c(plan)
        out["flownet2"] = _rank_flownet2(plan)
        out["trainer"] = _rank_trainer(plan, root)
        out["trainer unequal"] = _rank_trainer(plan, root, UNEVEN_H[2])
        # the one-process reference on rank 0, as (c)'s
        out["bf16"] = {"one process": _bf16_run() if plan.rank == 0
                       else None, "bands": _bf16_run(plan)}
        out["cli"] = _rank_cli(root)
    else:
        grid = DataParallelPlan.current("cpu", spatial=2, timeout=timeout)
        out["grid_layout"] = (grid.data_size, grid.data_rank, grid.band)
        out["bn"] = _rank_bn(grid)
        out["trainer"] = _rank_trainer(grid, root)
    torch.save(out, root / f"world{world}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------ the test process

def _start_ranks(root, world):
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        for v in ENV_VARS:
            env.pop(v, None)
        env.pop("PYTHONSTARTUP", None)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(root)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs):
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("a rank did not finish in time") from None
        outputs.append(out)
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            + out[-6000:]


def _jax_op(name, quarters=4, spatial=None):
    """The JAX package's op on (a)'s inputs ``quarters`` quarters of their
    base height high, on one device or, with ``spatial``, under
    ``make_mesh(spatial=spatial)`` with the inputs' rows sharded over it:
    (output, input gradients, weight gradients, the JAX dispatch log),
    NCHW numpy."""
    import importlib

    import jax
    import jax.numpy as jnp

    from flownet2_tpu.nn.layers import _tconv421
    from flownet2_tpu.parallel import scoped_mesh

    # flownet2_tpu.ops re-exports functions under some of its module names
    jax_corr, jax_r2d, jax_up, jax_hints = (
        importlib.import_module(f"flownet2_tpu.ops.{m}")
        for m in ("correlation", "resample2d", "upsample", "sharding_hints"))

    def nhwc(x):
        return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))

    def nchw(x):
        return np.asarray(x).transpose(0, 3, 1, 2)

    fn, inputs, mod = _op_inputs(name, quarters)
    params = []
    if name in CONVS:
        kind, k, s = CONVS[name][:3]
        w = mod.weight.detach().numpy()
        b = jnp.asarray(mod.bias.detach().numpy())
        if kind == "deconv":
            # the JAX layer's storage: the flipped torch kernel, HWIO
            params = [jnp.asarray(np.ascontiguousarray(
                w.transpose(2, 3, 0, 1)[::-1, ::-1])), b]

            def f(x, kf, bias):
                return _tconv421(x, kf, True) + bias
        else:
            p = (k - 1) // 2
            params = [jnp.asarray(w.transpose(2, 3, 1, 0)), b]

            def f(x, kern, bias):
                return jax.lax.conv_general_dilated(
                    x, kern, (s, s), [(p, p), (p, p)],
                    dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    elif name == "upsample_bilinear":
        f = jax_up.upsample_bilinear
    elif name == "correlation":
        def f(a, b):
            return jax_corr.correlation(a, b, 20, 1, 20, 1, 2)
    else:
        def f(img, flow):
            return jax_r2d.resample2d(img, flow, 1, True)
    args = [nhwc(x) for x in inputs]
    with contextlib.ExitStack() as stack:
        if spatial is not None:
            mesh = stack.enter_context(scoped_mesh(jax.devices()[:spatial],
                                                   spatial=spatial))
            rows = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("data", "spatial"))
            args = [jax.device_put(a, rows) for a in args]
            f = jax.jit(f)
        jax_hints.clear_dispatch_log()
        out, vjp = jax.vjp(f, *args, *params)
        g = _op_cotangent(name, nchw(out).shape)
        grads = vjp(jnp.asarray(np.ascontiguousarray(
            g.transpose(0, 2, 3, 1))))
        log = jax_hints.dispatch_log()
    d_params = []
    if params:
        d_k = np.asarray(grads[len(args)])
        d_params = [d_k[::-1, ::-1].transpose(2, 3, 0, 1)
                    if CONVS[name][0] == "deconv"
                    else d_k.transpose(3, 2, 0, 1), np.asarray(grads[-1])]
    return (nchw(out), [nchw(d) for d in grads[:len(args)]], d_params,
            log)


def _jax_step(state_np, images, flow, model, model_name, spatial, n_devices,
              optimizer):
    """One step of the JAX model on one device (``n_devices`` None) or on
    a (n_devices / spatial, spatial) mesh: (state dict, loss)."""
    import jax
    import jax.numpy as jnp
    from flownet2_tpu.checkpoints.torch_import import state_dict_to_variables
    from flownet2_tpu.losses import MultiScale
    from flownet2_tpu.parallel import MeshPlan, scoped_mesh
    from flownet2_tpu.train import StepFactory as JaxStepFactory
    from flownet2_tpu.train import TrainState
    from flownet2_tpu.train import get_optimizer as jax_get_optimizer
    from flownet2_tpu_torch.checkpoints import from_jax_variables

    tx = jax_get_optimizer(*optimizer)
    state = TrainState.create(jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_variables(state_np, model_name)), tx)
    if n_devices is None:
        new, m = JaxStepFactory(model, MultiScale(), tx).train_step()(
            state, jnp.asarray(images), jnp.asarray(flow))
    else:
        with scoped_mesh(jax.devices()[:n_devices], spatial=spatial) as mesh:
            plan = MeshPlan(mesh)
            new, m = JaxStepFactory(model, MultiScale(), tx,
                                    plan=plan).train_step()(
                jax.device_put(state, plan.replicated),
                jax.device_put(jnp.asarray(images), plan.batch_images),
                jax.device_put(jnp.asarray(flow), plan.batch_flow))
    v = {"params": jax.tree_util.tree_map(np.asarray, new.params)}
    if new.batch_stats is not None:
        v["batch_stats"] = jax.tree_util.tree_map(np.asarray, new.batch_stats)
    return from_jax_variables(v, model_name), float(m["loss"])


def _bn_precision(state, images, flow):
    """The worst tensor's max |difference| over its max |gradient| between
    the one-process FlowNet2S-with-BatchNorm gradients in float32 and in
    float64, on the sub-net (``normalize_pair`` computes in float32)."""
    from flownet2_tpu_torch.models.flownet_s import FlowNetS

    def grads(dtype):
        model = _bn_model(state).to(dtype).train()
        x = torch.from_numpy(images).to(dtype)
        x = (x - x.mean(dim=(2, 3), keepdim=True).mean(dim=1, keepdim=True)
             ) / 255.0
        x = torch.cat([x[:, 0], x[:, 1]], dim=-1).permute(0, 3, 1, 2)
        out = tuple(f.permute(0, 2, 3, 1) for f in FlowNetS.forward(model, x))
        losses.MultiScale()(out, torch.from_numpy(flow).to(dtype))[0] \
            .backward()
        return {n: p.grad.double() for n, p in model.named_parameters()}
    a, b = grads(torch.float32), grads(torch.float64)
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max())
               for k in b)


def _port_trainer(root, height=H):
    """The Trainer's means and flows of (e) in one process."""
    ds = _Pairs(5, seed=30, h=height)
    factory = StepFactory(get_model("FlowNet2S", device="cpu", seed=0),
                          losses.MultiScale(), get_optimizer("Adam", 1e-4))
    trainer = Trainer(factory, TrainerConfig(
        save_dir=str(root / f"single_{height}")))

    def loader():
        return DeviceLoader(DataLoader(ds, 4, drop_last=False, num_workers=1),
                            device="cpu")
    val = trainer.validate(loader(), 0)
    _, inf = trainer.inference(loader())
    infer = factory.infer_step()
    flows = torch.cat([infer(torch.from_numpy(ds.images[i:i + 4]))
                       for i in range(0, len(ds), 4)])
    return {"val": val, "infer": inf, "flows": flows}


def _port_flownet2c(height):
    """FlowNet2C's first step of ``_rank_flownet2c`` in one process on the
    whole map: (state dict, loss)."""
    model = get_model("FlowNet2C", device="cpu", seed=0)
    images, flow = _batch(1, 2, height)
    m = StepFactory(model, losses.MultiScale(), get_optimizer("Adam", 1e-4)
                    ).train_step()(torch.from_numpy(images),
                                   torch.from_numpy(flow))
    return _clone_state(model), float(m["loss"])


def _jax_bf16_flow():
    """(g) The JAX package's FlowNet2CS in bfloat16 on one device, of the
    same weights and batch: the flow, float32 numpy."""
    import jax
    import jax.numpy as jnp
    from flownet2_tpu.checkpoints.torch_import import state_dict_to_variables
    from flownet2_tpu.models import FlowNet2CS as JaxFlowNet2CS

    variables = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_variables(_bf16_state(), "FlowNet2CS"))
    images, _ = _batch(BF16_SEED, 2, w=BF16_W)
    flow = jax.jit(JaxFlowNet2CS(dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(images))
    return np.asarray(flow.astype(jnp.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results (two ranks and four) and the references: the JAX
    package's before the ranks start, the port's in one process while they
    run.  The temporary directory goes once the module's tests are done."""
    from flownet2_tpu.models import FlowNet2C as JaxFlowNet2C
    from flownet2_tpu.models import FlowNet2S as JaxFlowNet2S

    root = tmp_path_factory.mktemp("spatial_ranks")
    _write_chairs(root / "chairs", 3, seed=50)
    ref = {"jax": {name: _jax_op(name) for name in OPS},
           "jax unequal": {world: {name: _jax_op(
               name, sum(UNEVEN[world]), spatial=world) for name in OPS}
               for world in (2, 4)}}
    # (b) the JAX FlowNet2C step, one device and the spatial mesh; and one
    # device at the unequal bands' heights
    model = get_model("FlowNet2C", device="cpu", seed=0)
    state_np = {k: v.numpy() for k, v in model.state_dict().items()}
    images, flow = _batch(1, 2)
    ref["flownet2c"] = {
        kind: _jax_step(state_np, images, flow, JaxFlowNet2C(), "FlowNet2C",
                        2, n, ("Adam", 1e-4))
        for kind, n in (("one device", None), ("spatial=2", 2))}
    ref["flownet2c unequal"] = {
        world: {"JAX one device": _jax_step(
            state_np, *_batch(1, 2, height), JaxFlowNet2C(), "FlowNet2C",
            world, None, ("Adam", 1e-4))}
        for world, height in UNEVEN_H.items()}
    # (d) the JAX step with BatchNorm, one device and the (2, 2) mesh
    images, flow = _batch(*BN_BATCH)
    bn_state = _bn_state()
    ref["bn"], ref["bn_mesh"] = (
        _jax_step(bn_state, images, flow, JaxFlowNet2S(batch_norm=True),
                  "FlowNet2S", 2, n, ("SGD", BN_LR)) for n in (None, 4))
    # (g) the JAX bf16 model
    ref["bf16 jax"] = _jax_bf16_flow()

    procs = {w: _start_ranks(root, w) for w in (2, 4)}
    try:
        ref["whole"] = {name: _run_op(name) for name in OPS}
        ref["whole unequal"] = {world: {name: _run_op(
            name, quarters=sum(UNEVEN[world])) for name in OPS}
            for world in (2, 4)}
        for world, height in UNEVEN_H.items():
            ref["flownet2c unequal"][world]["one process"] = \
                _port_flownet2c(height)
        # (d) the samples a channel of each BatchNorm sees in the global
        # batch
        ref["bn_f64"] = _bn_precision(bn_state, images, flow)
        ref["bn_before"] = bn_state
        seen = {}
        local = _bn_model(bn_state).train()
        for name, mod in local.named_modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.register_forward_pre_hook(
                    lambda m, a, name=name: seen.__setitem__(
                        name, a[0].numel() // a[0].shape[1]))
        with torch.no_grad():
            local(torch.from_numpy(images))
        ref["bn_n"] = seen
        ref["trainer"] = _port_trainer(root)
        ref["trainer unequal"] = _port_trainer(root, UNEVEN_H[2])
        from flownet2_tpu_torch.cli import main as cli_main
        assert cli_main(_cli_argv(root, root / "cli_one", False)) == 0
    finally:
        for p in procs.values():
            _join(p)
    got = {}
    for w in (2, 4):
        got[w] = []
        for r in range(w):
            path = root / f"world{w}_rank{r}.pt"
            got[w].append(torch.load(path, weights_only=False))
    yield {"root": root, "ref": ref, "ranks": got}
    shutil.rmtree(root, ignore_errors=True)


def _bands(ranks, name, part, index=None):
    """The ranks' bands of an op's output or gradient, concatenated along
    the height."""
    pieces = [r["ops"][name][part] if index is None
              else r["ops"][name][part][index] for r in ranks]
    return torch.cat(pieces, dim=2)


# ------------------------------------------------------------------ cases

# (a)'s band layouts: equal bands of 2 and 4 ranks, and the unequal edges
# of UNEVEN on the same ranks
LAYOUTS = [2, 4, pytest.param((2, "unequal"), id="2-unequal"),
           pytest.param((4, "unequal"), id="4-unequal")]


def _layout(world):
    """(ranks, the suffix of the ops' keys) of a LAYOUTS entry."""
    return (world, "") if isinstance(world, int) else (world[0],
                                                       " (unequal)")


@pytest.mark.parametrize("world", LAYOUTS)
@pytest.mark.parametrize("name", OPS)
def test_op_bands_match_the_whole_map_and_jax(ranks, name, world):
    """(a) An op as ``world`` bands, one a rank, equal or at the unequal
    edges of UNEVEN: its output and its inputs' gradients, concatenated
    over the bands, within 1e-5 of the port's whole-map op and of the JAX
    op (at unequal edges the JAX op under ``make_mesh(spatial=world)``, its
    band composition where it has one); a convolution's weight and bias
    gradients, summed over the bands, likewise.  The correlation's forward
    and d_f1 and the warp's forward and flow gradient bit-equal to the
    whole map's rows."""
    world, suffix = _layout(world)
    got = ranks["ranks"][world]
    if suffix:
        whole = ranks["ref"]["whole unequal"][world][name]
        jax_out, jax_grads, jax_params, jax_log = \
            ranks["ref"]["jax unequal"][world][name]
        if name == "correlation" or name.startswith("warp"):
            op = "correlation" if name == "correlation" else "resample2d"
            assert "halo" in jax_log[op], jax_log
    else:
        whole = ranks["ref"]["whole"][name]
        jax_out, jax_grads, jax_params, _ = ranks["ref"]["jax"][name]
    name += suffix
    out = _bands(got, name, "out")
    grads = [_bands(got, name, "grads", i) for i in range(len(whole["grads"]))]
    for what, a, b in [("out", out, whole["out"]),
                       *((f"grad {i}", a, b) for i, (a, b) in
                         enumerate(zip(grads, whole["grads"])))]:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {what}, whole map")
    for what, a, b in [("out", out, jax_out),
                       *((f"grad {i}", a, b) for i, (a, b) in
                         enumerate(zip(grads, jax_grads)))]:
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {what}, JAX")
    if name[:len(name) - len(suffix)] in CONVS:
        # sums of thousands of products: 1e-5 of the largest magnitude
        summed = [sum(r["ops"][name]["params"][i] for r in got)
                  for i in range(2)]
        for a, b, c in zip(summed, whole["params"], jax_params):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=TOL * scale)
            np.testing.assert_allclose(a.numpy(), c, rtol=0, atol=TOL * scale)
    if name.startswith(("correlation", "warp")):
        assert torch.equal(out, whole["out"])
        k = 0 if name.startswith("correlation") else 1
        assert torch.equal(grads[k], whole["grads"][k])
    log = got[0]["ops"]["dispatch"]
    assert log["correlation"] == \
        f"process group(spatial={world})+halo-slab, kernel=plain"
    assert log["resample2d"] == \
        f"process group(spatial={world})+halo-gather, kernel=plain"
    assert log["convolution"] == f"process group(spatial={world})+halo rows"


@pytest.mark.parametrize("world", LAYOUTS)
@pytest.mark.parametrize("name", SLOT_OPS)
def test_gathers_by_all_reduce_are_the_all_gathers(ranks, name, world):
    """(a) The all-gathers made as all-reduces of zeroed slots (as gloo
    runs them on CUDA tensors), at equal and at unequal edges (the bands
    padded to the tallest): every output and gradient bit-equal to the
    all-gathers'."""
    world, suffix = _layout(world)
    for r in ranks["ranks"][world]:
        a, b = r["ops"][name + suffix], r["ops"][name + suffix + " (slots)"]
        for part in ("out", "grads", "params"):
            x, y = ([a[part]], [b[part]]) if part == "out" else (a[part],
                                                                  b[part])
            assert len(x) == len(y)
            assert all(torch.equal(u, v) for u, v in zip(x, y)), part


def test_flownet2c_step_matches_jax_one_device_and_spatial_mesh(ranks):
    """(b) One Adam 1e-4 step of FlowNet2C at spatial 2: every parameter
    within 1e-5 and the global loss within 1e-5 relative of the JAX step on
    one device and on the (1, 2) mesh."""
    got = ranks["ranks"][2][0]["flownet2c"]
    before = get_model("FlowNet2C", device="cpu", seed=0).state_dict()
    for what, (state, loss) in ranks["ref"]["flownet2c"].items():
        assert got["loss"] == pytest.approx(loss, rel=TOL), what
        worst = max(float((got["state"][k] - v).abs().max())
                    for k, v in state.items())
        assert worst < TOL, (what, worst)
    assert all(not torch.equal(got["state"][k], before[k]) for k in before)


def test_flownet2c_ranks_stay_bit_equal(ranks):
    """(b) After each of two steps both bands hold the same bits and report
    the same global loss."""
    a, b = (r["flownet2c"] for r in ranks["ranks"][2])
    assert a["digests"] == b["digests"]
    assert a["digests"][0] != a["digests"][1]
    assert a["loss"] == b["loss"]


@pytest.mark.parametrize("world", [2, 4])
def test_flownet2c_step_at_unequal_bands_matches_jax_and_one_process(
        ranks, world):
    """(b) One Adam 1e-4 step of FlowNet2C at unequal bands, 192 rows over 2
    ranks (128, 64) and 320 over 4 (128, 64, 64, 64), each rank's loss
    weighted by S times its share of the rows: every parameter within 1e-5
    and the global loss within 1e-5 relative of the JAX step on one device
    and of the port's step in one process on the whole map."""
    got = ranks["ranks"][world][0]["flownet2c unequal"]
    height = UNEVEN_H[world]
    assert [r["flownet2c unequal"]["rows"] for r in ranks["ranks"][world]] \
        == [slice(*e) for e in sharding_hints.band_edges(height, world)]
    before = get_model("FlowNet2C", device="cpu", seed=0).state_dict()
    for what, (state, loss) in ranks["ref"]["flownet2c unequal"][
            world].items():
        assert got["loss"] == pytest.approx(loss, rel=TOL), what
        worst = max(float((got["state"][k] - v).abs().max())
                    for k, v in state.items())
        assert worst < TOL, (what, worst)
    assert all(not torch.equal(got["state"][k], before[k]) for k in before)


@pytest.mark.parametrize("world", [2, 4])
def test_flownet2c_ranks_stay_bit_equal_at_unequal_bands(ranks, world):
    """(b) At unequal bands, after each of two steps every band holds the
    same bits and reports the same global loss."""
    got = [r["flownet2c unequal"] for r in ranks["ranks"][world]]
    assert all(g["digests"] == got[0]["digests"] for g in got)
    assert got[0]["digests"][0] != got[0]["digests"][1]
    assert len({g["loss"] for g in got}) == 1


def test_flownet2_bands_match_one_process(ranks):
    """(c) FlowNet2 at 128x64 as two bands: the inference flow, gathered,
    within EPE 1e-4 of one process's; the train step's global loss within
    1e-5 relative and its gradients per sub-net within 1e-4 in relative L2
    (flownetc and flownets_1 printed only); the ranks bit-equal after the
    step."""
    got = ranks["ranks"][2][0]["flownet2"]
    assert got["flow_max"] > 1
    assert got["epe"] < 1e-4, got["epe"]
    loss, want = got["loss"]
    assert loss == pytest.approx(want, rel=TOL)
    print("FlowNet2 as two bands, gradients per sub-net in relative L2:",
          got["rel"])
    for sub, rel in got["rel"].items():
        if sub not in ("flownetc", "flownets_1"):
            assert rel < 1e-4, (sub, rel)
    assert len(got["rel"]) == 5
    assert got["digest"] == ranks["ranks"][2][1]["flownet2"]["digest"]


def test_batch_norm_two_by_two_matches_jax(ranks):
    """(d) FlowNet2S with BatchNorm on data 2 x spatial 2: the parameters
    and the running statistics after one step (SGD at lr 1) match the JAX
    step on one device, the running statistics within 1e-5 (torch's
    unbiased running variance scaled to Flax's biased one over the global
    batch's samples) and the parameters within 2e-5 (``BN_PARAM_TOL``); the
    four ranks bit-equal.  The batch's one-process float32 step is within
    2e-5 of its float64 step, asserted (else float32 cannot resolve the
    comparison).  The JAX (2, 2) mesh's distance is printed."""
    print("FlowNet2S with BatchNorm, one step: float32 from float64 in one "
          "process", ranks["ref"]["bn_f64"])
    assert ranks["ref"]["bn_f64"] < 2e-5, ranks["ref"]["bn_f64"]
    got = [r["bn"] for r in ranks["ranks"][4]]
    want, want_loss = ranks["ref"]["bn"]
    mesh = ranks["ref"]["bn_mesh"][0]
    print("FlowNet2S with BatchNorm, one SGD step: the JAX (2, 2) mesh from "
          "the JAX one-device step, largest |difference|",
          max(float((mesh[k] - v).abs().max()) for k, v in want.items()
              if not k.endswith("num_batches_tracked")))
    before, n = ranks["ref"]["bn_before"], ranks["ref"]["bn_n"]
    assert len({g["digest"] for g in got}) == 1
    assert all(g["loss"] == pytest.approx(want_loss, rel=TOL) for g in got)

    def expected(key):
        if not key.endswith("running_var"):
            return want[key].numpy()
        kept = 0.9 * before[key]
        count = n[key[:-len(".running_var")]]
        return kept + (want[key].numpy() - kept) * count / (count - 1)

    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * len(n) > 0
    for key in (k for k in want if not k.endswith("num_batches_tracked")):
        tol = TOL if key in stats else BN_PARAM_TOL
        np.testing.assert_allclose(got[0]["state"][key].numpy(),
                                   expected(key), rtol=tol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("world", [2, 4, pytest.param(
    (2, "unequal"), id="2-unequal")])
def test_trainer_counts_each_sample_once(ranks, world):
    """(e) Validation and inference of 5 pairs at batch 4 at spatial 2
    (world 2), at 2 x 2 (world 4) and at spatial 2 on 192-row frames
    (bands of 128 and 64 rows): the means within 1e-5 of one process's over
    5 samples on every rank; rank 0 alone writes the 5 .flo files,
    gathered over the bands and the stripes, each within 1e-5 of one
    process's flow."""
    world, unequal = _layout(world)
    case = "trainer unequal" if unequal else "trainer"
    height = UNEVEN_H[world] if unequal else H
    ref = ranks["ref"][case]
    for r in ranks["ranks"][world]:
        got = r[case]
        for what in ("val", "infer"):
            assert got[what]["n_samples"] == ref[what]["n_samples"] == 5
            for key in ("loss", "epe"):
                assert got[what][key] == pytest.approx(ref[what][key],
                                                       rel=TOL)
        assert got["n"] == 5
    names = [f"{i:06d}.flo" for i in range(5)]
    assert ranks["ranks"][world][0][case]["written"] == names
    assert all(r[case]["written"] == []
               for r in ranks["ranks"][world][1:])
    layout = "trainer1x2" if world == 2 else "trainer2x2"
    flows_dir = ranks["root"] / f"{layout}_{height}" / "flows"
    assert sorted(os.listdir(flows_dir)) == names
    for name, want in zip(names, ref["flows"]):
        np.testing.assert_allclose(read_flo(flows_dir / name), want.numpy(),
                                   rtol=TOL, atol=TOL)


def _contract(got, want, what):
    """The JAX package's bf16 contract (tests/test_models.py
    ``TestBf16Precision``): mean |got - want| < 0.05 (mean |want| + 1e-3)
    + 5e-3, with the relative L2 printed."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).mean()
    limit = 0.05 * (np.abs(want).mean() + 1e-3) + 5e-3
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{what}: mean error {err:.4g} against {limit:.4g}, relative L2 "
          f"{rel:.3e}")
    assert np.isfinite(got).all()
    assert err < limit, (what, err, limit)


def test_bf16_flownet2cs_bands_across_ranks(ranks):
    """(g) FlowNet2CS in bfloat16 at 128x128 as two bands across two ranks
    (bf16 halos, gathers and their all-reduced transposes): the inference flow, gathered, bf16, within the JAX
    package's bf16 contract of the one-process bf16 model as two bands and
    of the JAX bf16 model; one Adam step's global loss and EPE within 5e-3
    relative and flownets_1's gradients within 5e-2 in relative L2 of the
    one-process step as two bands (``tests/test_torch_bf16_spatial.py``'s
    gates); the ranks bit-equal after it.  flownetc's gradients are printed
    only: the bands' bf16 convolutions round otherwise than the whole
    map's, so the two forwards differ in the last bit (some 30% of the
    flow's values), and flownetc's bf16 gradient sits on the noise line
    (ROADMAP.md section 3): in one process, inputs moved by 0.01 of a
    pixel level move it by 0.45 in relative L2 and flownets_1's by 4e-3."""
    got = [r["bf16"]["bands"] for r in ranks["ranks"][2]]
    want = ranks["ranks"][2][0]["bf16"]["one process"]
    assert got[0]["dtype"] == want["dtype"] == "torch.bfloat16"
    flow = got[0]["flow"]
    assert flow.shape == (2, H, BF16_W, 2)
    assert float(flow.abs().max()) > 1
    print("bf16 FlowNet2CS across ranks against one process's bands: "
          f"{float((flow != want['flow']).float().mean()):.4%} not "
          "bit-equal")
    _contract(flow.numpy(), want["flow"].numpy(),
              "bf16 FlowNet2CS, two ranks against one process's two bands")
    _contract(flow.numpy(), ranks["ref"]["bf16 jax"],
              "bf16 FlowNet2CS, two ranks against the JAX bf16 model")
    for key in ("loss", "epe"):
        assert got[0][key] == got[1][key]
        np.testing.assert_allclose(got[0][key], want[key], rtol=5e-3)
    rels = _subnet_rel(got[0]["grads"], want["grads"])
    print(f"bf16 FlowNet2CS step across ranks, relative L2: {rels}")
    assert rels["flownets_1"] <= 5e-2, rels
    assert got[0]["digest"] == got[1]["digest"]


def test_command_line_bands_span_the_ranks(ranks):
    """(f) The command line as two ranks of a running group with
    --spatial_shards 2: the bands span the ranks (every op took its
    process-group form, the one-process band count stayed 1), and its 3
    flows are within EPE 1e-5 of the command line in one process."""
    for r in ranks["ranks"][2]:
        got = r["cli"]
        assert got["spatial_shards"] == 1
        assert got["dispatch"]["convolution"] == \
            "process group(spatial=2)+halo rows"
        assert got["dispatch"]["transposed convolution"] == \
            "process group(spatial=2)+halo rows"
    names = [f"{i:06d}.flo" for i in range(3)]
    dirs = [ranks["root"] / d / "inference" / "flows"
            for d in ("cli_bands", "cli_one")]
    assert [sorted(os.listdir(d)) for d in dirs] == [names, names]
    for name in names:
        a, b = (read_flo(d / name) for d in dirs)
        assert np.abs(b).max() > 1
        assert float(np.sqrt(((a - b) ** 2).sum(-1)).mean()) < TOL, name


def test_rank_layout_is_the_jax_mesh(ranks):
    """(f) Rank r is data rank r // S and band r % S, as
    ``make_mesh(spatial=S)`` reshapes its devices to (n / S, S)."""
    assert [r["layout"] for r in ranks["ranks"][2]] == [(1, 0, 0), (1, 0, 1)]
    assert [r["layout"] for r in ranks["ranks"][4]] == [
        (1, 0, 0), (1, 0, 1), (1, 0, 2), (1, 0, 3)]
    assert [r["grid_layout"] for r in ranks["ranks"][4]] == [
        (2, 0, 0), (2, 0, 1), (2, 1, 0), (2, 1, 1)]
    plans = [DataParallelPlan(8, r, r, torch.device("cpu"), 2)
             for r in range(8)]
    assert [(p.data_rank, p.band) for p in plans] == [
        (r // 2, r % 2) for r in range(8)]
    assert plans[3].local_batch_size(8) == 2
    assert [p.valid_in_stripe(5, 2) for p in plans] == [2, 2, 2, 2, 1, 1,
                                                        0, 0]
    assert plans[3].band_rows(384) == slice(192, 384)
    # bands on granules of 64 rows, the first ones taller: 384 at spatial 4
    # is 128, 128, 64, 64
    fours = [DataParallelPlan(4, r, r, torch.device("cpu"), 4)
             for r in range(4)]
    assert [p.band_rows(384) for p in fours] == [
        slice(0, 128), slice(128, 256), slice(256, 320), slice(320, 384)]


def test_height_rule_raises():
    """(f) The bands are cut on granules of 64 rows: 384 rows over 4 give
    128, 128, 64, 64 and 448 over 2 give 256, 192, from the plan and from
    the rule itself; 320 rows over 8 (five granules for eight bands) and
    100 over 2 (not a multiple of 64) raise ValueError naming the height,
    the bands and the rule; a plan of 3 ranks does not take 2 bands."""
    plan = DataParallelPlan(4, 1, 1, torch.device("cpu"), 4)
    assert plan.band_rows(384) == slice(128, 256)
    assert sharding_hints.band_edges(384, 4) == (
        (0, 128), (128, 256), (256, 320), (320, 384))
    assert sharding_hints.band_edges(448, 2) == ((0, 256), (256, 448))
    assert DataParallelPlan(2, 1, 1, torch.device("cpu"), 2).band_rows(
        448) == slice(256, 448)
    with pytest.raises(ValueError, match=r"320 rows over 8 row bands.*64"):
        DataParallelPlan(8, 1, 1, torch.device("cpu"), 8).band_rows(320)
    with pytest.raises(ValueError, match="multiple of 64"):
        sharding_hints.band_edges(100, 2)
    with pytest.raises(ValueError, match="spatial=2"):
        DataParallelPlan(3, 0, 0, torch.device("cpu"), 2)


def test_command_line_rank_count_with_spatial_shards(monkeypatch):
    """(f) The plain command with --device cuda and --spatial_shards 2
    starts data_ranks(batch, cards, 2) * 2 ranks: 4 on 4 cards at batch 8,
    2 on 2, 2 at batch 1 on 4 cards; none on 1 card; on fewer cards than
    bands, the data ranks alone (the bands in turn on each card)."""
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)

    def count(*argv, cards=4):
        args = build_parser(list(argv)).parse_args(list(argv))
        with mock.patch.object(torch.cuda, "device_count",
                               return_value=cards):
            return _ranks_to_start(args)

    assert count("--batch_size", "8", "--spatial_shards", "2") == 4
    assert count("--batch_size", "8", "--spatial_shards", "2", cards=2) == 2
    assert count("--batch_size", "1", "--spatial_shards", "2") == 2
    assert count("--batch_size", "8", "--spatial_shards", "2", cards=1) == 1
    assert count("--batch_size", "8", "--spatial_shards", "4", cards=2) == 2
    assert count("--batch_size", "8", "--spatial_shards", "2", "--device",
                 "cpu") == 1
    assert data_ranks(8, 4, 2) == 2 and data_ranks(6, 8, 2) == 3


if __name__ == "__main__":  # a rank of the multi-process cases
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
