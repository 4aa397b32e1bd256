"""Data parallel over processes (``flownet2_tpu_torch/parallel``, the
``plan`` of ``StepFactory``, the Trainer, the loader's stripes, the
checkpoints and the command line) against the JAX package's ``data`` mesh
axis and against one process, on the CPU.

The multi-process cases run two ranks as child processes over gloo.  They
meet through a ``file://`` store in the test's temporary directory, so that
test workers cannot collide on a port; the process group has a 60 s
timeout and each join a limit of its own, so a hang fails the test.  Each
rank runs this file as a script (``_rank_main``): one launch does every
case's part in turn and saves what it got with ``torch.save``.  While the
ranks run, the test process computes the references: the JAX step on a
two-device mesh and on one device, the JAX Trainer's validation and
inference means, and the port in one process.

JAX is imported inside the functions that use it, so that the ranks, which
run this file as a script, import none of it.

Cases: FlowNet2S at 64x64, global batch 8, Adam 1e-4, two ranks of 4
(parameters within 1e-5 and the loss within 1e-5 relative of the JAX mesh
step, the JAX single-device step and the port's one-process step; the ranks
bit-equal after each of two steps); FlowNet2S with BatchNorm (the global
batch's statistics, as on the JAX mesh, where a rank's own would miss);
every parameter of the six models gets a gradient (DDP runs without
``find_unused_parameters``); the loader's stripes; validation and
inference on 13 pairs at batch 8 (a padded tail of 5); a run killed after
epoch 0 and resumed on both ranks; the command line under torchrun's
environment against the command line in one process, and the command
handing its ranks to torchrun.
"""

import datetime
import json
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
from flownet2_tpu_torch.checkpoints import native as ckpt_native  # noqa: E402
from flownet2_tpu_torch.cli import main as cli_main  # noqa: E402
from flownet2_tpu_torch.cli.main import (_ranks_to_start,  # noqa: E402
                                         _start_ranks as cli_start_ranks,
                                         build_parser)
from flownet2_tpu_torch.data import (DataLoader, DeviceLoader,  # noqa: E402
                                     flow_io, read_flo, write_flo)
from flownet2_tpu_torch.models import MODELS, get_model  # noqa: E402
from flownet2_tpu_torch.parallel import (ENV_VARS,  # noqa: E402
                                         DataParallelPlan, data_ranks,
                                         init_distributed)
from flownet2_tpu_torch.train import (StepFactory, Trainer,  # noqa: E402
                                      TrainerConfig, get_optimizer)

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

WORLD = 2
B, H, W = 8, 64, 64
LOCAL = B // WORLD
TOL = 1e-5
JOIN_S = 240


def _batch(seed, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 2, h, w, 3).astype(np.float32) * 255.0,
            rng.randn(b, h, w, 2).astype(np.float32) * 2)


def _stripe(array, rank):
    return torch.from_numpy(array[rank * LOCAL:(rank + 1) * LOCAL].copy())


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


class _Pairs:
    """``n`` seeded pairs in memory (no file, no native decoder)."""

    def __init__(self, n, seed, h=H, w=W):
        self.images, self.flow = _batch(seed, n, h, w)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.flow[i]


class _Tiny(torch.nn.Module):
    """A flow from the first frame's first two channels: one convolution,
    for the checkpoint case, which needs a model and not FlowNet2S's
    cost."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 2, 3, padding=1)

    def forward(self, images):
        x = images[:, 0, :, :, :2].permute(0, 3, 1, 2) / 255.0
        return self.conv(x).permute(0, 2, 3, 1)


def _clone_state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _adam_state(factory):
    inner = factory.optimizer.inner.state_dict()["state"]
    return [v.clone() for k in sorted(inner)
            for _, v in sorted(inner[k].items())]


def _write_chairs(root, n, seed, h=80, w=160):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    from PIL import Image
    for i in range(n):
        for j in (1, 2):
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                root / f"{i:05d}_img{j}.ppm")
        write_flo(root / f"{i:05d}_flow.flo",
                  (rng.randn(h, w, 2) * 2).astype(np.float32))


def _cli_argv(root, save, inference=False):
    """FlowNet2S at batch 4: one epoch on 8 FlyingChairs pairs (crops of
    64x128) with validation on 5 (a padded tail of 1), or inference of
    the 5 from the trained run's weights."""
    common = ["--model", "FlowNet2S", "--batch_size", "4", "--save",
              str(save), "--num_workers", "1", "--device", "cpu"]
    if inference:
        return common + ["--inference", "--save_flow",
                         "--inference_dataset", "FlyingChairs",
                         "--inference_dataset_root", str(root / "val"),
                         "--resume", str(save.parent / "cli_train")]
    return common + ["--total_epochs", "1", "--validation_frequency", "1",
                     "--training_dataset", "FlyingChairs",
                     "--training_dataset_root", str(root / "train"),
                     "--training_dataset_is_cropped", "--crop_size", "64",
                     "128", "--validation_dataset", "FlyingChairs",
                     "--validation_dataset_root", str(root / "val")]


# --------------------------------------------------------------- the ranks

def _rank_steps(plan):
    """Two FlowNet2S steps on this rank's stripes of two global batches."""
    model = get_model("FlowNet2S", device="cpu", seed=0)
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("Adam", 1e-4), plan=plan)
    step = factory.train_step()
    out = {}
    for k, seed in ((1, 1), (2, 2)):
        images, flow = _batch(seed)
        m = step(_stripe(images, plan.rank), _stripe(flow, plan.rank))
        out[f"step{k}"] = {"state": _clone_state(model),
                           "loss": float(m["loss"]), "epe": float(m["epe"])}
    return out


# The BatchNorm case steps by SGD at lr 1, so that the parameters after the
# step carry the gradients themselves.  Adam's first step, lr g/(|g| + eps),
# makes a full step of a gradient of rounding size: the JAX package's own
# one-device and mesh steps of this model and batch under Adam 1e-4 put one
# conv2 weight, whose gradient is 1.7e-10, 2.5e-5 apart.
BN_LR = 1.0


def _rank_bn(plan):
    model = _bn_model(_bn_state())
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("SGD", BN_LR), plan=plan)
    images, flow = _batch(3)
    m = factory.train_step()(_stripe(images, plan.rank),
                             _stripe(flow, plan.rank))
    return {"state": _clone_state(model), "loss": float(m["loss"])}


def _rank_loader(ds, batch, plan, **kw):
    return DeviceLoader(DataLoader(ds, batch, num_workers=1,
                                   process_count=plan.world_size,
                                   process_index=plan.rank, **kw),
                        device="cpu")


def _rank_val_infer(plan, root):
    """Validation and inference of 13 pairs at batch 8, the .flo files
    written and counted on each rank."""
    ds = _Pairs(13, seed=30)
    factory = StepFactory(get_model("FlowNet2S", device="cpu", seed=0),
                          losses.MultiScale(), get_optimizer("Adam", 1e-4),
                          plan=plan)
    trainer = Trainer(factory, TrainerConfig(save_dir=str(root / "trainer")))
    val = trainer.validate(_rank_loader(ds, B, plan, drop_last=False), 0)
    written = []
    write = flow_io.write_flo

    def counted(path, flow):
        written.append(os.path.basename(path))
        write(path, flow)

    with mock.patch.object(flow_io, "write_flo", counted):
        n, inf = trainer.inference(_rank_loader(ds, B, plan, drop_last=False),
                                   save_flow_dir=str(root / "flows"))
    return {"val": val, "infer": inf, "n": n, "written": written}


def _rank_checkpoints(plan, root):
    """Run A, two epochs; run B, epoch 0, then a new factory and Trainer
    resumed from B's checkpoint for epoch 1; the checkpoint writes each
    rank made."""
    train, val = _Pairs(16, seed=40, h=8, w=8), _Pairs(6, seed=41, h=8, w=8)
    writes = []
    write = ckpt_native._write

    def counted(*args, **kwargs):
        writes.append(str(args[1]))
        write(*args, **kwargs)

    def run(save, epochs, resume=False):
        torch.manual_seed(0)
        factory = StepFactory(_Tiny(), losses.L1Loss(),
                              get_optimizer("Adam", 0.1), plan=plan)
        trainer = Trainer(factory, TrainerConfig(
            save_dir=str(root / save), total_epochs=epochs[1],
            validation_frequency=1))
        if resume:
            trainer.resume()
            assert trainer.start_epoch == epochs[0]
        trainer.fit(_rank_loader(train, 4, plan, shuffle=True, seed=3),
                    _rank_loader(val, 4, plan, drop_last=False))
        return factory, trainer

    with mock.patch.object(ckpt_native, "_write", counted):
        fa, ta = run("ckpt_a", (0, 2))
        run("ckpt_b", (0, 1))
        fb, tb = run("ckpt_b", (1, 2), resume=True)
    return {name: {"state": _clone_state(f.model), "adam": _adam_state(f),
                   "count": f.optimizer.count, "best": t.best_epe}
            for name, f, t in (("a", fa, ta), ("b", fb, tb))} | {
        "writes": writes}


def _rank_cli(root):
    """The command line in this rank, under torchrun's environment: it
    takes the running group."""
    assert cli_main(_cli_argv(root, root / "cli_train")) == 0
    assert cli_main(_cli_argv(root, root / "cli_infer", True)) == 0


def _rank_main(rank, root):
    torch.set_num_threads(1)
    root = pathlib.Path(root)
    assert init_distributed(
        backend="gloo", world_size=WORLD, rank=rank,
        init_method=f"file://{root / 'store'}",
        timeout=datetime.timedelta(seconds=60))
    plan = DataParallelPlan.current("cpu")
    assert (plan.world_size, plan.rank, plan.device) == (WORLD, rank,
                                                         torch.device("cpu"))
    out = {"steps": _rank_steps(plan), "bn": _rank_bn(plan),
           "val_infer": _rank_val_infer(plan, root),
           "ckpt": _rank_checkpoints(plan, root)}
    _rank_cli(root)
    torch.save(out, root / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------ the test process

def _start_ranks(root):
    procs = []
    for r in range(WORLD):
        # torchrun's variables beside the file store the ranks start from
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT="0", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        env.pop("PYTHONSTARTUP", None)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(r), str(root)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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


def _jax_state(variables, tx):
    import jax
    import jax.numpy as jnp
    from flownet2_tpu.train import TrainState
    return TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                             tx)


def _jax_steps(state_np, images, flow, model, model_name,
               kinds=("single", "mesh"), optimizer=("Adam", 1e-4)):
    """One step of the JAX model on one device and on a two-device data
    mesh (``kinds``): (state dict, loss) of each."""
    import jax
    import jax.numpy as jnp
    from flownet2_tpu.checkpoints.torch_import import state_dict_to_variables
    from flownet2_tpu.losses import MultiScale
    from flownet2_tpu.parallel import MeshPlan, scoped_mesh
    from flownet2_tpu.train import StepFactory as JaxStepFactory
    from flownet2_tpu.train import get_optimizer as jax_get_optimizer
    from flownet2_tpu_torch.checkpoints import from_jax_variables

    variables = state_dict_to_variables(state_np, model_name)
    tx = jax_get_optimizer(*optimizer)
    state = _jax_state(variables, tx)
    out = {}
    single = JaxStepFactory(model, MultiScale(), tx)
    if "single" in kinds:
        new, m = single.train_step()(jax.tree.map(jnp.copy, state),
                                     jnp.asarray(images), jnp.asarray(flow))
        out["single"] = (new, float(m["loss"]))
    with scoped_mesh(jax.devices()[:WORLD]) as mesh:
        plan = MeshPlan(mesh)
        factory = JaxStepFactory(model, MultiScale(), tx, plan=plan)
        new, m = factory.train_step()(
            jax.device_put(jax.tree.map(jnp.copy, state), plan.replicated),
            jax.device_put(jnp.asarray(images), plan.batch_images),
            jax.device_put(jnp.asarray(flow), plan.batch_flow))
        out["mesh"] = (new, float(m["loss"]))

    def as_state(s):
        v = {"params": jax.tree_util.tree_map(np.asarray, s.params)}
        if s.batch_stats is not None:
            v["batch_stats"] = jax.tree_util.tree_map(np.asarray,
                                                      s.batch_stats)
        return from_jax_variables(v, model_name)

    return {k: (as_state(s), loss) for k, (s, loss) in out.items()}, \
        single, state


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two ranks' results and the references computed meanwhile."""
    from flownet2_tpu.data import loader as jax_loader
    from flownet2_tpu.models import FlowNet2S as JaxFlowNet2S
    from flownet2_tpu.train.trainer import Trainer as JaxTrainer
    from flownet2_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    root = tmp_path_factory.mktemp("dp")
    _write_chairs(root / "train", 8, seed=50)
    _write_chairs(root / "val", 5, seed=51)
    procs = _start_ranks(root)
    try:
        ref = {}
        # case 2: the JAX steps and the port in one process
        images, flow = _batch(1)
        model = get_model("FlowNet2S", device="cpu", seed=0)
        state_np = {k: v.numpy() for k, v in model.state_dict().items()}
        ref["jax"], jax_single, jax_state = _jax_steps(
            state_np, images, flow, JaxFlowNet2S(), "FlowNet2S")
        factory = StepFactory(model, losses.MultiScale(),
                              get_optimizer("Adam", 1e-4))
        m = factory.train_step()(torch.from_numpy(images),
                                 torch.from_numpy(flow))
        ref["port"] = (_clone_state(model), float(m["loss"]))

        # case 3: the JAX mesh step with BatchNorm; the samples a channel
        # of each BatchNorm sees in the global batch; one rank's own
        # statistics
        images, flow = _batch(3)
        bn_state = _bn_state()
        ref["bn_before"] = bn_state
        ref["bn_jax"] = _jax_steps(bn_state, images, flow,
                                   JaxFlowNet2S(batch_norm=True),
                                   "FlowNet2S", kinds=("mesh",),
                                   optimizer=("SGD", BN_LR))[0]["mesh"]
        seen = {}
        local = _bn_model(bn_state).train()
        for name, mod in local.named_modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.register_forward_pre_hook(
                    lambda m, a, name=name: seen.__setitem__(
                        name, WORLD * (a[0].numel() // a[0].shape[1])))
        with torch.no_grad():
            local(_stripe(images, 0))
        ref["bn_n"] = seen
        ref["bn_rank0_alone"] = _clone_state(local)

        # case 6: the JAX Trainer's means; the port's flows in one process
        ds = _Pairs(13, seed=30)
        jt = JaxTrainer(jax_single, JaxTrainerConfig(
            save_dir=str(root / "jax_trainer")))
        loader = jax_loader.DataLoader(ds, B, shuffle=False, drop_last=False,
                                       num_workers=1)
        ref["jax_val"] = jt.validate(jax_state, loader, 0)
        ref["jax_infer"] = jt.inference(jax_state, loader)[1]
        infer = StepFactory(get_model("FlowNet2S", device="cpu", seed=0),
                            losses.MultiScale(),
                            get_optimizer("Adam", 1e-4)).infer_step()
        ref["flows"] = torch.cat([infer(torch.from_numpy(ds.images[i:i + B]))
                                  for i in range(0, len(ds), B)])

        # case 8: the command line in one process
        single = root / "single"
        single.mkdir()
        for inference in (False, True):
            save = single / ("cli_infer" if inference else "cli_train")
            assert cli_main(_cli_argv(root, save, inference)) == 0
    finally:
        _join(procs)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    yield {"root": root, "ref": ref, "ranks": ranks}
    # the ranks' checkpoints and FlowNet2-size rank files: gone once read
    shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ cases

def test_init_distributed_reads_the_environment(monkeypatch, tmp_path):
    """No torchrun variable: False and no group.  Some but not all: raises,
    naming the missing ones.  Explicit arguments win over the
    environment."""
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="WORLD_SIZE, LOCAL_RANK, "
                                           "MASTER_PORT"):
        init_distributed()
    assert not torch.distributed.is_initialized()
    # the environment names a world of two, which would wait for a rank
    # that never comes; the arguments name one
    for k, v in zip(ENV_VARS, ("1", "2", "1", "127.0.0.1", "1")):
        monkeypatch.setenv(k, v)
    try:
        assert init_distributed(backend="gloo", world_size=1, rank=0,
                                init_method=f"file://{tmp_path / 'store'}")
        assert torch.distributed.get_world_size() == 1
        plan = DataParallelPlan.current()
        assert (plan.world_size, plan.rank, plan.device) == (
            1, 0, torch.device("cpu"))
        assert plan.local_batch_size(8) == 8
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match="both"):
        init_distributed(world_size=2)


@pytest.mark.parametrize("batch,devices", [(8, 4), (6, 4), (8, 3), (5, 8)])
def test_data_ranks_is_the_jax_rule(batch, devices):
    """flownet2_tpu/cli/main.py: the largest divisor of the batch that the
    device count allows."""
    want = max(d for d in range(1, devices + 1) if batch % d == 0)
    assert data_ranks(batch, devices) == want
    plan = DataParallelPlan(want, want - 1, want - 1, torch.device("cpu"))
    assert plan.local_batch_size(batch) * want == batch
    if batch % (want + 1):
        with pytest.raises(ValueError, match="divide"):
            DataParallelPlan(want + 1, 0, 0, torch.device("cpu")) \
                .local_batch_size(batch)


def test_valid_in_stripe():
    """A padded tail of 5 in a global batch of 8 over two ranks: rank 0
    holds 4 real samples, rank 1 one; over four ranks, 2, 2, 1, 0."""
    def plans(n):
        return [DataParallelPlan(n, r, r, torch.device("cpu"))
                for r in range(n)]
    assert [p.valid_in_stripe(5, 4) for p in plans(2)] == [4, 1]
    assert [p.valid_in_stripe(5, 2) for p in plans(4)] == [2, 2, 1, 0]
    assert [p.valid_in_stripe(8, 2) for p in plans(4)] == [2, 2, 2, 2]


def test_two_ranks_step_as_the_jax_mesh_and_one_device(dp):
    """Step 1 over two ranks: every parameter within 1e-5 of the JAX step
    on the two-device mesh, of the JAX step on one device and of the
    port's step in one process; the loss, the global batch's mean, within
    1e-5 relative."""
    got = dp["ranks"][0]["steps"]["step1"]
    refs = {"jax mesh": dp["ref"]["jax"]["mesh"],
            "jax single device": dp["ref"]["jax"]["single"],
            "port, one process": dp["ref"]["port"]}
    for what, (state, loss) in refs.items():
        assert got["loss"] == pytest.approx(loss, rel=TOL), what
        worst = max(float((got["state"][k] - v).abs().max())
                    for k, v in state.items())
        assert worst < TOL, (what, worst)
        assert set(state) <= set(got["state"])
    before = get_model("FlowNet2S", device="cpu", seed=0).state_dict()
    assert all(not torch.equal(got["state"][k], before[k]) for k in before)


def test_ranks_stay_bit_equal(dp):
    """After each of two steps every rank holds the same bits, buffers
    included, and reports the same global metrics (the second step would
    raise under DDP if a parameter had gone unused)."""
    a, b = (r["steps"] for r in dp["ranks"])
    for k in ("step1", "step2"):
        assert a[k]["state"].keys() == b[k]["state"].keys()
        assert all(torch.equal(a[k]["state"][n], b[k]["state"][n])
                   for n in a[k]["state"])
        assert (a[k]["loss"], a[k]["epe"]) == (b[k]["loss"], b[k]["epe"])
    assert not torch.equal(a["step1"]["state"]["conv1.0.weight"],
                           a["step2"]["state"]["conv1.0.weight"])


def test_batch_norm_takes_the_global_batch(dp):
    """FlowNet2S with BatchNorm over two ranks: the parameters and the
    running statistics after one step (SGD at lr 1) match the JAX mesh
    step's within 1e-5, with torch's unbiased running variance scaled to
    Flax's biased one over the global batch's samples.  One rank's own
    statistics would miss that bound."""
    want, want_loss = dp["ref"]["bn_jax"]
    before = dp["ref"]["bn_before"]
    n = dp["ref"]["bn_n"]
    got = [r["bn"] for r in dp["ranks"]]
    assert got[0]["loss"] == got[1]["loss"] == pytest.approx(want_loss,
                                                             rel=TOL)

    def expected(key):
        if not key.endswith("running_var"):
            return want[key].numpy()
        kept = 0.9 * before[key]
        count = n[key[:-len(".running_var")]]
        return kept + (want[key].numpy() - kept) * count / (count - 1)

    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * len(n) > 0
    for key in (k for k in want if not k.endswith("num_batches_tracked")):
        for g in got:
            np.testing.assert_allclose(g["state"][key].numpy(),
                                       expected(key), rtol=TOL, atol=TOL,
                                       err_msg=key)
    assert all(int(g["state"][k]) == 1 for g in got for k in g["state"]
               if k.endswith("num_batches_tracked"))
    alone = dp["ref"]["bn_rank0_alone"]
    miss = max(float(np.abs(alone[k].numpy() - expected(k)).max())
               for k in stats)
    assert miss > 100 * TOL, miss


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_parameter_gets_a_gradient(name):
    """One training step of each model at 64x64: every parameter has a
    gradient, so DistributedDataParallel runs them without
    find_unused_parameters."""
    model = get_model(name, device="cpu", seed=0)
    images, flow = _batch(60, b=1)
    model.train()
    loss, _ = losses.MultiScale()(model(torch.from_numpy(images)),
                                  torch.from_numpy(flow))
    loss.backward()
    unused = [k for k, p in model.named_parameters() if p.grad is None]
    assert not unused, unused


def test_loader_stripes_rebuild_the_jax_global_batch():
    """Two loaders with process_count 2 rebuild the JAX package's
    one-process global batches bit for bit, the padded tail and its
    n_valid included."""
    from flownet2_tpu.data import loader as jax_loader

    ds = _Pairs(13, seed=70, h=8, w=8)
    kw = dict(batch_size=B, shuffle=True, seed=5, drop_last=False,
              num_workers=2)
    want = list(jax_loader.DataLoader(ds, **kw))
    stripes = [list(DataLoader(ds, process_count=WORLD, process_index=r,
                               **kw)) for r in range(WORLD)]
    assert len(want) == len(stripes[0]) == len(stripes[1]) == 2
    for w, *parts in zip(want, *stripes):
        for field in ("images", "flow"):
            np.testing.assert_array_equal(
                np.concatenate([getattr(p, field) for p in parts]),
                getattr(w, field))
        assert [p.n_valid for p in parts] == [w.n_valid] * WORLD
    assert [w.n_valid for w in want] == [8, 5]


def test_validation_and_inference_count_every_sample_once(dp):
    """13 pairs at batch 8 over two ranks: the validation and inference
    means are the JAX Trainer's in one process within 1e-5, over 13
    samples, on both ranks; rank 0 alone writes 13 .flo files, in order,
    each within 1e-5 of the port's flow in one process."""
    for r in dp["ranks"]:
        got = r["val_infer"]
        for what, want in (("val", dp["ref"]["jax_val"]),
                           ("infer", dp["ref"]["jax_infer"])):
            assert got[what]["n_samples"] == want["n_samples"] == 13
            for key in ("loss", "epe"):
                assert got[what][key] == pytest.approx(want[key], rel=TOL)
        assert got["n"] == 13
    names = [f"{i:06d}.flo" for i in range(13)]
    assert dp["ranks"][0]["val_infer"]["written"] == names
    assert dp["ranks"][1]["val_infer"]["written"] == []
    flows_dir = dp["root"] / "flows"
    assert sorted(os.listdir(flows_dir)) == names
    for name, want in zip(names, dp["ref"]["flows"]):
        np.testing.assert_allclose(read_flo(flows_dir / name), want.numpy(),
                                   rtol=TOL, atol=TOL)


def test_resumed_ranks_are_bit_equal_and_rank0_writes(dp):
    """Run B, killed after epoch 0 and resumed on both ranks, ends with run
    A's parameters, Adam state, count and best EPE on every rank; rank 0
    alone wrote the checkpoints."""
    ranks = [r["ckpt"] for r in dp["ranks"]]
    for got in ranks:
        a, b = got["a"], got["b"]
        assert a["count"] == b["count"] == 8
        assert a["best"] == b["best"] and np.isfinite(a["best"])
        assert all(torch.equal(a["state"][k], b["state"][k])
                   for k in a["state"])
        assert len(a["adam"]) == len(b["adam"]) > 0
        assert all(torch.equal(x, y) for x, y in zip(a["adam"], b["adam"]))
    assert all(torch.equal(ranks[0]["a"]["state"][k], ranks[1]["a"]["state"][k])
               for k in ranks[0]["a"]["state"])
    assert ranks[1]["writes"] == []
    assert {pathlib.Path(p).name for p in ranks[0]["writes"]} == {
        "checkpoint", "train-checkpoint"}
    for run in ("ckpt_a", "ckpt_b"):
        assert sorted(os.listdir(dp["root"] / run)) == [
            "checkpoint", "model_best", "run.metrics.jsonl",
            "train-checkpoint"]


def test_command_line_ranks_match_one_process(dp):
    """The command line as two ranks under torchrun's environment with
    --device cpu: one epoch of FlowNet2S (each step's and the
    validation's records at 1e-5 relative, the final parameters at 1e-5)
    and --inference --save_flow from that run (the flows' EPE, as the
    command line's tests hold flows, below 1e-5), against the command
    line in one process; rank 0 wrote the files."""
    root = dp["root"]

    def records(save):
        with open(save / "run.metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    for what in ("cli_train", "cli_infer"):
        got, want = records(root / what), records(root / "single" / what)
        assert [(r["step"], r["split"]) for r in got] == \
            [(r["step"], r["split"]) for r in want]
        for a, b in zip(got, want):
            assert a.get("n_samples") == b.get("n_samples")
            for key in ("loss", "epe"):
                assert a[key] == pytest.approx(b[key], rel=TOL), (what, a)
    assert [r["split"] for r in records(root / "cli_train")] == \
        ["val", "train", "train"]
    state = [torch.load(d / "cli_train" / "train-checkpoint" / "state.pt",
                        weights_only=True)["model"]
             for d in (root, root / "single")]
    assert max(float((state[0][k] - v).abs().max())
               for k, v in state[1].items()) < TOL
    flows = [sorted(os.listdir(d / "cli_infer" / "inference" / "flows"))
             for d in (root, root / "single")]
    assert flows[0] == flows[1] == [f"{i:06d}.flo" for i in range(5)]
    for name in flows[0]:
        a, b = (read_flo(d / "cli_infer" / "inference" / "flows" / name)
                for d in (root, root / "single"))
        assert np.abs(b).max() > 1
        assert float(np.sqrt(((a - b) ** 2).sum(-1)).mean()) < TOL, name
    args = json.loads((root / "cli_train" / "args.json").read_text())
    assert args["device"] == "cpu"


def test_command_line_starts_ranks_only_for_cuda_on_several_cards(
        monkeypatch):
    """The plain command with --device cuda on a machine of 4 cards starts
    data_ranks(batch, 4) ranks; --device cpu, a named cuda:K, one card or
    torchrun's environment start none."""
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)

    def ranks(*argv, cards=4):
        args = build_parser(list(argv)).parse_args(list(argv))
        with mock.patch.object(torch.cuda, "device_count",
                               return_value=cards):
            return _ranks_to_start(args)

    assert ranks("--batch_size", "8") == 4
    assert ranks("--batch_size", "6") == 3
    assert ranks("--batch_size", "8", "--inference_batch_size", "2") == 2
    assert ranks("--batch_size", "8", cards=1) == 1
    assert ranks("--batch_size", "8", "--device", "cpu") == 1
    assert ranks("--batch_size", "8", "--device", "cuda:1") == 1
    monkeypatch.setenv("RANK", "0")
    assert ranks("--batch_size", "8") == 1


def test_command_line_refuses_a_named_card_under_torchrun(monkeypatch,
                                                          tmp_path):
    """Under torchrun's environment every rank runs on cuda:LOCAL_RANK, so
    a named --device cuda:K raises before any group starts."""
    for k, v in zip(ENV_VARS, ("0", "2", "0", "127.0.0.1", "1")):
        monkeypatch.setenv(k, v)
    with mock.patch.object(torch.cuda, "is_available", return_value=True):
        with pytest.raises(ValueError, match="cuda:LOCAL_RANK"):
            cli_main(["--device", "cuda:1", "--save", str(tmp_path)])
    assert not torch.distributed.is_initialized()


def test_command_line_starts_its_ranks_through_torchrun(monkeypatch):
    """The plain command with --device cuda on a machine of 4 cards runs
    itself as data_ranks(8, 4) ranks under torchrun on this host
    (standalone, one process a rank, this checkout on the path) and returns
    torchrun's exit code, which is not 0 when a rank fails; it starts no
    process group of its own."""
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    calls = []

    def torchrun(cmd, env=None, **kwargs):
        calls.append((cmd, env))
        return subprocess.CompletedProcess(cmd, 3)

    monkeypatch.setattr(subprocess, "run", torchrun)
    argv = ["--batch_size", "8", "--save", "./nowhere"]
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=4):
        assert cli_main(argv) == 3
    assert not torch.distributed.is_initialized()
    (cmd, env), = calls
    assert cmd == [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node=4", "-m",
                   "flownet2_tpu_torch.cli", *argv]
    assert str(REPO) in env["PYTHONPATH"].split(os.pathsep)
    assert cli_start_ranks(2, argv) == 3


if __name__ == "__main__":  # a rank of the multi-process cases
    _rank_main(int(sys.argv[1]), sys.argv[2])
