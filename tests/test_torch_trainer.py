"""The port's run tooling, native checkpoints and Trainer against the JAX
package's, on the CPU.

The slice test trains FlowNet2S at 64x128, batch 2, Adam 1e-4, for two
epochs from synthetic FlyingChairs files, through the port's loader,
``device_prefetch`` and ``Trainer.fit``, and through the JAX package's
loader and Trainer on the same weights; the logged losses and EPE of every
step and the validation means agree.  A second port run stopped after
epoch 0 and resumed from its checkpoint ends bit-equal to the run that was
not stopped.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from flownet2_tpu import losses as jax_losses
from flownet2_tpu.checkpoints.torch_import import state_dict_to_variables
from flownet2_tpu.data import datasets as jax_datasets
from flownet2_tpu.data import loader as jax_loader
from flownet2_tpu.models import FlowNet2S as JaxFlowNet2S
from flownet2_tpu.train import optim as jax_optim
from flownet2_tpu.train.state import StepFactory as JaxStepFactory
from flownet2_tpu.train.state import TrainState as JaxTrainState
from flownet2_tpu.train.trainer import Trainer as JaxTrainer
from flownet2_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from flownet2_tpu.utils import tensorboard as jax_tb
from flownet2_tpu.utils import tools as jax_tools

from flownet2_tpu_torch import losses
from flownet2_tpu_torch.checkpoints import (
    from_jax_variables,
    restore_checkpoint,
    save_checkpoint,
)
from flownet2_tpu_torch.data import (
    Batch,
    DataLoader,
    DeviceLoader,
    FlyingChairs,
    read_flo,
    write_flo,
)
from flownet2_tpu_torch.models import FlowNet2S, get_model
from flownet2_tpu_torch.train import (
    StepFactory,
    Trainer,
    TrainerConfig,
    get_optimizer,
)
from flownet2_tpu_torch.utils import tensorboard, tools

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

H, W = 64, 128
LOSS_RTOL = 1e-4


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _strip(records, keys=("step", "split", "loss", "epe", "n_samples")):
    return [{k: r[k] for k in keys if k in r} for r in records]


# ------------------------------------------------------------ run tooling

def test_tools_match_jax(tmp_path, capsys):
    """format_dictionary_of_losses, MetricLogger's records, IteratorTimer,
    progress and TimerBlock are the JAX package's."""
    labels, values = ["L1", "EPE"], [0.123456, 4.5]
    assert (tools.format_dictionary_of_losses(labels, values)
            == jax_tools.format_dictionary_of_losses(labels, values))
    with pytest.raises(ValueError, match="labels"):
        tools.format_dictionary_of_losses(["a"], [1.0, 2.0])
    for mod, sub in ((tools, "port"), (jax_tools, "jax")):
        logger = mod.MetricLogger(str(tmp_path / sub), "run")
        rec = logger.log(3, "train", {"loss": np.float32(0.5), "epe": 2})
        assert rec["step"] == 3 and rec["loss"] == 0.5
        logger.log(4, "val", {"loss": 0.25, "n_samples": 5})
    got, want = (_records(tmp_path / sub / "run.metrics.jsonl")
                 for sub in ("port", "jax"))
    assert [{k: v for k, v in r.items() if k != "time"} for r in got] == \
        [{k: v for k, v in r.items() if k != "time"} for r in want]
    assert tools.MetricLogger(None).log(1, "train", {"a": 1})["a"] == 1.0
    timer = tools.IteratorTimer([1, 2, 3])
    assert len(timer) == 3 and list(timer) == [1, 2, 3]
    assert timer.last_duration >= 0
    assert list(tools.progress(iter(range(25)), total=25, desc="x",
                               every=10)) == list(range(25))
    with tools.TimerBlock("block") as block:
        block.log("inside")
    block.log2file(str(tmp_path / "log.txt"), "line")
    assert (tmp_path / "log.txt").read_text() == "line\n"
    out = capsys.readouterr()
    assert "block finished" in out.out and "x 20/25" in out.err
    assert isinstance(tools.gpumemusage(), str)


def test_summary_writer_matches_jax(tmp_path):
    """Scalars and histograms of the port's writer read back the same by
    both packages' read_events, and equal the JAX writer's records."""
    values = np.random.RandomState(0).randn(500).astype(np.float32)
    values[3] = np.nan   # dropped from the histogram, as in the JAX writer
    paths = []
    for mod, sub in ((tensorboard, "port"), (jax_tb, "jax")):
        w = mod.SummaryWriter(str(tmp_path / sub))
        w.add_scalar("loss", 1.5, step=1)
        w.add_scalars({"loss": 0.25, "epe": 3.0}, step=2)
        w.add_histogram("flownets/conv1/weight", values, step=2)
        w.close()
        paths.append(w.path)
    assert tensorboard.crc32c(b"123456789") == 0xE3069283
    ours = tensorboard.read_events(paths[0])
    assert ours == jax_tb.read_events(paths[0])
    assert [(s, v) for s, v in ours] == [(s, v) for s, v in
                                         jax_tb.read_events(paths[1])]
    assert ours[0] == (0, {}) and ours[2][1]["epe"] == pytest.approx(3.0)
    assert ours[3][1]["flownets/conv1/weight"]["num"] == 499
    assert os.path.basename(paths[0]).startswith("events.out.tfevents.")


# ------------------------------------------------------------ checkpoints

class _Tiny(torch.nn.Module):
    """A flow from the first frame's first two channels: one convolution,
    for the tests that need a model and not FlowNet2's cost."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 2, 3, padding=1)

    def forward(self, images):
        x = images[:, 0, :, :, :2].permute(0, 3, 1, 2) / 255.0
        return self.conv(x).permute(0, 2, 3, 1)


def _tiny_factory(seed=0, lr=0.1):
    torch.manual_seed(seed)
    return StepFactory(_Tiny(), losses.L1Loss(), get_optimizer("Adam", lr))


def _tiny_batch(seed, b=2, h=8, w=8):
    rng = np.random.RandomState(seed)
    return Batch(torch.from_numpy(rng.rand(b, 2, h, w, 3).astype(np.float32)
                                  * 255),
                 torch.from_numpy(rng.randn(b, h, w, 2).astype(np.float32)))


def _state(factory):
    """Parameters, Adam's state and the count, cloned."""
    inner = factory.optimizer.inner.state_dict()
    moments = [(k, name, v.clone()) for k, s in sorted(inner["state"].items())
               for name, v in sorted(s.items())]
    params = {n: p.detach().clone()
              for n, p in factory.model.named_parameters()}
    return params, moments, factory.optimizer.count


def _assert_bit_equal(a, b):
    (pa, ma, ca), (pb, mb, cb) = a, b
    assert ca == cb
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert [(k, n) for k, n, _ in ma] == [(k, n) for k, n, _ in mb]
    assert all(torch.equal(x, y) for (_, _, x), (_, _, y) in zip(ma, mb))


def test_checkpoint_round_trip(tmp_path):
    """The model, Adam's moments and step, the count and the metadata come
    back bit-equal (into a fresh model and optimizer); model_best and a
    checkpoint named by its own directory (tag=None); a crash between the
    two renames is recovered from <tag>.old."""
    factory = _tiny_factory()
    step = factory.train_step()
    for k in range(3):
        step(*_tiny_batch(k)[:2])
    want = _state(factory)
    path = save_checkpoint(tmp_path, factory.model, factory.optimizer,
                           epoch=3, best_epe=1.5, is_best=True)
    assert path == str(tmp_path / "train-checkpoint")
    assert sorted(os.listdir(tmp_path)) == ["model_best", "train-checkpoint"]
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]

    for tag, base in (("train-checkpoint", tmp_path),
                      (None, tmp_path / "model_best")):
        fresh = _tiny_factory(seed=1)
        assert not torch.equal(fresh.model.conv.weight, want[0]["conv.weight"])
        meta = restore_checkpoint(base, fresh.model, fresh.optimizer, tag=tag)
        assert meta == {"epoch": 3, "best_EPE": 1.5}
        _assert_bit_equal(_state(fresh), want)
        # the next step of both is the same step
        a = step(*_tiny_batch(9)[:2])
        b = fresh.train_step()(*_tiny_batch(9)[:2])
        assert torch.equal(a["loss"], b["loss"])
        _assert_bit_equal(_state(fresh), _state(factory))
        restore_checkpoint(base, factory.model, factory.optimizer, tag=tag)

    # a second save replaces the first; a crash between the renames
    save_checkpoint(tmp_path, factory.model, factory.optimizer, epoch=7,
                    best_epe=2.5)
    (tmp_path / "train-checkpoint").rename(tmp_path / "train-checkpoint.old")
    fresh = _tiny_factory(seed=2)
    meta = restore_checkpoint(tmp_path, fresh.model, fresh.optimizer)
    assert meta == {"epoch": 7, "best_EPE": 2.5}
    _assert_bit_equal(_state(fresh), want)
    assert (tmp_path / "train-checkpoint").exists()
    assert not (tmp_path / "train-checkpoint.old").exists()
    # weights alone, and the refusals
    save_checkpoint(tmp_path, factory.model, None, 0, 0.0, tag="weights")
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_checkpoint(tmp_path, fresh.model, fresh.optimizer,
                           tag="weights")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "nowhere", fresh.model)
    sgd = StepFactory(_Tiny(), losses.L1Loss(), get_optimizer("SGD", 0.1))
    with pytest.raises(ValueError, match="Adam"):
        restore_checkpoint(tmp_path, sgd.model, sgd.optimizer)


# ----------------------------------------------------- trainer mechanics

class _NoDropLoader:
    """5 samples at batch 2: batches with n_valid 2, 2, 1; the tail's pad
    slot holds a wildly different target, so pad contamination of the
    means would show."""

    def __init__(self, n_samples=5, batch=2):
        self.items = [_tiny_batch(100 + i, b=1) for i in range(n_samples)]
        self.batch = batch
        self.n_samples = n_samples

    def __len__(self):
        return -(-self.n_samples // self.batch)

    def __iter__(self):
        for b in range(len(self)):
            sel = [self.items[(b * self.batch + j) % self.n_samples]
                   for j in range(self.batch)]
            n_valid = min(self.batch, self.n_samples - b * self.batch)
            flow = torch.cat([s.flow for s in sel])
            if n_valid < self.batch:
                flow = flow.clone()
                flow[n_valid:] += 1e3
            yield Batch(torch.cat([s.images for s in sel]), flow, n_valid)


def test_validate_scores_every_sample(tmp_path):
    factory = _tiny_factory()
    trainer = Trainer(factory, TrainerConfig(save_dir=str(tmp_path)))
    loader = _NoDropLoader()
    means = trainer.validate(loader, epoch=0)
    assert means["n_samples"] == 5
    eval_step = factory.eval_step()
    total = sum(float(eval_step(s.images, s.flow, 1)["epe_sum"])
                for s in loader.items)
    np.testing.assert_allclose(means["epe"], total / 5, rtol=1e-6)


def test_inference_writes_every_real_sample(tmp_path):
    """One .flo and one PNG per real sample (none for the pad slot), the
    .flo files the infer step's flows bit for bit; n_batches honoured."""
    factory = _tiny_factory()
    trainer = Trainer(factory, TrainerConfig(save_dir=str(tmp_path)))
    flo_dir, viz_dir = tmp_path / "flows", tmp_path / "viz"
    n, means = trainer.inference(_NoDropLoader(), save_flow_dir=str(flo_dir),
                                 visualize_dir=str(viz_dir))
    assert n == 5 and means["n_samples"] == 5
    assert sorted(os.listdir(flo_dir)) == [f"{i:06d}.flo" for i in range(5)]
    assert sorted(os.listdir(viz_dir)) == [f"{i:06d}.png" for i in range(5)]
    infer = factory.infer_step()
    for i, s in enumerate(_NoDropLoader().items):
        np.testing.assert_array_equal(read_flo(flo_dir / f"{i:06d}.flo"),
                                      infer(s.images)[0].numpy())
    n2, means2 = trainer.inference(_NoDropLoader(), n_batches=1)
    assert n2 == 2 and means2["n_samples"] == 2
    assert [r["split"] for r in _records(tmp_path / "run.metrics.jsonl")] \
        == ["inference", "inference"]


def test_nan_check_raises(tmp_path):
    factory = _tiny_factory()
    trainer = Trainer(factory, TrainerConfig(save_dir=str(tmp_path)))
    good, bad = _tiny_batch(0), _tiny_batch(1)
    bad.images[0, 0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="step 2"):
        trainer.train_epoch([good, bad, good], epoch=0)
    records = _records(tmp_path / "run.metrics.jsonl")
    assert [r["step"] for r in records] == [1, 2]
    assert np.isfinite(records[0]["loss"]) and np.isnan(records[1]["loss"])
    quiet = Trainer(_tiny_factory(), TrainerConfig(
        save_dir=str(tmp_path / "quiet"), nan_check=False))
    assert np.isnan(quiet.train_epoch([good, bad], epoch=0)["loss"])


def test_profile_trace_and_tensorboard(tmp_path):
    """profile_steps 1 writes a Chrome trace under <save_dir>/profile;
    tensorboard writes the train scalars and one histogram per parameter
    at histogram_frequency; train_n_batches caps the epoch."""
    cfg = TrainerConfig(save_dir=str(tmp_path), profile_steps=1,
                        tensorboard=True, histogram_frequency=2,
                        train_n_batches=3)
    trainer = Trainer(_tiny_factory(), cfg)
    last = trainer.train_epoch([_tiny_batch(i) for i in range(5)], epoch=0)
    assert trainer.global_step == 3 and set(last) == {"loss", "epe",
                                                      "load_s"}
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "profile" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    (events,) = os.listdir(tmp_path / "train")
    records = tensorboard.read_events(str(tmp_path / "train" / events))
    assert [s for s, v in records if "loss" in v] == [1, 2, 3]
    for name in ("conv/weight", "conv/bias"):
        assert [s for s, v in records if name in v] == [2]


# ------------------------------------------------------- the slice: fit

def _write_chairs(root, n, seed, h=80, w=160):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(n):
        for j in (1, 2):
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                root / f"{i:05d}_img{j}.ppm")
        write_flo(root / f"{i:05d}_flow.flo",
                  (rng.randn(h, w, 2) * 2).astype(np.float32))


FIT = dict(total_epochs=2, validation_frequency=1, log_frequency=1)


def _port_run(data, variables, save_dir, epochs=(0, 2), resume=False):
    """A port run over epochs [start, stop) of FIT from fresh FlowNet2S
    weights; with ``resume`` it resumes from ``save_dir`` first."""
    model = FlowNet2S()
    model.load_state_dict(from_jax_variables(variables, "FlowNet2S"))
    factory = StepFactory(model, losses.MultiScale(),
                          get_optimizer("Adam", 1e-4))
    cfg = TrainerConfig(save_dir=str(save_dir),
                        **dict(FIT, total_epochs=epochs[1]))
    trainer = Trainer(factory, cfg)
    if resume:
        trainer.resume()
        assert trainer.start_epoch == epochs[0]
    train, val = (DataLoader(ds, batch_size=2, shuffle=True, drop_last=False,
                             seed=4, num_workers=2) for ds in data)

    # the loaders through device_prefetch, as a user feeds the steps
    trainer.fit(DeviceLoader(train, device="cpu"),
                DeviceLoader(val, device="cpu"))
    return factory, trainer


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """Run A of the port (two epochs through fit), the JAX Trainer on the
    same weights and batches, and run B: epoch 0, stopped, then epoch 1 in
    a new model, optimizer, StepFactory and Trainer resumed from B's
    train-checkpoint."""
    root = tmp_path_factory.mktemp("trainer")
    _write_chairs(root / "train", 6, seed=0)
    _write_chairs(root / "val", 3, seed=1)
    kw = [dict(is_cropped=True, crop_size=(H, W), seed=2), {}]
    data = [FlyingChairs(root=str(root / s), **k)
            for s, k in zip(("train", "val"), kw)]
    made = get_model("FlowNet2S", device="cpu", seed=0)
    variables = state_dict_to_variables(
        {k: v.numpy() for k, v in made.state_dict().items()}, "FlowNet2S")

    run_a = _port_run(data, variables, root / "a")

    tx = jax_optim.get_optimizer("Adam", 1e-4)
    factory = JaxStepFactory(JaxFlowNet2S(), jax_losses.MultiScale(), tx)
    state = JaxTrainState.create(
        {"params": jax.tree_util.tree_map(np.asarray,
                                          variables["params"])}, tx)
    jax_trainer = JaxTrainer(factory, JaxTrainerConfig(
        save_dir=str(root / "jax"), **FIT))
    ref_data = [jax_datasets.FlyingChairs(root=str(root / s), **k)
                for s, k in zip(("train", "val"), kw)]
    train, val = (jax_loader.DataLoader(ds, batch_size=2, shuffle=True,
                                        drop_last=False, seed=4,
                                        num_workers=2) for ds in ref_data)
    # fit without its Orbax checkpoints: validate, then train, each epoch
    for epoch in range(FIT["total_epochs"]):
        train.set_epoch(epoch)
        jax_trainer.validate(state, val, epoch)
        state, _ = jax_trainer.train_epoch(state, train, epoch)

    _port_run(data, variables, root / "b", epochs=(0, 1))
    run_b = _port_run(data, variables, root / "b", epochs=(1, 2),
                      resume=True)
    yield dict(root=root, a=run_a, b=run_b)
    # the runs' checkpoints: gone once the module's tests have read them
    shutil.rmtree(root, ignore_errors=True)


def test_trainer_matches_jax(slice_runs):
    """Every step's logged loss and EPE and each validation's means agree
    with the JAX Trainer's at 1e-4; the steps are numbered alike."""
    root = slice_runs["root"]
    got = _strip(_records(root / "a" / "run.metrics.jsonl"))
    want = _strip(_records(root / "jax" / "run.metrics.jsonl"))
    assert [(r["step"], r["split"]) for r in got] == \
        [(r["step"], r["split"]) for r in want] == \
        [(0, "val"), (1, "train"), (2, "train"), (3, "train"),
         (3, "val"), (4, "train"), (5, "train"), (6, "train")]
    for a, b in zip(got, want):
        assert a.get("n_samples") == b.get("n_samples")
        for key in ("loss", "epe"):
            assert np.isfinite(a[key])
            np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL,
                                       err_msg=f"{a['split']} {a['step']}")
    assert [r["n_samples"] for r in got if r["split"] == "val"] == [3, 3]
    # the train records moved: the run trained
    losses_ = [r["loss"] for r in got if r["split"] == "train"]
    assert len(set(losses_)) == len(losses_)


def test_resumed_run_is_bit_equal(slice_runs):
    """Run B (stopped after epoch 0, resumed from its train-checkpoint)
    ends with run A's parameters, Adam moments and step, count and best
    EPE, and logs the same records bit for bit."""
    (fa, ta), (fb, tb) = slice_runs["a"], slice_runs["b"]
    _assert_bit_equal(_state(fb), _state(fa))
    assert fa.optimizer.count == fb.optimizer.count == 6
    assert ta.global_step == tb.global_step == 6
    assert tb.best_epe == ta.best_epe and np.isfinite(ta.best_epe)
    root = slice_runs["root"]
    assert _strip(_records(root / "b" / "run.metrics.jsonl")) == \
        _strip(_records(root / "a" / "run.metrics.jsonl"))
    for run in ("a", "b"):
        assert sorted(os.listdir(root / run)) == [
            "checkpoint", "model_best", "run.metrics.jsonl",
            "train-checkpoint"]
        meta = json.loads((root / run / "train-checkpoint" / "meta.json")
                          .read_text())
        assert meta == {"epoch": 2, "best_EPE": ta.best_epe}
