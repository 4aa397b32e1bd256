"""The port's command line (``flownet2_tpu_torch/cli``) against the JAX
package's (``flownet2_tpu/cli``), on the CPU.

- The parsers: the same destinations and defaults for every model, loss,
  optimizer and dataset selection, except ``--model_parent`` and
  ``--model_name`` (Flax's dataclass fields ``parent`` and ``name``, which
  the port's modules do not have) and the port's own ``--device``.
- ``optimizer_param_defaults`` is the JAX function's table, and every
  optimizer option that the JAX command line exposes moves the parameters
  as optax does over three steps (rtol 1e-5).
- The exit code 2 without a dataset, ``--precision fp16`` and
  ``--device``.
- One run of both command lines from one ``.pth.tar`` (``--resume_torch``)
  on one synthetic MpiSintel directory: FlowNet2S at batch 2, one epoch
  with validation and ``--render_validation``; the train and validation
  records agree at rtol 1e-4, the rendered flows to EPE < 1e-4, and the
  args.json files but the flags dropped and added.  It is the file's one
  call of the JAX command line.
- The port alone: ``--resume`` of a run directory (the count goes on) and
  of ``<run>/model_best``, ``--inference --resume`` of a ``convert``
  checkpoint, a training ``--resume`` of one refused, ``--spatial_shards
  2`` inference bit-equal to the whole map, and ``--precision bf16``
  inference within the JAX package's bf16 contract of the fp32 flows.

Frames are 64x128, the models FlowNet2S and FlowNet2C.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from flownet2_tpu.cli import build_parser as jax_build_parser
from flownet2_tpu.cli import main as jax_main
from flownet2_tpu.data import DATASETS as JAX_DATASETS
from flownet2_tpu.losses import LOSSES as JAX_LOSSES
from flownet2_tpu.models import MODELS as JAX_MODELS
from flownet2_tpu.train import optim as jax_optim

from flownet2_tpu_torch.checkpoints import convert
from flownet2_tpu_torch.cli import build_parser, main
from flownet2_tpu_torch.data import read_flo, write_flo
from flownet2_tpu_torch.models import get_model
from flownet2_tpu_torch.train import (LRSchedule, get_optimizer,
                                      optimizer_param_defaults)

from test_torch_caffe_import import caffe_layers, write_caffemodel

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
H, W = 64, 128
RTOL = 1e-4
DROPPED = {"model_parent", "model_name"}   # the JAX parser's alone
ADDED = {"device"}                          # the port's alone


# ------------------------------------------------------------------ parser

def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


SELECTIONS = ([["--model", m] for m in sorted(JAX_MODELS)]
              + [["--loss", name] for name in sorted(JAX_LOSSES)]
              + [["--optimizer", o] for o in sorted(jax_optim.OPTIMIZERS)]
              + [[f"--{group}", d] for group in ("training_dataset",
                                                 "validation_dataset",
                                                 "inference_dataset")
                 for d in sorted(JAX_DATASETS)])


@pytest.mark.parametrize("argv", SELECTIONS, ids=lambda a: "=".join(a))
def test_parser_matches_jax(argv):
    """The same destinations and defaults, but the two dropped and the one
    added; the selection parses to the same namespace in both."""
    got = _flags(build_parser(argv))
    want = _flags(jax_build_parser(argv))
    assert DROPPED <= set(want) and ADDED.isdisjoint(want)
    assert set(got) == (set(want) - DROPPED) | ADDED
    for dest in set(want) - DROPPED:
        assert got[dest] == want[dest], dest
        assert type(got[dest]) is type(want[dest]), dest
    assert got["device"] == "cuda"
    ours = vars(build_parser(argv).parse_args(argv))
    theirs = vars(jax_build_parser(argv).parse_args(argv))
    assert {k: v for k, v in ours.items() if k not in ADDED} == \
        {k: v for k, v in theirs.items() if k not in DROPPED}


def test_parser_flags_parse():
    argv = ["--model", "FlowNet2S", "--model_div_flow", "10",
            "--loss_norm", "L2", "--optimizer", "RMSprop",
            "--optimizer_centered", "true", "--optimizer_nesterov", "false",
            "--optimizer_decay", "0.8", "--inference_dataset",
            "ImagesFromFolder", "--inference_dataset_iext", "jpg"]
    args = build_parser(argv).parse_args(argv)
    assert args.model_div_flow == 10.0 and args.loss_norm == "L2"
    assert args.optimizer_centered is True
    assert args.optimizer_nesterov is False
    assert args.optimizer_decay == 0.8
    assert args.inference_dataset_iext == "jpg"
    argv = ["--optimizer", "Adam", "--optimizer_betas", "0.5", "0.99"]
    args = build_parser(argv).parse_args(argv)
    assert args.optimizer_betas == [0.5, 0.99] and args.optimizer_b1 == 0.9
    with pytest.raises(SystemExit):
        build_parser(["--optimizer", "SGD"]).parse_args(
            ["--optimizer", "SGD", "--optimizer_nesterov", "maybe"])


@pytest.mark.parametrize("name", sorted(jax_optim.OPTIMIZERS))
def test_optimizer_param_defaults_match_jax(name):
    got = optimizer_param_defaults(name)
    want = jax_optim.optimizer_param_defaults(name)
    assert list(got.items()) == list(want.items())
    for key in want:
        assert type(got[key]) is type(want[key])


# The optimizer options of the JAX command line off their defaults (and
# RMSprop's momentum, without which its nesterov is a no-op, as in optax).
# RMSprop's centered and bias_correction are tested apart: together they
# make the first step's variance 0 up to rounding, where either
# implementation's last bits set the update.
NEW_OPTIONS = [
    ("Adam", {"eps_root": 1e-6}), ("Adam", {"nesterov": True}),
    ("Adam", {"nesterov": True, "eps_root": 1e-3, "b1": 0.8}),
    ("AdamW", {"eps_root": 1e-6}),
    ("AdamW", {"nesterov": True, "weight_decay": 0.1}),
    ("RMSprop", {"centered": True}), ("RMSprop", {"bias_correction": True}),
    ("RMSprop", {"nesterov": True}),
    ("RMSprop", {"momentum": 0.9, "nesterov": True}),
    ("RMSprop", {"momentum": 0.5}),
    ("RMSprop", {"eps_in_sqrt": False, "initial_scale": 0.5, "decay": 0.8}),
    ("SGD", {"nesterov": True}),
    ("Momentum", {"nesterov": True, "momentum": 0.5}),
    ("Adagrad", {"initial_accumulator_value": 0.5, "eps": 1e-5}),
]


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("name,options", NEW_OPTIONS,
                         ids=lambda v: str(v))
def test_optimizer_options_match_optax(name, options, clip):
    """Three steps on identical gradients, with a schedule that decays
    after the first step, with and without a global-norm clip: the
    parameters agree with the JAX package's optax transform at rtol 1e-5."""
    rng = np.random.RandomState(80)
    params = [rng.randn(3, 4).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    tx = jax_optim.get_optimizer(name, 0.1, jax_optim.LRSchedule(
        0.1, frequency=1, fraction=2.0), grad_clip=clip, **options)
    j_params = [jnp.asarray(p) for p in params]
    state = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                for p in params]
    opt = get_optimizer(name, 0.1, LRSchedule(0.1, frequency=1,
                                              fraction=2.0),
                        grad_clip=clip, **options)
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
    # the state goes into a checkpoint and comes back
    again = get_optimizer(name, 0.1, **options).init(
        [torch.nn.Parameter(p.detach().clone()) for p in t_params])
    again.load_state_dict(opt.state_dict())
    assert again.count == 3


# -------------------------------------------------------------- fixtures

def _write_png(path, arr):
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A synthetic MpiSintel directory (5 frames, 4 pairs with flows) and
    an ImagesFromFolder directory (3 frames), at 64x128, and FlowNet2S's
    and FlowNet2C's seeded weights as reference .pth.tar files."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(1)
    sintel = root / "sintel"
    (sintel / "flow" / "s1").mkdir(parents=True)
    (sintel / "clean" / "s1").mkdir(parents=True)
    for i in range(1, 6):
        _write_png(sintel / "clean" / "s1" / f"frame_{i:04d}.png",
                   rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
    for i in range(1, 5):
        write_flo(sintel / "flow" / "s1" / f"frame_{i:04d}.flo",
                  (rng.randn(H, W, 2) * 2).astype(np.float32))
    frames = root / "frames"
    frames.mkdir()
    base = rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
    for i in range(3):
        _write_png(frames / f"{i:03d}.png", np.roll(base, i * 2, axis=1))
    pth = {}
    for name, seed in (("FlowNet2S", 3), ("FlowNet2C", 4)):
        model = get_model(name, device="cpu", seed=seed)
        pth[name] = root / f"{name}_checkpoint.pth.tar"
        torch.save({"arch": name, "epoch": 0, "best_EPE": 1e10,
                    "state_dict": model.state_dict()}, pth[name])
    return {"root": root, "sintel": sintel, "frames": frames, "pth": pth}


def _sintel_args(data, save, *extra):
    return ["--model", "FlowNet2S", "--batch_size", "2",
            "--save", str(save), "--validation_frequency", "1",
            "--training_dataset", "MpiSintelClean",
            "--training_dataset_root", str(data["sintel"]),
            "--validation_dataset", "MpiSintelClean",
            "--validation_dataset_root", str(data["sintel"]), *extra]


def _frames_args(data, save, model, *extra):
    return ["--inference", "--save_flow", "--model", model,
            "--batch_size", "2", "--save", str(save),
            "--inference_dataset", "ImagesFromFolder",
            "--inference_dataset_root", str(data["frames"]), *extra]


def _cli(*argv):
    """The port's main on the CPU."""
    return main([*argv, "--device", "cpu"])


def _records(save):
    with open(pathlib.Path(save) / "run.metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _flows(save):
    d = pathlib.Path(save) / "inference" / "flows"
    return [read_flo(d / f) for f in sorted(os.listdir(d))]


# --------------------------------------------------- the run's own edges

def test_no_dataset_returns_2(tmp_path):
    """Without a dataset the command line writes args.json and returns 2,
    as the JAX package's does."""
    assert _cli("--model", "FlowNet2S", "--save", str(tmp_path)) == 2
    assert json.loads((tmp_path / "args.json").read_text())["device"] == \
        "cpu"


def test_fp16_raises(data, tmp_path):
    with pytest.raises(NotImplementedError, match="M6"):
        _cli(*_frames_args(data, tmp_path, "FlowNet2S"),
             "--precision", "fp16")
    assert not (tmp_path / "inference").exists()


def test_device_defaults_to_cuda_and_refuses_without_it(data, tmp_path):
    """Without --device the command line wants the CUDA device: in the
    process and through ``python -m flownet2_tpu_torch.cli``, where none
    is visible, it raises and writes no flow."""
    argv = _frames_args(data, tmp_path, "FlowNet2S")
    assert build_parser(argv).parse_args(argv).device == "cuda"
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "flownet2_tpu_torch.cli",
                           *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "inference").exists()


# ----------------------------------------------------- against the JAX CLI

@pytest.fixture(scope="module")
def parity_runs(data):
    """One epoch of FlowNet2S at batch 2 from one .pth.tar, with validation
    and --render_validation, by both command lines."""
    saves = {"port": data["root"] / "port_run", "jax": data["root"] / "jax"}
    argv = _sintel_args(data, "{save}", "--total_epochs", "1",
                        "--render_validation", "--resume_torch",
                        str(data["pth"]["FlowNet2S"]))
    assert jax_main([a.format(save=saves["jax"]) for a in argv]) == 0
    assert _cli(*[a.format(save=saves["port"]) for a in argv]) == 0
    return saves


def test_cli_run_matches_jax(parity_runs):
    """The train and validation records agree at rtol 1e-4, step for step;
    the rendered flows to EPE < 1e-4."""
    got, want = ([r for r in _records(parity_runs[k])
                  if r["split"] in ("train", "val")]
                 for k in ("port", "jax"))
    assert [(r["step"], r["split"]) for r in got] == \
        [(r["step"], r["split"]) for r in want] == \
        [(0, "val"), (1, "train"), (2, "train")]
    for a, b in zip(got, want):
        assert a.get("n_samples") == b.get("n_samples")
        for key in ("loss", "epe"):
            assert np.isfinite(a[key])
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL,
                                       err_msg=f"{a['split']} {a['step']}")
    flows, ref = (_flows(parity_runs[k]) for k in ("port", "jax"))
    assert len(flows) == len(ref) == 4
    for a, b in zip(flows, ref):
        assert a.shape == b.shape == (H, W, 2)
        assert np.abs(b).max() > 0
        assert float(np.sqrt(((a - b) ** 2).sum(-1)).mean()) < 1e-4
    assert sorted(os.listdir(parity_runs["port"])) == [
        "args.json", "checkpoint", "inference", "model_best",
        "run.metrics.jsonl", "train-checkpoint"]


def test_args_json_matches_jax(parity_runs):
    """The two runs' args.json: the same keys but the flags dropped and
    added, and the same values but the save directory and the commit."""
    got, want = (json.loads((parity_runs[k] / "args.json").read_text())
                 for k in ("port", "jax"))
    assert set(got) == (set(want) - DROPPED) | ADDED
    assert got["device"] == "cpu" and got["git_hash"]
    for key in set(want) - DROPPED - {"save", "git_hash"}:
        assert got[key] == want[key], key


# ------------------------------------------------------------- port alone

def test_resume_run_dir_and_model_best(data, parity_runs, tmp_path):
    """--inference --resume of <run>/model_best (the validation checkpoint,
    before training) gives the flows of the .pth.tar's weights, and of the
    run directory (its train-checkpoint) the trained weights' flows;
    --resume of the run directory trains on (epoch 1, the count from 2 to
    4)."""
    run = tmp_path / "run"
    shutil.copytree(parity_runs["port"], run)
    flows = {}
    for what, resume in (("best", ["--resume", str(run / "model_best")]),
                         ("pth", ["--resume_torch",
                                  str(data["pth"]["FlowNet2S"])]),
                         ("run", ["--resume", str(run)])):
        save = tmp_path / what
        assert _cli(*_frames_args(data, save, "FlowNet2S", *resume)) == 0
        flows[what] = _flows(save)
    assert len(flows["best"]) == 2
    for a, b in zip(flows["best"], flows["pth"]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(flows["run"][0], flows["pth"][0])

    assert _cli(*_sintel_args(data, run, "--total_epochs", "2",
                              "--resume", str(run))) == 0
    records = _records(run)
    assert [(r["step"], r["split"]) for r in records
            if r["split"] in ("train", "val")][-3:] == \
        [(2, "val"), (3, "train"), (4, "train")]
    state = torch.load(run / "train-checkpoint" / "state.pt",
                       weights_only=True)
    assert state["optimizer"]["count"] == 4
    assert json.loads((run / "train-checkpoint" / "meta.json")
                      .read_text())["epoch"] == 2


@pytest.fixture(scope="module")
def converted(data):
    """FlowNet2S's seeded weights as a caffemodel, converted."""
    model = get_model("FlowNet2S", device="cpu", seed=3)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    path = data["root"] / "FlowNet2S.caffemodel"
    write_caffemodel(path, caffe_layers(state, "FlowNet2S"))
    assert convert.main([str(path), str(data["root"] / "ckpts"),
                         "--model", "FlowNet2S"]) == 0
    return data["root"] / "ckpts" / "FlowNet2S-caffe"


def test_inference_from_a_converted_caffemodel(data, converted, tmp_path):
    """--inference --resume of a convert checkpoint (the weights alone)
    writes the flows of the .pth.tar of the same weights, bit for bit; a
    training --resume of it raises, naming it."""
    for what, resume in (("caffe", ["--resume", str(converted)]),
                         ("pth", ["--resume_torch",
                                  str(data["pth"]["FlowNet2S"])])):
        assert _cli(*_frames_args(data, tmp_path / what, "FlowNet2S",
                                  *resume)) == 0
    got, want = _flows(tmp_path / "caffe"), _flows(tmp_path / "pth")
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="holds no optimizer state") as err:
        _cli(*_sintel_args(data, tmp_path / "train", "--total_epochs", "1",
                           "--resume", str(converted)))
    assert str(converted) in str(err.value)


def test_spatial_shards_inference_is_the_whole_map(data, tmp_path):
    """FlowNet2C (its correlation as two row bands): the flows of
    --spatial_shards 2 are the whole map's bit for bit, and the bands are
    set for the run only."""
    from flownet2_tpu_torch.ops import sharding_hints
    pth = ["--resume_torch", str(data["pth"]["FlowNet2C"])]
    sharding_hints.clear_dispatch_log()
    assert _cli(*_frames_args(data, tmp_path / "bands", "FlowNet2C", *pth,
                              "--spatial_shards", "2")) == 0
    assert sharding_hints.dispatch_log()["correlation"].startswith(
        "bands(spatial=2)")
    assert sharding_hints.spatial_shards() == 1
    sharding_hints.clear_dispatch_log()
    assert _cli(*_frames_args(data, tmp_path / "whole", "FlowNet2C",
                              *pth)) == 0
    got, want = _flows(tmp_path / "bands"), _flows(tmp_path / "whole")
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_bf16_inference_within_the_bf16_contract(data, tmp_path):
    """--precision bf16 against fp32 on the same weights: the JAX package's
    bf16 contract (tests/test_models.py TestBf16Precision), mean |d| <
    0.05 (mean |fp32| + 1e-3) + 5e-3."""
    pth = ["--resume_torch", str(data["pth"]["FlowNet2S"])]
    assert _cli(*_frames_args(data, tmp_path / "bf16", "FlowNet2S", *pth,
                              "--precision", "bf16")) == 0
    assert _cli(*_frames_args(data, tmp_path / "fp32", "FlowNet2S",
                              *pth)) == 0
    got, want = _flows(tmp_path / "bf16"), _flows(tmp_path / "fp32")
    assert len(got) == len(want) == 2
    assert not np.array_equal(got[0], want[0])
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        err = float(np.abs(a - b).mean())
        assert err < 0.05 * (float(np.abs(b).mean()) + 1e-3) + 5e-3, err
