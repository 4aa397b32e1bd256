"""Command line of the port: train, validate, run inference (the
counterpart of flownet2_tpu/cli/main.py, with the same flags).

Every registered model, loss, dataset and optimizer is selectable by name,
and its constructor parameters are exposed as ``--<group>_<param>`` flags,
read off the classes' signatures (the optimizers' off
``optimizer_param_defaults``).  ``--device`` (default ``cuda``) names the
device; ``--device cpu`` runs the plain PyTorch ops on the CPU.  Without a
CUDA device and without ``--device cpu`` the command raises.

Several cards: as the JAX command line uses every device the global batch
allows, the plain command with ``--device cuda`` on a machine with more than
one card starts ``parallel.data_ranks(batch, cards)`` ranks of itself, one a
card, through torchrun on this host, and fails if any rank fails.  Under
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) each process is one rank, on
``cuda:LOCAL_RANK`` (gloo with ``--device cpu``; a named ``cuda:K`` raises
there).  ``--device cpu`` and a named ``cuda:K`` never start ranks.
``--batch_size`` is the global batch; each rank reads its stripe.

``--spatial_shards S`` splits the rows in S bands.  Where a process group
holds a multiple of S ranks, the bands span ranks, as the JAX command
line's (data, spatial) mesh spans devices: the ranks are laid out (ranks /
S, S), each holds one band of its data rank's stripe and exchanges its
halos with the others (``parallel.DataParallelPlan(spatial=S)``), and the
plain command on a machine of S cards or more starts
``parallel.data_ranks(batch, cards, S) * S`` ranks.  The bands are cut on
granules of 64 rows, the first bands one granule taller where S does not
divide them (``--crop_size 384 448`` over 4: 128, 128, 64 and 64 rows).  In
one process, or on fewer cards than S, the bands run in turn on the
process's own device.  A frame height that is not a multiple of 64 with a
granule a band raises before the first step.

Examples:

  # training
  python -m flownet2_tpu_torch.cli --model FlowNet2 --loss MultiScale \\
      --optimizer Adam --optimizer_lr 1e-4 \\
      --training_dataset MpiSintelFinal --training_dataset_root /data/sintel \\
      --training_dataset_is_cropped --crop_size 384 768 \\
      --validation_dataset MpiSintelClean --validation_dataset_root /data/sintel

  # resume that run (its directory, or one of its checkpoints)
  python -m flownet2_tpu_torch.cli ... --resume ./work

  # the same training on 4 cards, as 4 processes
  torchrun --standalone --nproc_per_node=4 -m flownet2_tpu_torch.cli ...

  # inference from a reference checkpoint, or from a converted caffemodel
  python -m flownet2_tpu_torch.cli --inference --save_flow \\
      --model FlowNet2 --resume_torch /ckpts/FlowNet2_checkpoint.pth.tar \\
      --inference_dataset ImagesFromFolder --inference_dataset_root /frames
  python -m flownet2_tpu_torch.cli --inference --save_flow \\
      --model FlowNet2 --resume ./ckpts/FlowNet2-caffe \\
      --inference_dataset ImagesFromFolder --inference_dataset_root /frames
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
from pathlib import Path


def _flag_type(default):
    if isinstance(default, bool):
        return None  # handled as store_true/store_false
    if default is None:
        return str
    return type(default)


def _bool(text: str) -> bool:
    """A boolean flag's value: true/false, yes/no, on/off or 1/0."""
    value = text.strip().lower()
    if value in ("true", "yes", "on", "1"):
        return True
    if value in ("false", "no", "off", "0"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def add_arguments_for_class(parser: argparse.ArgumentParser, group: str,
                            cls, skip=("root", "dtype")) -> None:
    """--<group>_<param> flags from a class's constructor or dataclass
    fields, with their defaults."""
    if dataclasses.is_dataclass(cls):
        params = {f.name: (f.default if f.default is not dataclasses.MISSING
                           else None)
                  for f in dataclasses.fields(cls)}
    else:
        sig = inspect.signature(cls.__init__)
        params = {n: (p.default if p.default is not inspect.Parameter.empty
                      else None)
                  for n, p in sig.parameters.items()
                  if n not in ("self", "args", "kwargs", "kw")}
    for name, default in params.items():
        if name in skip or name.startswith("_"):
            continue
        flag = f"--{group}_{name}"
        if isinstance(default, bool):
            parser.add_argument(flag, action="store_true", default=default)
        elif isinstance(default, (list, tuple)):
            parser.add_argument(flag, nargs="+",
                                type=type(default[0]) if default else str,
                                default=list(default))
        else:
            parser.add_argument(flag, type=_flag_type(default), default=default)


def kwargs_from_args(args: argparse.Namespace, group: str) -> dict:
    """The --<group>_* values, as keyword arguments."""
    prefix = group + "_"
    return {k[len(prefix):]: v for k, v in vars(args).items()
            if k.startswith(prefix)}


def _preselect(argv, flag, default, choices):
    """First-stage scan: which class was selected for ``flag``?  Its
    parameters' flags are added to the parser."""
    # allow_abbrev=False: otherwise e.g. --inference would be read as an
    # abbreviation of --inference_dataset by this single-flag parser
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument(flag, default=default)
    got, _ = pre.parse_known_args(argv)
    val = getattr(got, flag.lstrip("-").replace("-", "_"))
    return val if val in choices else default


def build_parser(argv=None) -> argparse.ArgumentParser:
    from ..data import DATASETS
    from ..losses import LOSSES
    from ..models import MODELS
    from ..train.optim import OPTIMIZERS, optimizer_param_defaults

    p = argparse.ArgumentParser(
        "flownet2_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)

    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; cpu runs the plain "
                        "PyTorch ops)")
    p.add_argument("--inference", action="store_true")
    p.add_argument("--save_flow", action="store_true",
                   help="write .flo outputs during inference")
    p.add_argument("--inference_visualize", action="store_true",
                   help="write PNG flow visualizations during inference")
    p.add_argument("--inference_n_batches", type=int, default=-1,
                   help="limit inference to N batches")
    p.add_argument("--inference_batch_size", type=int, default=-1,
                   help="batch size for inference (-1 = use --batch_size)")
    p.add_argument("--validation_n_batches", type=int, default=-1)
    p.add_argument("--train_n_batches", type=int, default=-1,
                   help="cap training steps per epoch; -1 = whole loader")
    p.add_argument("--start_epoch", type=int, default=-1,
                   help="epoch to start/resume at; overrides the "
                        "checkpoint's epoch")
    p.add_argument("--skip_validation", action="store_true")
    p.add_argument("--render_validation", action="store_true",
                   help="write inference flows every validation epoch")
    p.add_argument("--save", default="./work", help="run/checkpoint dir")
    p.add_argument("--name", default="run")
    p.add_argument("--resume", default="",
                   help="native checkpoint to resume from: a run directory "
                        "or a checkpoint directory (with --inference, the "
                        "weights alone, so a converted caffemodel serves)")
    p.add_argument("--resume_torch", default="",
                   help="reference .pth.tar checkpoint to import")
    p.add_argument("--total_epochs", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--validation_frequency", type=int, default=5)
    p.add_argument("--log_frequency", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--crop_size", type=int, nargs="+", default=[256, 256])
    p.add_argument("--inference_size", type=int, nargs="+", default=[-1, -1])
    p.add_argument("--gradient_clip", type=float, default=None)
    p.add_argument("--schedule_lr_frequency", type=int, default=0,
                   help="in steps: divide LR by schedule_lr_fraction")
    p.add_argument("--schedule_lr_fraction", type=float, default=10.0)
    p.add_argument("--precision", choices=("fp32", "bf16", "fp16"),
                   default="fp32",
                   help="compute dtype (parameters stay fp32); fp16 "
                        "trains with the static loss scale --fp16_scale "
                        "and skips non-finite updates")
    p.add_argument("--fp16_scale", type=float, default=1024.0,
                   help="static loss scale under --precision fp16")
    p.add_argument("--tensorboard", action="store_true",
                   help="write tfevents scalars+histograms next to the "
                        "JSONL metrics")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="capture a torch.profiler Chrome trace over N early "
                        "train steps into <save>/profile")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="row bands (H split): across ranks where the "
                        "command runs as a multiple of S ranks (each rank "
                        "one band, cut on granules of 64 rows; H a multiple "
                        "of 64 with a granule a band), else the "
                        "correlation and the warps in turn on the one "
                        "device")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--skip_training", action="store_true")

    model_name = _preselect(argv, "--model", "FlowNet2", MODELS)
    loss_name = _preselect(argv, "--loss", "MultiScale", LOSSES)
    opt_name = _preselect(argv, "--optimizer", "Adam", OPTIMIZERS)

    p.add_argument("--model", default="FlowNet2", choices=sorted(MODELS))
    add_arguments_for_class(p, "model", MODELS[model_name])
    p.add_argument("--loss", default="MultiScale", choices=sorted(LOSSES))
    add_arguments_for_class(p, "loss", LOSSES[loss_name])
    p.add_argument("--optimizer", default="Adam", choices=sorted(OPTIMIZERS))
    p.add_argument("--optimizer_lr", type=float, default=1e-4)
    opt_defaults = optimizer_param_defaults(opt_name)
    for pname, default in opt_defaults.items():
        p.add_argument(f"--optimizer_{pname}",
                       type=(_bool if isinstance(default, bool)
                             else _flag_type(default)),
                       default=default)
    if "b1" in opt_defaults:  # torch-style --optimizer_betas B1 B2 alias
        p.add_argument("--optimizer_betas", type=float, nargs=2, default=None,
                       help="torch-style alias for (b1, b2)")

    # per-dataset constructor params (iext, ...) exposed as well
    _ds_common = ("root", "replicates", "is_cropped", "crop_size",
                  "inference_size", "seed", "flip_flow_vertical", "dtype")
    for group in ("training_dataset", "validation_dataset",
                  "inference_dataset"):
        p.add_argument(f"--{group}", default=None, choices=sorted(DATASETS))
        p.add_argument(f"--{group}_root", default="")
        p.add_argument(f"--{group}_replicates", type=int, default=1)
        p.add_argument(f"--{group}_is_cropped", action="store_true")
        ds_name = _preselect(argv, f"--{group}", None, DATASETS)
        if ds_name is not None:
            add_arguments_for_class(p, group, DATASETS[ds_name],
                                    skip=_ds_common)
    return p


def _build_dataset(args, group: str):
    from ..data import get_dataset

    name = getattr(args, group)
    if not name:
        return None
    # root, replicates, is_cropped and the class's own parameters
    return get_dataset(
        name,
        crop_size=tuple(args.crop_size),
        inference_size=tuple(args.inference_size),
        seed=args.seed,
        **kwargs_from_args(args, group),
    )


def _git_hash() -> str:
    """The commit of the checkout that runs the job, for args.json."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _inference_batch(args: argparse.Namespace) -> int:
    return (args.inference_batch_size if args.inference_batch_size > 0
            else args.batch_size)


def _ranks_to_start(args: argparse.Namespace) -> int:
    """How many ranks the command starts itself: with ``--device cuda``,
    outside torchrun's environment, on a machine with more than one card,
    the JAX command line's data-axis size for the batches of the run, times
    ``--spatial_shards`` where the cards hold that many bands; otherwise 1
    (this process is the run, or its rank)."""
    import torch

    from ..parallel import ENV_VARS, data_ranks

    cards = torch.cuda.device_count()
    if (args.device != "cuda" or any(v in os.environ for v in ENV_VARS)
            or cards < 2):
        return 1
    batch = math.gcd(args.batch_size, _inference_batch(args))
    spatial = args.spatial_shards
    if spatial > 1 and cards >= spatial:
        return data_ranks(batch, cards, spatial) * spatial
    return data_ranks(batch, cards)


def _bands_span_ranks(args: argparse.Namespace) -> bool:
    """Whether the row bands span the ranks: a process group of a multiple
    of ``--spatial_shards`` (> 1) ranks."""
    from ..parallel import is_distributed, world_size

    return (args.spatial_shards > 1 and is_distributed()
            and world_size() % args.spatial_shards == 0)


def _frame_height(ds) -> int:
    """The height of the frames a dataset gives: its crop or its render
    size."""
    return ds.crop_size[0] if ds.is_cropped else ds.render_size[0]


def _start_ranks(n_ranks: int, argv) -> int:
    """Run this command as ``n_ranks`` ranks on this host, one a card,
    through torchrun (``torch.distributed.run --standalone``), which gives
    each rank its variables and fails when any rank fails; returns its
    exit code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parents[2]),
                    env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n_ranks}", "-m", "flownet2_tpu_torch.cli",
         *argv], env=env).returncode


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from ..ops.sharding_hints import scoped_spatial_shards
    from ..parallel import (ENV_VARS, init_distributed, is_distributed,
                            local_rank, rank)
    from ..utils import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser(argv).parse_args(argv)
    dev = resolve_device(args.device)
    n_ranks = _ranks_to_start(args)
    if n_ranks > 1:
        print(f"starting {n_ranks} ranks on {torch.cuda.device_count()} "
              "cards", file=sys.stderr)
        return _start_ranks(n_ranks, argv)
    ranked = is_distributed() or all(v in os.environ for v in ENV_VARS)
    if ranked and dev.type == "cuda":
        # each rank runs on its own card
        if dev.index is not None:
            raise ValueError(
                f"--device {args.device} under a process group: every rank "
                "runs on cuda:LOCAL_RANK, so pass --device cuda")
        dev = torch.device("cuda", local_rank())
    started = not is_distributed() and init_distributed(
        backend="gloo" if dev.type == "cpu" else "nccl")
    try:
        os.makedirs(args.save, exist_ok=True)
        if rank() == 0:
            record = dict(vars(args))
            record["git_hash"] = _git_hash()
            with open(os.path.join(args.save, "args.json"), "w") as f:
                json.dump(record, f, indent=2, default=str)
        # --spatial_shards N on one process: the correlation and the warps
        # run as N row bands in turn, for this run only; across ranks the
        # plan holds the bands
        across = _bands_span_ranks(args)
        with scoped_spatial_shards(1 if across else args.spatial_shards):
            return _run(args, dev, args.spatial_shards if across else 1)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args: argparse.Namespace, dev, spatial: int = 1) -> int:
    """The run of this process: ``spatial`` row bands across the ranks of
    its process group (1: none)."""
    import torch

    from ..checkpoints import load_checkpoint, restore_checkpoint
    from ..checkpoints.native import resume_location
    from ..data import DataLoader, DeviceLoader
    from ..losses import get_loss
    from ..models import get_model
    from ..parallel import DataParallelPlan, is_distributed
    from ..train import (LRSchedule, StepFactory, Trainer, TrainerConfig,
                         get_optimizer)
    from ..utils import TimerBlock

    plan = (DataParallelPlan.current(dev, spatial=spatial)
            if is_distributed() else None)
    # the loader's stripes: one a data rank
    world, rank = (plan.data_size, plan.data_rank) if plan else (1, 0)
    with TimerBlock("Building model") as block:
        dtype = {"bf16": torch.bfloat16, "fp16": torch.float16,
                 "fp32": None}[args.precision]
        model = get_model(args.model, device=dev, seed=args.seed,
                          dtype=dtype, **kwargs_from_args(args, "model"))
        loss_kwargs = kwargs_from_args(args, "loss") \
            if args.loss == "MultiScale" else {}
        loss = get_loss(args.loss, **loss_kwargs)
        sched = LRSchedule(args.optimizer_lr, args.schedule_lr_frequency,
                           args.schedule_lr_fraction)
        opt_kwargs = kwargs_from_args(args, "optimizer")
        opt_kwargs.pop("lr", None)
        betas = opt_kwargs.pop("betas", None)
        if betas is not None:  # torch-style alias -> b1/b2
            opt_kwargs["b1"], opt_kwargs["b2"] = betas
        optimizer = get_optimizer(args.optimizer, args.optimizer_lr,
                                  schedule=sched,
                                  grad_clip=args.gradient_clip, **opt_kwargs)
        # fp16 takes a static loss scale and skips non-finite updates (the
        # reference's --fp16/--fp16_scale)
        fp16 = args.precision == "fp16"
        factory = StepFactory(model, loss, optimizer,
                              loss_scale=args.fp16_scale if fp16 else 1.0,
                              skip_nonfinite_updates=fp16, plan=plan)
        block.log(f"model={args.model} loss={args.loss} device={dev} "
                  f"world_size={plan.world_size if plan else 1} "
                  f"rank={plan.rank if plan else 0} data ranks={world} "
                  f"precision={args.precision} "
                  f"spatial_shards={args.spatial_shards}")

    trainer = Trainer(factory, TrainerConfig(
        total_epochs=args.total_epochs,
        validation_frequency=args.validation_frequency,
        validation_n_batches=args.validation_n_batches,
        log_frequency=args.log_frequency,
        train_n_batches=args.train_n_batches,
        start_epoch=args.start_epoch,
        save_dir=args.save, run_name=args.name,
        tensorboard=args.tensorboard,
        profile_steps=args.profile))

    with TimerBlock("Building datasets") as block:
        def loader(ds, shuffle, drop_last=True, batch_size=None):
            # train drops the ragged tail; validation and inference score
            # every sample, so their tail batch is padded and masked
            # (the global batch: each rank reads its stripe)
            return DeviceLoader(DataLoader(
                ds, batch_size or args.batch_size, shuffle=shuffle,
                drop_last=drop_last, num_workers=args.num_workers,
                seed=args.seed, process_count=world, process_index=rank),
                device=dev)
        train_ds = _build_dataset(args, "training_dataset")
        val_ds = _build_dataset(args, "validation_dataset")
        infer_ds = _build_dataset(args, "inference_dataset")
        for nm, ds in (("train", train_ds), ("val", val_ds),
                       ("infer", infer_ds)):
            if ds is not None:
                block.log(f"{nm}: {len(ds)} samples, render {ds.render_size}")
                if plan is not None and plan.spatial > 1:
                    # a height the bands cannot split raises here, before
                    # the first step
                    plan.band_rows(_frame_height(ds))
    if (infer_ds or val_ds or train_ds) is None:
        print("no dataset given — nothing to do", file=sys.stderr)
        return 2

    with TimerBlock("Loading weights") as block:
        if args.resume_torch:
            meta = load_checkpoint(args.resume_torch, factory.model)
            block.log(f"imported torch checkpoint (epoch={meta.get('epoch')}, "
                      f"best_EPE={meta.get('best_EPE')})")
        elif args.resume and args.inference:
            # the weights alone: a checkpoint without an optimizer's state
            # (a converted caffemodel) serves inference
            base, tag = resume_location(args.resume)
            meta = restore_checkpoint(base, factory.model, None, tag)
            block.log(f"restored the weights of {args.resume} "
                      f"(epoch={meta.get('epoch')})")
        elif args.resume:
            trainer.resume(args.resume)
            block.log(f"resumed at epoch {trainer.start_epoch}")

    infer_batch = _inference_batch(args)
    flow_dir = os.path.join(args.save, "inference", "flows") \
        if args.save_flow else None
    viz_dir = os.path.join(args.save, "inference", "viz") \
        if args.inference_visualize else None

    if args.inference:
        n, means = trainer.inference(
            loader(infer_ds or val_ds, False, drop_last=False,
                   batch_size=infer_batch),
            save_flow_dir=flow_dir, n_batches=args.inference_n_batches,
            visualize_dir=viz_dir)
        print(f"inference done ({n} flows, EPE {means['epe']:.4f})")
        return 0

    # a DeviceLoader runs its loader again at each iteration, so fit can
    # render every validation epoch from one
    render = args.render_validation and (infer_ds or val_ds)
    trainer.fit(loader(train_ds, True) if train_ds else [],
                val_loader=(loader(val_ds, False, drop_last=False)
                            if val_ds else None),
                skip_training=args.skip_training,
                skip_validation=args.skip_validation,
                inference_loader=(loader(infer_ds or val_ds, False,
                                         drop_last=False,
                                         batch_size=infer_batch)
                                  if render else None),
                render_validation=args.render_validation,
                render_dir=os.path.join(args.save, "inference", "flows"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
