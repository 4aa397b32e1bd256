"""Epoch loop: validate -> best -> checkpoint -> train, and inference
(the counterpart of flownet2_tpu/train/trainer.py).

``Trainer(factory, config)`` drives a ``StepFactory``, whose steps update
its model and optimizer in place: where the JAX trainer takes and returns
a ``TrainState``, this one works on ``factory.model`` and
``factory.optimizer`` and ``global_step`` follows the optimizer's count.
``TrainerConfig`` has the JAX package's fields and defaults.

Under a ``DataParallelPlan`` every rank runs the Trainer on its stripe of
each batch: the metrics, the validation and inference means and the best
EPE are the global batch's, the same on every rank; rank 0 alone writes the
metric file, TensorBoard, the profile and the flows, which
``inference`` gathers from every rank first; every rank calls the
checkpoint saves, which rank 0 writes.  With row bands across ranks
(the plan's ``spatial``) the batches are the data rank's stripes at full
height, each rank's step cuts its band, and ``inference`` gathers the bands
and then the stripes.

The host keeps ahead of the card: each logged step's metrics are copied to
pinned host memory without blocking and read after the next step has been
queued, so the host never waits for the step it has just queued (a
``float()`` of a metric would).  The records, the ``nan_check`` raise and
the TensorBoard scalars come one step later on the host's clock, with the
step number they belong to.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Iterable, Optional

import torch

from ..checkpoints.native import (
    is_primary,
    restore_checkpoint,
    resume_location,
    save_checkpoint,
)
from ..parallel import all_gather_batch
from ..utils.tools import (
    IteratorTimer,
    MetricLogger,
    format_dictionary_of_losses,
    progress,
)


@dataclasses.dataclass
class TrainerConfig:
    total_epochs: int = 10000
    validation_frequency: int = 5
    validation_n_batches: int = -1     # batches a validation takes (-1: all)
    train_n_batches: int = -1          # cap of steps per epoch (-1: none)
    start_epoch: int = -1              # >= 0 overrides the resumed epoch
    checkpoint_frequency: int = 1      # epochs between train-checkpoints
    log_frequency: int = 1             # steps between metric records
    save_dir: str = "./work"
    run_name: str = "run"
    nan_check: bool = True             # raise on a non-finite train loss
    tensorboard: bool = False          # tfevents scalars and histograms
    histogram_frequency: int = 100     # steps between parameter histograms
    profile_steps: int = 0             # trace this many early train steps


class _HostMetrics:
    """A step's scalar metrics on their way to the host: stacked and copied
    into pinned memory without blocking, then read once the copy's event
    has completed."""

    def __init__(self, metrics: dict):
        self.keys = list(metrics)
        values = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                              .reshape(()) for k in self.keys])
        self.event = None
        if values.is_cuda:
            values = values.to("cpu", non_blocking=True)  # pinned
            self.event = torch.cuda.Event()
            self.event.record()
        self.values = values

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(self.keys, self.values.tolist()))


class Trainer:
    def __init__(self, factory, config: TrainerConfig):
        """factory: train.state.StepFactory."""
        self.factory = factory
        self.config = config
        # where torch.distributed runs, only rank 0 owns the metric,
        # TensorBoard and checkpoint files
        self.is_writer = is_primary()
        self.logger = MetricLogger(
            config.save_dir if self.is_writer else None, config.run_name)
        self._train_step = factory.train_step()
        self._eval_step = factory.eval_step()
        self.best_epe = float("inf")
        self.start_epoch = max(config.start_epoch, 0)
        self.global_step = factory.optimizer.count
        self._profiler = None
        self._profiled = config.profile_steps <= 0 or not self.is_writer
        self.tb_train = self.tb_val = None
        if config.tensorboard and self.is_writer:
            from ..utils.tensorboard import SummaryWriter
            self.tb_train = SummaryWriter(
                os.path.join(config.save_dir, "train"))
            self.tb_val = SummaryWriter(
                os.path.join(config.save_dir, "validation"))

    def _on_cuda(self) -> bool:
        return next(self.factory.model.parameters()).is_cuda

    def _maybe_profile(self, step_in_epoch: int):
        """``profile_steps`` N: trace steps [1, 1+N) of the first epoch
        (step 0 warms up) with torch.profiler, written as a Chrome trace
        under <save_dir>/profile."""
        if self._profiled and self._profiler is None:
            return
        if self._profiler is None and step_in_epoch == 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._on_cuda():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._profile_stop = step_in_epoch + self.config.profile_steps
        elif self._profiler is not None \
                and step_in_epoch >= self._profile_stop:
            self._stop_profile()

    def _stop_profile(self):
        if self._on_cuda():
            torch.cuda.synchronize()
        self._profiler.stop()
        out = os.path.join(self.config.save_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_step{self.global_step}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler, self._profiled = None, True
        print(f"  profile: trace written to {path}")

    # -- checkpoint plumbing -------------------------------------------------
    def resume(self, path: Optional[str] = None) -> dict:
        """Restore the factory's model and optimizer from ``path`` when
        given (a run directory holding a ``train-checkpoint``, or a
        checkpoint directory such as ``<run>/model_best``), else from this
        run's save dir; returns the checkpoint's metadata."""
        base, tag = (resume_location(path) if path
                     else (self.config.save_dir, "train-checkpoint"))
        meta = restore_checkpoint(base, self.factory.model,
                                  self.factory.optimizer, tag=tag)
        # start_epoch, when given, wins over the checkpoint's epoch
        self.start_epoch = (self.config.start_epoch
                            if self.config.start_epoch >= 0
                            else int(meta.get("epoch", 0)))
        self.best_epe = float(meta.get("best_EPE", float("inf")))
        self.global_step = self.factory.optimizer.count
        return meta

    def _save(self, epoch: int, is_best: bool = False,
              tag: str = "train-checkpoint") -> None:
        save_checkpoint(self.config.save_dir, self.factory.model,
                        self.factory.optimizer, epoch, self.best_epe,
                        is_best=is_best, tag=tag)

    # -- loops ---------------------------------------------------------------
    def _log_train(self, step: int, pending: _HostMetrics,
                   load_s: float) -> dict:
        host = pending.result()
        host["load_s"] = load_s
        self.logger.log(step, "train", host)
        if self.tb_train is not None:
            self.tb_train.add_scalars(host, step)
        if self.config.nan_check and not math.isfinite(host["loss"]):
            raise FloatingPointError(
                f"non-finite training loss {host['loss']} at step {step}")
        return host

    def train_epoch(self, loader: Iterable, epoch: int,
                    loss_labels=("loss", "EPE")) -> dict:
        """One epoch of train steps; returns the last metric record."""
        timer = IteratorTimer(loader)
        n = len(loader) if hasattr(loader, "__len__") else None
        last = {}
        pending = None
        cap = self.config.train_n_batches
        if cap >= 0 and n is not None:
            n = min(n, cap)
        for i, batch in enumerate(progress(timer, total=n,
                                           desc=f"train e{epoch}")):
            if cap >= 0 and i >= cap:
                break
            self._maybe_profile(i)
            metrics = self._train_step(batch.images, batch.flow)
            self.global_step += 1
            # the previous step's record, read now that this one is queued
            if pending is not None:
                last = self._log_train(*pending)
                pending = None
            if self.global_step % self.config.log_frequency == 0:
                pending = (self.global_step, _HostMetrics(metrics),
                           timer.last_duration)
            if (self.tb_train is not None
                    and self.global_step % self.config.histogram_frequency
                    == 0):
                # one histogram per named parameter
                for name, p in self.factory.model.named_parameters():
                    self.tb_train.add_histogram(
                        name.replace(".", "/"),
                        p.detach().float().cpu().numpy(), self.global_step)
        if pending is not None:
            last = self._log_train(*pending)
        if self._profiler is not None:  # epoch shorter than the window
            self._stop_profile()
        return last

    def validate(self, loader: Iterable, epoch: int,
                 n_batches: int = -1) -> dict:
        """Sample-weighted validation means: the tail batch of a
        drop_last=False loader is padded; the eval step masks the padding
        and returns sums and the true count, so every real sample counts
        exactly once."""
        loss_sum = epe_sum = 0.0
        count = 0
        n = len(loader) if hasattr(loader, "__len__") else None
        for i, batch in enumerate(progress(loader, total=n,
                                           desc=f"val e{epoch}")):
            if n_batches >= 0 and i >= n_batches:
                break
            n_valid = batch.n_valid if batch.n_valid is not None \
                else batch.images.shape[0]
            sums = self._eval_step(batch.images, batch.flow, n_valid)
            loss_sum += float(sums["loss_sum"])
            epe_sum += float(sums["epe_sum"])
            count += int(sums["count"])
        means = {"loss": loss_sum / max(count, 1),
                 "epe": epe_sum / max(count, 1), "n_samples": count}
        self.logger.log(self.global_step, "val", means)
        if self.tb_val is not None:
            self.tb_val.add_scalars(means, self.global_step)
        print("  validation:",
              format_dictionary_of_losses(means.keys(), means.values()))
        return means

    def fit(self, train_loader, val_loader=None,
            skip_training: bool = False, skip_validation: bool = False,
            inference_loader=None, render_validation: bool = False,
            render_dir: Optional[str] = None) -> None:
        """Per epoch from ``start_epoch``: inference when rendering,
        validation every ``validation_frequency`` epochs (best EPE, a
        ``checkpoint`` and ``model_best``), one train epoch, and a
        ``train-checkpoint`` every ``checkpoint_frequency`` epochs."""
        cfg = self.config
        for epoch in range(self.start_epoch, cfg.total_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)

            if (inference_loader is not None and render_validation
                    and epoch % cfg.validation_frequency == 0):
                self.inference(inference_loader, save_flow_dir=render_dir)

            if val_loader is not None and not skip_validation and (
                    epoch % cfg.validation_frequency == 0):
                means = self.validate(val_loader, epoch,
                                      n_batches=cfg.validation_n_batches)
                epe = means.get("epe", float("inf"))
                is_best = epe < self.best_epe
                self.best_epe = min(self.best_epe, epe)
                self._save(epoch, is_best=is_best, tag="checkpoint")

            if skip_training:
                break

            self.train_epoch(train_loader, epoch)
            if epoch % cfg.checkpoint_frequency == 0:
                self._save(epoch + 1)

    def inference(self, loader: Iterable,
                  save_flow_dir: Optional[str] = None,
                  n_batches: int = -1, visualize_dir: Optional[str] = None):
        """Forward each batch, reporting loss and EPE (against zero targets
        where the dataset has no ground truth), and write each real
        sample's flow as ``<n>.flo`` and as a PNG rendering where asked;
        ``n_batches`` -1 takes the whole set.  Under a plan each batch's
        flows are gathered from every rank in rank order (the global
        batch) and rank 0 writes them, numbered as one process numbers
        them.  Returns (flows written, means)."""
        from ..data.flow_io import flow_to_image, write_flo

        step = self.factory.infer_metrics_step()
        for d in (save_flow_dir, visualize_dir):
            if d:
                os.makedirs(d, exist_ok=True)
        n = 0
        loss_sum = epe_sum = 0.0
        count = 0
        total = len(loader) if hasattr(loader, "__len__") else None
        for i, batch in enumerate(progress(loader, total=total,
                                           desc="inference")):
            if n_batches >= 0 and i >= n_batches:
                break
            n_valid = batch.n_valid if batch.n_valid is not None \
                else batch.images.shape[0]
            flows, sums = step(batch.images, batch.flow, n_valid)
            loss_sum += float(sums["loss_sum"])
            epe_sum += float(sums["epe_sum"])
            count += int(sums["count"])
            if self.factory.plan is not None and (save_flow_dir
                                                  or visualize_dir):
                flows = all_gather_batch(flows.float(), self.factory.plan)
            if (save_flow_dir or visualize_dir) and self.is_writer:
                # this batch's real (unpadded) samples only
                flows_np = flows[:n_valid].float().cpu().numpy()
                for f in flows_np:
                    if save_flow_dir:
                        write_flo(
                            os.path.join(save_flow_dir, f"{n:06d}.flo"), f)
                    if visualize_dir:
                        from PIL import Image
                        Image.fromarray(flow_to_image(f)).save(
                            os.path.join(visualize_dir, f"{n:06d}.png"))
                    n += 1
            else:
                n += int(n_valid)
        means = {"loss": loss_sum / max(count, 1),
                 "epe": epe_sum / max(count, 1), "n_samples": count}
        self.logger.log(self.global_step, "inference", means)
        print("  inference:",
              format_dictionary_of_losses(means.keys(), means.values()))
        return n, means
