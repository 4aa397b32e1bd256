"""The train, eval and inference steps (counterpart of
flownet2_tpu/train/state.py).

``StepFactory(model, loss_fn, optimizer)`` binds the optimizer to the
model's parameters and hands out the steps.  The train step runs the model
in ``train()`` mode with the loss inside, as the reference's ModelAndLoss
does, and updates the parameters and the optimizer's state in place
(where the JAX step returns a new state: here nothing is copied).  A
bfloat16 model (``get_model(..., dtype=torch.bfloat16)``) trains as the
JAX package's bf16 model does: its parameters stay float32, the master
weights, and get float32 gradients through the convolutions' casts; the
loss compares the bf16 flow with the float32 target in float32; the
optimizer steps in float32.  The
step number lives in the optimizer (``optimizer.count``), which feeds the
LR schedule.

With a ``parallel.DataParallelPlan`` the factory is one rank of a
data-parallel run, the counterpart of the JAX factory's ``MeshPlan``: the
train step runs the model wrapped in ``DistributedDataParallel`` on the
plan's device, whose backward leaves every rank the mean of the ranks'
gradients (the global batch's gradient), so the optimizer takes the same
step everywhere and the gradient clip and the non-finite check see the
same gradients; BatchNorm takes the global batch's statistics
(``nn.layers.set_global_batch_norm``); the returned loss and EPE are the
global batch's means, and the eval and infer-metrics sums are the global
batch's, each rank masking the padding of its own stripe.  Each step's
batch is the rank's stripe of the global batch.

With row bands across ranks (a plan with ``spatial`` S > 1) each step takes
its data rank's stripe at full height, cuts this rank's band of the rows
(``plan.band_rows``, which raises unless H / S is a multiple of 64) and runs
the model and the loss under ``plan.band_context()``.  The bands are equal,
so each rank's loss, a mean over its band's rows, is one S-th of its
stripe's share of the global loss, and DDP's mean of the D * S ranks'
gradients is the global batch's gradient: the halo exchanges send each
band's gradient home within the backward (tests/test_torch_spatial_ranks.py
holds it against one process and against the JAX package's step on one
device and on its (1, 2) mesh).  The per-sample metric sums take each
sample's mean over its bands (the rank's per-sample means over S, summed
over the group) and count each sample once; ``infer_step`` returns the
rank's band of the flow.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..nn.layers import set_global_batch_norm
from ..parallel import DataParallelPlan, all_reduce_sum
from .optim import Optimizer


@dataclasses.dataclass
class StepFactory:
    """Train, eval and inference steps for (model, loss, optimizer).  ``loss_scale``
    multiplies the loss before the backward and divides the gradients
    after it (fp16 parity experiments); ``skip_nonfinite_updates`` leaves
    the parameters and the optimizer untouched when any gradient is not
    finite, where the reference stops."""
    model: torch.nn.Module
    loss_fn: Any
    optimizer: Optimizer
    loss_scale: float = 1.0
    skip_nonfinite_updates: bool = False
    plan: Optional[DataParallelPlan] = None

    def __post_init__(self):
        self.optimizer.init(self.model.parameters())
        # the module the train step calls: the model, or under a plan its
        # DistributedDataParallel wrapper (which broadcasts rank 0's
        # parameters and buffers here, and the buffers before each forward)
        self.net = self.model
        if self.plan is not None:
            from torch.nn.parallel import DistributedDataParallel

            dev = self.plan.device
            if next(self.model.parameters()).device != dev:
                raise ValueError(f"the model is not on the plan's device "
                                 f"{dev}")
            set_global_batch_norm(self.model)
            # every parameter of the six models takes part in the loss
            # (tests/test_torch_parallel.py), so DDP need not search the
            # graph for unused ones
            self.net = DistributedDataParallel(
                self.model, device_ids=[dev] if dev.type == "cuda" else None)

    def _band(self, images: torch.Tensor, flow: Optional[torch.Tensor] = None):
        """This rank's band of the rows of ``images`` (B, 2, H, W, 3) and
        ``flow`` (B, H, W, 2) under a plan with row bands; else them."""
        if self.plan is None or self.plan.spatial == 1:
            return images, flow
        rows = self.plan.band_rows(images.shape[2])
        return images[:, :, rows], None if flow is None else flow[:, rows]

    def _context(self):
        """The band context the model runs in (none without row bands)."""
        return (contextlib.nullcontext() if self.plan is None
                else self.plan.band_context())

    def _global_mean(self, *values: torch.Tensor) -> torch.Tensor:
        """The values stacked and, under a plan, averaged over the ranks."""
        out = torch.stack([v.detach().float() for v in values])
        if self.plan is not None:
            all_reduce_sum(out).div_(self.plan.world_size)
        return out

    def _train_step(self, images: torch.Tensor, flow: torch.Tensor):
        self.net.train()
        self.optimizer.zero_grad()
        images, flow = self._band(images, flow)
        with self._context():
            lossvalue, epevalue = self.loss_fn(self.net(images), flow)
        (lossvalue * self.loss_scale).backward()
        grads = self.optimizer.grads()
        if self.loss_scale != 1.0:
            for g in grads:
                g.div_(self.loss_scale)
        if not self.skip_nonfinite_updates or all(
                bool(torch.isfinite(g).all()) for g in grads):
            self.optimizer.step()
        if self.plan is None:
            return {"loss": lossvalue.detach(), "epe": epevalue.detach()}
        loss, epe = self._global_mean(lossvalue, epevalue)
        return {"loss": loss, "epe": epe}

    def train_step(self) -> Callable:
        """``(images (B, 2, H, W, 3), flow (B, H, W, 2)) -> {"loss",
        "epe"}``, one optimizer step; the gradients stay in ``.grad``.
        Under a plan the batch is this rank's stripe (at full height) and
        the metrics are the global batch's."""
        return self._train_step

    def _metric_sums(self, pred, flow, n_valid: int):
        """Per-sample sums over the first ``n_valid`` samples: a padded
        tail batch must not count its padding.  Under a plan ``n_valid``
        counts the global batch, this rank masks its own stripe, and the
        sums are the global batch's; with row bands ``pred`` and ``flow``
        are this rank's band, and a sample's mean is its bands' mean."""
        loss_ps, epe_ps = self.loss_fn.per_sample(pred, flow)
        if self.plan is not None and self.plan.spatial > 1:
            loss_ps, epe_ps = (t / self.plan.spatial for t in (loss_ps,
                                                               epe_ps))
        local = loss_ps.shape[0]
        valid = (n_valid if self.plan is None
                 else self.plan.valid_in_stripe(n_valid, local))
        mask = (torch.arange(local, device=loss_ps.device)
                < valid).to(loss_ps.dtype)
        sums = torch.stack([torch.sum(loss_ps * mask),
                            torch.sum(epe_ps * mask)])
        if self.plan is not None:
            all_reduce_sum(sums)
        return {"loss_sum": sums[0], "epe_sum": sums[1], "count": n_valid}

    def _eval_step(self, images: torch.Tensor, flow: torch.Tensor,
                   n_valid: int):
        return self._infer_metrics(images, flow, n_valid)[1]

    def eval_step(self) -> Callable:
        """``(images, flow, n_valid) -> {"loss_sum", "epe_sum", "count"}``
        in ``eval()`` mode, without gradients."""
        return self._eval_step

    def _infer(self, images: torch.Tensor):
        self.model.eval()
        images, _ = self._band(images)
        with torch.inference_mode(), self._context():
            return self.model(images)

    def infer_step(self) -> Callable:
        """``images -> flow`` in ``eval()`` mode, without gradients: flow
        only, no targets.  With row bands, this rank's band of it."""
        return self._infer

    def _infer_metrics(self, images: torch.Tensor, flow: torch.Tensor,
                       n_valid: int):
        self.model.eval()
        images, flow = self._band(images, flow)
        with torch.inference_mode(), self._context():
            pred = self.model(images)
            return pred, self._metric_sums(pred, flow, n_valid)

    def infer_metrics_step(self) -> Callable:
        """``(images, flow, n_valid) -> (flow, {"loss_sum", "epe_sum",
        "count"})``: the flow and the masked sums of the eval step (the
        reference's inference loop reports per-batch losses, against zero
        targets where the dataset has no ground truth).  With row bands
        the flow is this rank's band of it."""
        return self._infer_metrics
