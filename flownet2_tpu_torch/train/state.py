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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

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

    def __post_init__(self):
        self.optimizer.init(self.model.parameters())

    def _train_step(self, images: torch.Tensor, flow: torch.Tensor):
        self.model.train()
        self.optimizer.zero_grad()
        lossvalue, epevalue = self.loss_fn(self.model(images), flow)
        (lossvalue * self.loss_scale).backward()
        grads = self.optimizer.grads()
        if self.loss_scale != 1.0:
            for g in grads:
                g.div_(self.loss_scale)
        if not self.skip_nonfinite_updates or all(
                bool(torch.isfinite(g).all()) for g in grads):
            self.optimizer.step()
        return {"loss": lossvalue.detach(), "epe": epevalue.detach()}

    def train_step(self) -> Callable:
        """``(images (B, 2, H, W, 3), flow (B, H, W, 2)) -> {"loss",
        "epe"}``, one optimizer step; the gradients stay in ``.grad``."""
        return self._train_step

    def _metric_sums(self, pred, flow, n_valid: int):
        """Per-sample sums over the first ``n_valid`` samples: a padded
        tail batch must not count its padding."""
        loss_ps, epe_ps = self.loss_fn.per_sample(pred, flow)
        mask = (torch.arange(loss_ps.shape[0], device=loss_ps.device)
                < n_valid).to(loss_ps.dtype)
        return {"loss_sum": torch.sum(loss_ps * mask),
                "epe_sum": torch.sum(epe_ps * mask),
                "count": n_valid}

    def _eval_step(self, images: torch.Tensor, flow: torch.Tensor,
                   n_valid: int):
        return self._infer_metrics(images, flow, n_valid)[1]

    def eval_step(self) -> Callable:
        """``(images, flow, n_valid) -> {"loss_sum", "epe_sum", "count"}``
        in ``eval()`` mode, without gradients."""
        return self._eval_step

    def _infer(self, images: torch.Tensor):
        self.model.eval()
        with torch.inference_mode():
            return self.model(images)

    def infer_step(self) -> Callable:
        """``images -> flow`` in ``eval()`` mode, without gradients: flow
        only, no targets."""
        return self._infer

    def _infer_metrics(self, images: torch.Tensor, flow: torch.Tensor,
                       n_valid: int):
        self.model.eval()
        with torch.inference_mode():
            pred = self.model(images)
            return pred, self._metric_sums(pred, flow, n_valid)

    def infer_metrics_step(self) -> Callable:
        """``(images, flow, n_valid) -> (flow, {"loss_sum", "epe_sum",
        "count"})``: the flow and the masked sums of the eval step (the
        reference's inference loop reports per-batch losses, against zero
        targets where the dataset has no ground truth)."""
        return self._infer_metrics
