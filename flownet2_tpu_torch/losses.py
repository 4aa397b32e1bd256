"""Flow losses and the EPE metric (counterpart of flownet2_tpu/losses.py).

Each loss maps (output, target) to ``[loss, epe]``, as the reference's
losses do, and has a ``per_sample`` form giving ``[(B,) loss, (B,) epe]``
for masked validation.  Flows are ``(B, H, W, 2)``, the layout FlowNet2's
``forward`` returns; a multi-scale output is a tuple of such flows, finest
first.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from .ops.upsample import avg_pool

FlowOutput = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def _mean_per_sample(x: torch.Tensor) -> torch.Tensor:
    """Mean over all axes but the batch axis -> (B,)."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _norm(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The L2 norm of the flow residual, (B, H, W)."""
    return torch.sqrt(torch.sum((target - pred) ** 2, dim=-1))


def epe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """End-point error: the mean L2 norm of the flow residual."""
    return _norm(pred, target).mean()


def epe_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _mean_per_sample(_norm(pred, target))


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return torch.abs(pred - target).mean()


def l1_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _mean_per_sample(torch.abs(pred - target))


# The reference's L2 loss is the mean L2 norm over the flow axis: the EPE.
l2 = epe
l2_per_sample = epe_per_sample


def _finest(output: FlowOutput) -> torch.Tensor:
    return output[0] if isinstance(output, tuple) else output


@dataclasses.dataclass(frozen=True)
class L1Loss:
    """[L1, EPE]."""
    loss_labels = ("L1", "EPE")

    def __call__(self, output: FlowOutput, target: torch.Tensor):
        output = _finest(output)
        return [l1(output, target), epe(output, target)]

    def per_sample(self, output: FlowOutput, target: torch.Tensor):
        output = _finest(output)
        return [l1_per_sample(output, target), epe_per_sample(output, target)]


@dataclasses.dataclass(frozen=True)
class L2Loss:
    """[L2, EPE]."""
    loss_labels = ("L2", "EPE")

    def __call__(self, output: FlowOutput, target: torch.Tensor):
        output = _finest(output)
        return [l2(output, target), epe(output, target)]

    def per_sample(self, output: FlowOutput, target: torch.Tensor):
        output = _finest(output)
        return [l2_per_sample(output, target), epe_per_sample(output, target)]


@dataclasses.dataclass(frozen=True)
class MultiScale:
    """The multi-scale training loss.

    For a tuple of outputs the target is scaled by ``div_flow``,
    average-pooled to each scale (``start_scale * 2**s``), and the scales'
    losses and EPEs are summed with weights ``l_weight / 2**s``.  A single
    output gets the plain [loss, EPE] at full resolution.
    """
    start_scale: int = 4
    num_scales: int = 5
    l_weight: float = 0.32
    norm: str = "L1"
    div_flow: float = 0.05

    @property
    def loss_labels(self):
        return ("MultiScale-" + self.norm, "EPE")

    def _sum(self, output, target, loss_fn, epe_fn):
        if not isinstance(output, tuple):
            return [loss_fn(output, target), epe_fn(output, target)]
        # NHWC -> NCHW to pool, and back
        target = (self.div_flow * target).permute(0, 3, 1, 2)
        lossvalue = epevalue = 0.0
        for i, out in enumerate(output[:self.num_scales]):
            weight = self.l_weight / (2 ** i)
            target_i = avg_pool(target, self.start_scale * (2 ** i)).permute(
                0, 2, 3, 1)
            epevalue = epevalue + weight * epe_fn(out, target_i)
            lossvalue = lossvalue + weight * loss_fn(out, target_i)
        return [lossvalue, epevalue]

    def __call__(self, output: FlowOutput, target: torch.Tensor):
        return self._sum(output, target, l1 if self.norm == "L1" else l2, epe)

    def per_sample(self, output: FlowOutput, target: torch.Tensor):
        loss_fn = l1_per_sample if self.norm == "L1" else l2_per_sample
        return self._sum(output, target, loss_fn, epe_per_sample)


LOSSES = {
    "L1Loss": L1Loss,
    "L2Loss": L2Loss,
    "MultiScale": MultiScale,
}


def get_loss(name: str, **kwargs):
    """An instance of the named loss."""
    try:
        cls = LOSSES[name]
    except KeyError:
        raise KeyError(
            f"unknown loss {name!r}; available: {sorted(LOSSES)}") from None
    return cls(**kwargs)
