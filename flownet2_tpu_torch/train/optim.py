"""Optimizers by name and the LR step schedule (counterpart of
flownet2_tpu/train/optim.py).

The JAX package builds optax transforms, so the port gives optax's
updates with optax's defaults, which differ from torch.optim's in places:
AdamW's weight decay is 1e-4 (torch 1e-2); RMSprop's decay is 0.9 with eps
inside the square root and a second moment that starts at 0 (torch:
alpha 0.99, eps outside); Adagrad's accumulator starts at 0.1 with eps
1e-7 inside the square root (torch: 0 and 1e-10 outside).  Adam, AdamW,
SGD and Momentum are torch.optim's, with those defaults; RMSprop and
Adagrad are written out here.  ``grad_clip`` is optax's
``clip_by_global_norm``: the gradients are scaled by
``clip / max(norm, clip)`` (``clip_grad_norm_`` adds 1e-6 to the norm).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    """Step decay: ``base_lr / fraction**(step // frequency)``, floored at
    ``floor``; ``frequency <= 0`` keeps ``base_lr``."""
    base_lr: float
    frequency: int = 0
    fraction: float = 2.0
    floor: float = 1e-6

    def __call__(self, step: int) -> float:
        if self.frequency <= 0:
            return self.base_lr
        return max(self.base_lr / self.fraction ** (step // self.frequency),
                   self.floor)


class _RMSprop(torch.optim.Optimizer):
    """optax.rmsprop (not centred, no momentum): nu = decay*nu +
    (1-decay)*g^2 from ``initial_scale``, update -lr*g/sqrt(nu + eps)
    (eps outside the root when ``eps_in_sqrt`` is False)."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0,
                 eps_in_sqrt=True):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale,
                                      eps_in_sqrt=eps_in_sqrt))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                denom = ((nu + group["eps"]).sqrt() if group["eps_in_sqrt"]
                         else nu.sqrt() + group["eps"])
                p.addcdiv_(p.grad, denom, value=-group["lr"])


class _Adagrad(torch.optim.Optimizer):
    """optax.adagrad: sum = sum + g^2 from ``initial_accumulator_value``,
    update -lr*g/sqrt(sum + eps) (0 where sum is 0)."""

    def __init__(self, params, lr, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum"]
                acc.addcmul_(p.grad, p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    torch.zeros_like(acc))
                p.add_(p.grad * scale, alpha=-group["lr"])


def _adam(params, lr, b1=0.9, b2=0.999, eps=1e-8):
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def _adamw(params, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, lr, momentum=None, nesterov=False):
    return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0,
                           nesterov=nesterov)


def _momentum(params, lr, momentum=0.9, nesterov=False):
    return _sgd(params, lr, momentum, nesterov)


OPTIMIZERS = {
    "Adam": _adam,
    "AdamW": _adamw,
    "SGD": _sgd,
    "Momentum": _momentum,
    "RMSprop": _RMSprop,
    "Adagrad": _Adagrad,
}


class Optimizer:
    """A named optimizer with its schedule and clip, bound to parameters by
    ``init``; ``step`` clips the gradients, sets the learning rate of the
    current step and updates the parameters in place."""

    def __init__(self, name: str, lr: float,
                 schedule: Optional[LRSchedule] = None,
                 grad_clip: Optional[float] = None, **kwargs):
        self.name = name
        self.schedule = schedule or LRSchedule(lr)
        self.grad_clip = grad_clip
        self.kwargs = kwargs
        self.count = 0
        self.inner: Optional[torch.optim.Optimizer] = None

    def init(self, params: Iterable[torch.nn.Parameter]) -> "Optimizer":
        self.params = [p for p in params if p.requires_grad]
        self.inner = OPTIMIZERS[self.name](self.params, self.schedule(0),
                                           **self.kwargs)
        self.count = 0
        return self

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def grads(self) -> list:
        return [p.grad for p in self.params if p.grad is not None]

    @torch.no_grad()
    def step(self) -> None:
        if self.grad_clip is not None:
            grads = self.grads()
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
            for g in grads:
                g.mul_(scale)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        """The step count (which drives the schedule) and the inner
        ``torch.optim`` state, for a checkpoint."""
        return {"name": self.name, "count": self.count,
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Take back a ``state_dict`` of the same optimizer, bound to the
        same parameters in the same order (``init`` first)."""
        if state["name"] != self.name:
            raise ValueError(f"a {state['name']} state for a {self.name} "
                             "optimizer")
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def get_optimizer(name: str, lr: float, schedule: Optional[LRSchedule] = None,
                  grad_clip: Optional[float] = None, **kwargs) -> Optimizer:
    """The named optimizer, to be bound to parameters with ``init``;
    ``grad_clip`` clips by the global norm of all gradients first."""
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available: "
                       f"{sorted(OPTIMIZERS)}")
    return Optimizer(name, lr, schedule, grad_clip, **kwargs)
