"""Optimizers by name and the LR step schedule (counterpart of
flownet2_tpu/train/optim.py).

The JAX package builds optax transforms, so the port gives optax's
updates with optax's defaults, which differ from torch.optim's in places:
AdamW's weight decay is 1e-4 (torch 1e-2); RMSprop's decay is 0.9 with eps
inside the square root and a second moment that starts at 0 (torch:
alpha 0.99, eps outside); Adagrad's accumulator starts at 0.1 with eps
1e-7 inside the square root (torch: 0 and 1e-10 outside).  Adam, AdamW,
SGD and Momentum are torch.optim's, with those defaults; RMSprop and
Adagrad are written out here, and so are Adam and AdamW with optax's
``eps_root`` or ``nesterov`` (optax's Nesterov Adam, not torch's NAdam).
Every numeric or boolean parameter of the optax constructors is taken,
under optax's name (``optimizer_param_defaults``).  ``grad_clip`` is optax's
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


def _ema(moment: torch.Tensor, value: torch.Tensor,
         decay: float) -> torch.Tensor:
    """``moment`` <- (1 - decay)*value + decay*moment in place, in optax's
    order of operations (``optax.tree.update_moment``)."""
    return moment.mul_(decay).add_(value * (1 - decay))


def _debias(decay: float, count: int) -> float:
    """optax's bias correction 1 - decay^count, computed in float32 as
    optax computes it."""
    one = torch.tensor(1.0)
    return float(one - torch.tensor(decay) ** count)


class _RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: nu = decay*nu + (1-decay)*g^2 from ``initial_scale``
    and, ``centered``, mu = decay*mu + (1-decay)*g from 0, both divided by
    1 - decay^count with ``bias_correction``; the update -lr*g/sqrt(nu -
    mu^2 + eps) (eps outside the root when ``eps_in_sqrt`` is False), then,
    with a ``momentum``, the trace t = u + momentum*t and the update t, or
    u + momentum*t with ``nesterov`` (which, as in optax, acts only with a
    momentum)."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0,
                 eps_in_sqrt=True, centered=False, momentum=None,
                 nesterov=False, bias_correction=False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
            eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
            nesterov=nesterov, bias_correction=bias_correction))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            decay, eps = group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                    if group["centered"]:
                        state["mu"] = torch.zeros_like(p)
                    if group["momentum"] is not None:
                        state["trace"] = torch.zeros_like(p)
                nu = _ema(state["nu"], g.square(), decay)
                mu = state.get("mu")
                if mu is not None:
                    mu = _ema(mu, g, decay)
                # (a state saved before the count was kept has none)
                state["count"] = state.get("count", 0) + 1
                if group["bias_correction"]:
                    correction = _debias(decay, state["count"])
                    nu = nu / correction
                    mu = None if mu is None else mu / correction
                if mu is not None:
                    nu = nu - mu * mu
                denom = ((nu + eps).sqrt() if group["eps_in_sqrt"]
                         else nu.sqrt() + eps)
                update = g / denom * -group["lr"]
                trace = state.get("trace")
                if trace is not None:
                    trace.mul_(group["momentum"]).add_(update)
                    update = (update + group["momentum"] * trace
                              if group["nesterov"] else trace)
                p.add_(update)


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


class _OptaxAdam(torch.optim.Optimizer):
    """optax.adam and optax.adamw (``optax.scale_by_adam``) where torch's
    Adam does not compute the same update: mu = b1*mu + (1-b1)*g,
    nu = b2*nu + (1-b2)*g^2, count += 1; mu_hat = mu/(1 - b1^count), or
    with ``nesterov`` b1*mu/(1 - b1^(count+1)) + (1-b1)*g/(1 - b1^count);
    nu_hat = nu/(1 - b2^count); the update -lr*(mu_hat/(sqrt(nu_hat +
    eps_root) + eps) + weight_decay*p)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 nesterov=False, weight_decay=0.0):
        super().__init__(params, dict(
            lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
            nesterov=nesterov, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                    state["count"] = 0
                mu = _ema(state["mu"], g, b1)
                nu = _ema(state["nu"], g.square(), b2)
                state["count"] += 1
                count = state["count"]
                if group["nesterov"]:
                    mu_hat = (b1 * (mu / _debias(b1, count + 1))
                              + (1 - b1) * (g / _debias(b1, count)))
                else:
                    mu_hat = mu / _debias(b1, count)
                nu_hat = nu / _debias(b2, count)
                update = mu_hat / ((nu_hat + group["eps_root"]).sqrt()
                                   + group["eps"])
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.add_(update, alpha=-group["lr"])


def _adam(params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          nesterov=False):
    if eps_root or nesterov:
        return _OptaxAdam(params, lr, b1, b2, eps, eps_root, nesterov)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def _adamw(params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
           weight_decay=1e-4, nesterov=False):
    if eps_root or nesterov:
        return _OptaxAdam(params, lr, b1, b2, eps, eps_root, nesterov,
                          weight_decay)
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, lr, momentum=None, nesterov=False):
    # as in optax, Nesterov's form acts only with a momentum (torch's SGD
    # refuses it without one)
    return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0,
                           nesterov=bool(nesterov and momentum))


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

# The numeric and boolean parameters of each optimizer's optax constructor,
# with their defaults (Momentum's own momentum), in the constructor's
# order: the JAX package reads them off optax's signatures
# (flownet2_tpu/train/optim.py, optimizer_param_defaults), and its command
# line exposes each as --optimizer_<name>.  Parameters whose default is
# None (SGD's and RMSprop's momentum) are not among them.
_PARAM_DEFAULTS = {
    "Adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
             "nesterov": False},
    "AdamW": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
              "weight_decay": 1e-4, "nesterov": False},
    "SGD": {"nesterov": False},
    "Momentum": {"nesterov": False, "momentum": 0.9},
    "RMSprop": {"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0,
                "eps_in_sqrt": True, "centered": False, "nesterov": False,
                "bias_correction": False},
    "Adagrad": {"initial_accumulator_value": 0.1, "eps": 1e-7},
}


def optimizer_param_defaults(name: str) -> dict:
    """{parameter: default} of the named optimizer's tunable numeric and
    boolean parameters (the learning rate apart)."""
    return dict(_PARAM_DEFAULTS[name])


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
