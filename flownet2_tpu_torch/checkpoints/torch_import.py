"""Weights into the port: reference ``.pth.tar`` checkpoints, and Flax
variables of the JAX package given as numpy arrays.

The port's modules carry the reference's state_dict keys, so a reference
checkpoint ``{'arch', 'epoch', 'state_dict', 'best_EPE'}`` loads as it is
(``load_checkpoint``).  ``from_jax_variables`` is the exact inverse of the
JAX package's ``state_dict_to_variables``
(flownet2_tpu/checkpoints/torch_import.py:64-139):

    <subnet>/<module>/conv/{kernel,bias}   -> <subnet>.<module>[.0].{weight,bias}
    <subnet>/<module>/bn/{scale,bias}      -> <subnet>.<module>.1.{weight,bias}
    batch_stats .../bn/{mean,var}          -> ....1.{running_mean,running_var}
    <subnet>/<module>/tconv/{kernel,bias}  -> <subnet>.<module>[.0].{weight,bias}

Conv kernels go HWIO -> OIHW; transposed-conv kernels, which the JAX
package stores flipped, are un-flipped back to torch's (in, out, kh, kw).
The Sequential index ``.0`` is dropped for the bare ``predict_flow*`` and
``upsampled_flow*`` modules, as in the reference.
"""

from __future__ import annotations

import pathlib
from typing import Any, Mapping

import numpy as np
import torch

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _is_bare(module: str) -> bool:
    return module.startswith(("predict_flow", "upsampled_flow"))


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))  # HWIO -> OIHW


def _tconv_weight(kernel: np.ndarray) -> np.ndarray:
    # flipped HWIO (kh, kw, in, out) -> torch (in, out, kh, kw), un-flipped
    return np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _leaves(tree: Mapping[str, Any], path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def from_jax_variables(variables: Mapping[str, Any],
                       model_name: str) -> dict[str, torch.Tensor]:
    """Flax ``{'params': ..., 'batch_stats': ...}`` (numpy leaves) of the
    JAX package's ``model_name`` -> the port's state_dict."""
    state: dict[str, torch.Tensor] = {}

    def put(path, kind, leaf, value):
        *prefix, module = path
        index = [] if _is_bare(module) else ["1" if kind == "bn" else "0"]
        key = ".".join([*prefix, module, *index, leaf])
        state[key] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))

    for path, value in _leaves(variables["params"]):
        *mod_path, kind, leaf = path
        value = np.asarray(value)
        if kind == "bn":
            put(mod_path, kind, _BN_PARAMS[leaf], value)
        elif leaf == "kernel":
            put(mod_path, kind, "weight", _tconv_weight(value)
                if kind == "tconv" else _conv_weight(value))
        elif leaf == "bias":
            put(mod_path, kind, "bias", value)
        else:
            raise KeyError(f"unhandled parameter {'/'.join(path)} "
                           f"of {model_name}")
    for path, value in _leaves(variables.get("batch_stats", {})):
        *mod_path, kind, leaf = path
        put(mod_path, kind, _BN_STATS[leaf], np.asarray(value))
    # torch's BatchNorm2d also keeps a step count, which Flax has not
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key.replace(".running_mean", ".num_batches_tracked")] = \
            torch.tensor(0)
    return state


def load_checkpoint(path: str | pathlib.Path,
                    model: torch.nn.Module) -> dict[str, Any]:
    """Load a reference ``.pth.tar`` (or a bare state_dict) into ``model``
    with ``strict=True``.  Returns ``{'arch', 'epoch', 'best_EPE'}`` where
    present."""
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        state_dict = blob["state_dict"]
        meta = {k: blob.get(k) for k in ("arch", "epoch", "best_EPE")}
    else:
        state_dict, meta = blob, {}
    model.load_state_dict(state_dict, strict=True)
    return meta
