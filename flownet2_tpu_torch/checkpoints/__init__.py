"""Checkpoints: weights into the port (reference ``.pth.tar``, JAX
variables) and native save/resume."""

from .native import restore_checkpoint, save_checkpoint  # noqa: F401
from .torch_import import from_jax_variables, load_checkpoint  # noqa: F401
