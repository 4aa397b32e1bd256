"""Checkpoints: weights into the port (reference ``.pth.tar``, released
``.caffemodel``, JAX variables) and native save/resume."""

from .caffe_import import load_caffe_checkpoint  # noqa: F401
from .native import restore_checkpoint, save_checkpoint  # noqa: F401
from .torch_import import from_jax_variables, load_checkpoint  # noqa: F401
