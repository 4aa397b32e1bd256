"""The FlowNet2 ops, NCHW, with their gradients.  Correlation and the
warp, forward and backward, each have plain PyTorch versions (taken for CPU
tensors) and CUDA kernels (taken for CUDA tensors).  Import the ops from
their modules (``ops.correlation``, ``ops.resample2d``, ...).  The package
re-exports the launch and plain-call counters and, as the JAX package's
``ops`` does, the reference's op surface: ``Correlation``, ``Resample2d``
and ``ChannelNorm`` (modules without parameters) and ``upsample(x, scale,
mode)``, which is the module ``ops.upsample`` itself, callable."""

from . import upsample  # noqa: F401
from ._cuda import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: F401
from .channelnorm import ChannelNorm  # noqa: F401
from .correlation import Correlation  # noqa: F401
from .resample2d import Resample2d  # noqa: F401
