"""The FlowNet2 ops, NCHW, with their gradients.  Correlation and the
bilinear warp, forward and backward, each have plain PyTorch versions
(taken for CPU tensors) and CUDA kernels (taken for CUDA tensors).  Import the ops from their modules
(``ops.correlation``, ``ops.resample2d``, ...); the package re-exports only
the launch and plain-call counters."""

from ._cuda import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: F401
