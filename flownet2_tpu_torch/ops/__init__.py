"""The FlowNet2 ops, NCHW, forward only.  Correlation and the bilinear warp
each have a plain PyTorch version (taken for CPU tensors) and a CUDA kernel
(taken for CUDA tensors).  Import the ops from their modules
(``ops.correlation``, ``ops.resample2d``, ...); the package re-exports only
the launch and plain-call counters."""

from ._cuda import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: F401
