"""flownet2_tpu_torch: FlowNet2 inference in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``flownet2_tpu``'s module names (``ops``, ``nn``,
``models``, ``checkpoints``, ``data``) so each counterpart is easy to find,
but it imports neither JAX nor anything of ``flownet2_tpu``: the numpy
helpers it shares with that package are copies.

Activations are NCHW and weights OIHW inside; the model's public ``forward``
keeps the JAX package's layout (frame pairs ``(B, 2, H, W, 3)`` in, flow
``(B, H, W, 2)`` out).  Entry points run on the CUDA device unless the
caller names another one (``device="cpu"``); on the CPU every op takes its
plain PyTorch version.
"""

from .utils.device import resolve_device  # noqa: F401
