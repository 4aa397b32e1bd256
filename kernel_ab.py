#!/usr/bin/env python3
"""Time the port's whole-map kernels of one checkout on one CUDA card.

    python3 kernel_ab.py <checkout root> <tag>

Builds the kernels of ``<root>/flownet2_tpu_torch`` and prints one line:
the tag, the milliseconds per launch of K1 at (8, 256, 48, 64), of K5 and K6
at (8, 256, 48, 56) and of the two-flow K2 at (8, 3, 384, 512), float32,
CUDA events over 300 launches after 20, and ptxas's register counts (none
for libraries an earlier run in that checkout has built).

Two commits are compared on one card in one call, in turns, since two calls
may land on two cards: unpack the parent with ``git archive <commit>
flownet2_tpu_torch | tar -x -C build/parent`` and run

    python3 kernel_ab.py build/parent parent; python3 kernel_ab.py . change
    python3 kernel_ab.py . change; python3 kernel_ab.py build/parent parent
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"""

from __future__ import annotations

import sys

import torch


def time_ms(fn, iters: int = 300, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(root: str, tag: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import resample2d as r2d

    logs = _cuda.build()
    registers = [line.split("Used ")[1].split(",")[0]
                 for name in sorted(logs) for line in logs[name].splitlines()
                 if "registers" in line]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    f1, f2 = randn(8, 256, 48, 64), randn(8, 256, 48, 64)
    tf1, tf2 = randn(8, 256, 48, 56), randn(8, 256, 48, 56)
    tg = randn(8, 441, 48, 56)
    img = randn(8, 3, 384, 512)
    flows = randn(8, 2, 2, 384, 512) * 4.0
    times = {
        "K1": time_ms(lambda: corr.correlation_cuda(f1, f2)),
        "K5": time_ms(lambda: corr.correlation_bwd_cuda(
            tg, tf1, tf2, needs=(True, False))),
        "K6": time_ms(lambda: corr.correlation_bwd_cuda(
            tg, tf1, tf2, needs=(False, True))),
        "K2, two flows": time_ms(lambda: r2d.resample2d_multi_cuda(img,
                                                                   flows)),
    }
    print(tag, "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
          "| registers:", ", ".join(registers))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
