#!/usr/bin/env python3
"""Time the FlowNet2 train step of one checkout on one CUDA card, in a
process that runs nothing else.

    python3 step_ab.py <checkout root> <tag>

The step of ``chip_smoke.py``'s phase 4: FlowNet2 with seeded weights,
``StepFactory.train_step()``, MultiScale, Adam 1e-4, batch 8 at 384x448,
fp32 with TF32 off, random images x255 and flow x5, the default warp
route.  Prints one line: the tag, ms/step over 10 steps after 2 warm-ups
by CUDA events, three blocks in turn, and the SM clock.  Phase 4 times the
step after phases 2-3b have run in the same process; this times it alone,
so that two checkouts compare on their code only.  Compare two commits in
turns in one call (parent, change, change, parent), each in its own
process, as ``kernel_ab.py``'s docstring sets out.
"""

from __future__ import annotations

import sys

import torch

from kernel_ab import sm_clock

BATCH, HEIGHT, WIDTH = 8, 384, 448
STEPS, WARMUP, BLOCKS = 10, 2, 3


def main(root: str, tag: str) -> int:
    if not torch.cuda.is_available():
        print("step_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand((BATCH, 2, HEIGHT, WIDTH, 3), generator=gen,
                        device=dev) * 255.0
    target = torch.rand((BATCH, HEIGHT, WIDTH, 2), generator=gen,
                        device=dev) * 5.0
    step = StepFactory(get_model("FlowNet2", device=dev, seed=0),
                       MultiScale(), get_optimizer("Adam", 1e-4)).train_step()
    times = []
    for _ in range(BLOCKS):
        for _ in range(WARMUP):
            step(images, target)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(STEPS):
            metrics = step(images, target)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / STEPS)
    if not all(torch.isfinite(metrics[k]) for k in ("loss", "epe")):
        raise AssertionError(f"non-finite loss or EPE: {metrics}")
    print(f"{tag} train step {', '.join(f'{t:.3f}' for t in times)} ms/step "
          f"| SM clock, max: {sm_clock()}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
