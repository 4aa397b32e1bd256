#!/usr/bin/env python3
"""Where the time of a step through the Trainer goes, on one CUDA card.

    python3 trainer_ab.py

FlowNet2 with seeded weights, MultiScale, Adam 1e-4, batch 8 of 384x448
crops of 96 FlyingChairs-format pairs at 384x512 (24 drawn from a seeded
generator, replicated 4 times: 12 steps an epoch), cuDNN's defaults, TF32
off, in fp32 and in bf16.  ``Trainer.train_epoch`` is timed (host clock,
synchronised at both ends) over the same epoch fed three ways:

- ``device batches``: batches already on the card, no loader;
- ``staged``: the decoded host batches through ``device_prefetch`` (its
  thread's pinned staging and copies, no decoding);
- ``loader``: the ``DataLoader`` through ``device_prefetch``, decoding as
  it goes (the route ``native.available()`` gives);

beside the bare step loop over the device batches.  Each line prints
ms/step and the host's time between the returns of consecutive steps.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PAIRS, REPLICATES, HEIGHT, WIDTH = 24, 4, 384, 512
BATCH, CROP = 8, (384, 448)
REPEATS = 2


def main() -> int:
    if not torch.cuda.is_available():
        print("trainer_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from PIL import Image

    from flownet2_tpu_torch import native
    from flownet2_tpu_torch.data import (Batch, DataLoader, FlyingChairs,
                                         device_prefetch, write_flo)
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.train import (StepFactory, Trainer, TrainerConfig,
                                          get_optimizer)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    with tempfile.TemporaryDirectory() as work:
        rng = np.random.default_rng(0)
        for i in range(PAIRS):
            for j in (1, 2):
                Image.fromarray(rng.integers(0, 256, (HEIGHT, WIDTH, 3),
                                             dtype=np.uint8)).save(
                    Path(work) / f"{i:05d}_img{j}.ppm")
            write_flo(Path(work) / f"{i:05d}_flow.flo",
                      rng.standard_normal((HEIGHT, WIDTH, 2),
                                          dtype=np.float32) * 4)
        ds = FlyingChairs(root=work, is_cropped=True, crop_size=CROP,
                          replicates=REPLICATES)
        loader = DataLoader(ds, batch_size=BATCH, shuffle=True, seed=0)
        t0 = time.perf_counter()
        host = list(loader)
        print(f"loader alone ({'native' if native.available() else 'numpy'}"
              f" route): {len(host) / (time.perf_counter() - t0):.2f} "
              f"batches/s")
        on_card = [Batch(torch.from_numpy(b.images).cuda(),
                         torch.from_numpy(b.flow).cuda(), b.n_valid)
                   for b in host]

        for dtype in (torch.float32, torch.bfloat16):
            factory = StepFactory(
                get_model("FlowNet2", device="cuda", seed=0, dtype=dtype),
                MultiScale(), get_optimizer("Adam", 1e-4))
            trainer = Trainer(factory, TrainerConfig(save_dir=work))
            step = factory.train_step()
            for b in on_card[:3]:
                step(b.images, b.flow)
            stamps = []
            train_step = trainer._train_step

            def stamped(images, flow):
                out = train_step(images, flow)
                stamps.append(time.perf_counter())
                return out

            trainer._train_step = stamped
            feeds = (("device batches", lambda: list(on_card)),
                     ("staged", lambda: device_prefetch(host)),
                     ("loader", lambda: device_prefetch(loader)))
            for what, feed in feeds:
                for rep in range(REPEATS):
                    stamps.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_epoch(feed(), 0)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / len(stamps)
                    gaps = np.diff([t0] + stamps) * 1e3
                    print(f"{dtype} {what}, run {rep}: {ms:.3f} ms/step "
                          f"over {len(stamps)}; host ms between steps "
                          f"{' '.join(f'{g:.1f}' for g in gaps)}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in on_card:
                step(b.images, b.flow)
            torch.cuda.synchronize()
            print(f"{dtype} bare step loop: "
                  f"{(time.perf_counter() - t0) * 1e3 / len(on_card):.3f} "
                  "ms/step")
            del factory, trainer, step
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
