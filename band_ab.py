#!/usr/bin/env python3
"""Host-side variants of the row-band step across cards, timed in one call.

    python3 band_ab.py        # on a machine with two cards or more

Runs chip_smoke.py's rank task ``bands`` (FlowNet2 fp32, the global batch
of 8 at 384x448 as two row bands on two cards over NCCL: 10 steps after 2,
cuDNN's defaults, the slowest rank's ms/step, then rank 0's device time by
kernel family and its host time by op) once for each variant, in turns:

- as is;
- no flight recorder: ``TORCH_FR_BUFFER_SIZE=0`` and the older
  ``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` in the ranks' environment, so that
  NCCL's collectives are not recorded;
- all_gather_into_tensor: the halo and gather all-gathers into one tensor
  in place of a list of tensors.

The band step issues some 250 collectives a step (a halo exchange each way
for every convolution); these variants show what each collective's host
cost is made of.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

RANK = sys.argv[1:2] == ["--rank-task"]
if not RANK:
    # chip_smoke keeps every card visible for --data-parallel
    sys.argv = [sys.argv[0], "--data-parallel"]
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402

VARIANTS = (
    ("as is", {}),
    ("no flight recorder", {"TORCH_FR_BUFFER_SIZE": "0",
                            "TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}),
    ("all_gather_into_tensor", {"BAND_AB_INTO_TENSOR": "1"}),
    ("as is", {}),
)


def gather_into_tensor() -> None:
    """Make the ranks' all-gathers over NCCL one all_gather_into_tensor."""
    from flownet2_tpu_torch.parallel import halo

    plain = halo.all_gather_list

    def gather(t, n, index, group):
        t = t.contiguous()
        if t.is_cuda and dist.get_backend(group) == "nccl":
            out = t.new_empty((n,) + tuple(t.shape))
            dist.all_gather_into_tensor(out, t, group=group)
            return list(out.unbind(0))
        return plain(t, n, index, group)
    halo.all_gather_list = gather


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("band_ab: needs two cards", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}", flush=True)
    chip_smoke.RANK_COMMAND = [str(Path(__file__).resolve()), "--rank-task"]
    work = Path(tempfile.mkdtemp(prefix="band_ab_"))
    for what, extra in VARIANTS:
        out = work / "out.json"
        chip_smoke.run_task(
            work, "band_ab", 2, env=dict(os.environ, **extra), task="bands",
            backend="nccl", spatial=2, part="band_ab", what=what,
            check=False, timed=True, out=str(out), smi=smi)
        got = json.loads(out.read_text())
        print(f"{what}: {got['ms']:.3f} ms/step; device time a step "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
                  got["families_ms"].items(), key=lambda kv: -kv[1]))
              + f"  [{smi}]", flush=True)
        for line in got["profile"]:
            print(f"    {line}", flush=True)
    return 0


if __name__ == "__main__":
    if RANK:
        if os.environ.get("BAND_AB_INTO_TENSOR"):
            gather_into_tensor()
        sys.exit(chip_smoke.rank_task(sys.argv[2]))
    sys.exit(main())
