"""Run tooling: the port's copy of flownet2_tpu/utils/tools.py.

``TimerBlock`` (section timers), ``format_dictionary_of_losses`` (the
progress line's loss string), ``IteratorTimer`` (each batch's load time),
``MetricLogger`` (one JSON line a record) and ``progress`` are the JAX
package's, numpy- and stdlib-only; ``gpumemusage`` reads ``torch.cuda``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Iterable, Iterator, Mapping, Optional


class TimerBlock:
    """``with TimerBlock("Building model") as block: block.log(...)``."""

    def __init__(self, title: str):
        self.title = title
        self.lines = []

    def __enter__(self):
        print(f"{self.title}", flush=True)
        self.start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = time.monotonic()
        status = "failed" if exc_type else "finished"
        print(f"  [{self.end - self.start:.3f}s] {self.title} {status}",
              flush=True)
        return False

    def log(self, string: str):
        duration = time.monotonic() - self.start
        print(f"  [{duration:.3f}s] {string}", flush=True)
        self.lines.append((duration, string))

    def log2file(self, fid: str, string: str):
        with open(fid, "a") as f:
            f.write(f"{string}\n")


def format_dictionary_of_losses(labels: Iterable[str],
                                values: Iterable[float]) -> str:
    """'L1: 0.123, EPE: 0.456' progress-bar string."""
    try:
        return ", ".join(f"{name}: {value:.3f}"
                         for name, value in zip(labels, values, strict=True))
    except ValueError as e:
        raise ValueError(
            f"losses {list(values)} do not match labels {list(labels)}") from e


class IteratorTimer:
    """Wraps an iterator, exposing ``last_duration`` of each __next__:
    surfaces input-pipeline stalls as a 'load' metric."""

    def __init__(self, iterable):
        self.iterable = iterable
        self.iterator = iter(iterable)
        self.last_duration = 0.0

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.iterable)

    def __next__(self):
        start = time.monotonic()
        item = next(self.iterator)
        self.last_duration = time.monotonic() - start
        return item


class MetricLogger:
    """JSONL metrics + simple console progress.

    One record per call: {"step": int, "split": str, **scalars}.
    """

    def __init__(self, directory: Optional[str], run_name: str = "run"):
        self.path = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(directory, f"{run_name}.metrics.jsonl")

    def log(self, step: int, split: str, scalars: Mapping[str, float]):
        rec = {"step": int(step), "split": split, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


def progress(iterator, total: Optional[int] = None, desc: str = "",
             every: int = 10) -> Iterator:
    """tqdm-free progress printing (plain lines survive logs and several
    ranks better than stacked bars)."""
    start = time.monotonic()
    for i, item in enumerate(iterator):
        yield item
        if every and (i + 1) % every == 0:
            rate = (i + 1) / (time.monotonic() - start)
            tot = f"/{total}" if total else ""
            print(f"  {desc} {i + 1}{tot} [{rate:.2f} it/s]",
                  file=sys.stderr, flush=True)


def gpumemusage() -> str:
    """Device memory in use against the card's total, through
    ``torch.cuda`` ("n/a" without a CUDA device)."""
    import torch

    if not torch.cuda.is_available():
        return "n/a"
    used = torch.cuda.memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory / 2**30
    return f"{used:.2f}/{total:.2f} GiB"
