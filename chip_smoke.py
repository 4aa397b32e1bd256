#!/usr/bin/env python3
"""Smoke run of flownet2_tpu_torch on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases (any failure raises and the script exits non-zero):

1. Card: print nvidia-smi's name and power limit; build the CUDA kernels
   from flownet2_tpu_torch/csrc and print the build time.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   FlowNet2 b8 384x512 gives them, TF32 off: the correlation (K1) at
   (8, 256, 48, 64), at the wide (4, 256, 48, 128) and at a ragged
   (2, 40, 20, 152), atol/rtol 1e-4; the warp (K2) for one flow of +-8 px
   and of +-200 px and for two flows over one (8, 3, 384, 512) image, and
   for one flow at a ragged (2, 3, 100, 150), atol/rtol 1e-5.
3. FlowNet2 inference, seeded random weights, b8 384x512 fp32: warm-up,
   then 10 timed batches with CUDA events, with the launch counters set to
   0 just before and read just after (1 K1 and 3 K2 launches per forward,
   no plain-op call).  The output must be finite, (8, 384, 512, 2), agree
   with the same model run with the plain ops on the card, and agree on a
   small pair with the model run on the CPU, at rtol/atol 1e-3.
4. Each kernel's time, its plain version's time, the card's bound for the
   same work and, for K2, F.grid_sample's time, at the main-path shapes.
5. Where FlowNet2's device time goes: the phase 3 model and pair, 5
   forwards under torch.profiler, the device time summed by kernel family
   (convolutions, K1, K2, the other PyTorch kernels) and the device's idle
   share of the profiled window.  Raises if no device time is recorded.
6. One JSON line listing the kernels; the last line is the result.

Uses one card, the first the environment lists.  Exits non-zero, printing
no result, where no CUDA device is available or the package is not beside
this script.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

# one card: the first one the environment lists (before torch sees CUDA)
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = Path(__file__).resolve().parent

# Kernel families of the phase 5 profile, by kernel name; the first match
# wins.  cuDNN's kernels include its FFT algorithm's transforms and
# pointwise complex products.
FAMILIES = (
    ("correlation_fwd (K1)", re.compile(r"correlation_fwd")),
    ("resample2d_fwd (K2)", re.compile(r"resample2d_fwd")),
    ("convolution", re.compile(r"conv|cudnn|gemm|xmma|sm90|sm80|implicit|"
                               r"wgrad|dgrad|fprop|winograd|fft|complex",
                               re.I)),
    ("other PyTorch kernels", re.compile(r".")),
)
PROFILED_FORWARDS = 5

# Published peaks: (memory bytes/s, float32 FLOP/s outside the tensor
# cores), from NVIDIA's data sheets; the first name that the card's name
# contains is taken.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}

DEVICE = "cuda"
BATCH, HEIGHT, WIDTH = 8, 384, 512
TIMED_BATCHES = 10


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def bound_ms(nbytes: float, flops: float, peaks):
    bw, f32 = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
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


def max_err(got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float, what: str) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol,
                                                     atol=atol):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs diff {err:.3e})")
    print(f"  {what}: max abs diff {err:.3e} (rtol/atol {rtol:g}/{atol:g})")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "flownet2_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from flownet2_tpu_torch import ops
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import resample2d as r2d

    # -- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(kind)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"peaks taken for {peak_name}: {peaks[0] / 1e12:g} TB/s, "
          f"{peaks[1] / 1e12:g} TFLOP/s f32")
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 2. kernels against their plain versions ----------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    corr_args = (20, 1, 20, 1, 2)
    print("phase 2: kernels against their plain versions")
    with torch.inference_mode():
        errs = {}
        # the main path's shape, the wide (384x1024 frames) one, and a
        # ragged one: a partial channel chunk and a partial column tile
        for shape in ((BATCH, 256, HEIGHT // 8, WIDTH // 8), (4, 256, 48, 128),
                      (2, 40, 20, 152)):
            f1, f2 = randn(*shape), randn(*shape)
            errs.setdefault("correlation_fwd", []).append(max_err(
                corr.correlation_cuda(f1, f2, *corr_args),
                corr.correlation_plain(f1, f2, *corr_args), 1e-4, 1e-4,
                f"K1 correlation {shape}"))
        img = randn(BATCH, 3, HEIGHT, WIDTH)
        flow8 = uniform(BATCH, 2, HEIGHT, WIDTH, scale=8.0)
        flow200 = uniform(BATCH, 2, HEIGHT, WIDTH, scale=200.0)
        for px, flow in ((8, flow8), (200, flow200)):
            errs.setdefault("resample2d_fwd", []).append(max_err(
                r2d.resample2d_cuda(img, flow), r2d.resample2d_plain(img, flow),
                1e-5, 1e-5, f"K2 warp, one flow of +-{px} px"))
        ragged_img = randn(2, 3, 100, 150)
        ragged_flow = uniform(2, 2, 100, 150, scale=8.0)
        errs["resample2d_fwd"].append(max_err(
            r2d.resample2d_cuda(ragged_img, ragged_flow),
            r2d.resample2d_plain(ragged_img, ragged_flow), 1e-5, 1e-5,
            "K2 warp, one flow, (2, 3, 100, 150)"))
        flows = torch.stack([flow8, flow200], dim=1)
        errs["resample2d_fwd_multi"] = [max_err(
            r2d.resample2d_multi_cuda(img, flows),
            r2d.resample2d_multi_plain(img, flows), 1e-5, 1e-5,
            "K2 warp, two flows")]

    # -- 3. FlowNet2 inference ----------------------------------------------
    print(f"phase 3: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} fp32, TF32 off")
    model = get_model("FlowNet2", device=DEVICE, seed=0)
    pairs = [torch.rand((BATCH, 2, HEIGHT, WIDTH, 3), generator=gen,
                        device=dev) * 255.0 for _ in range(2)]
    with torch.inference_mode():
        for pair in pairs:
            model(pair)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.reset_counts()
        start.record()
        for i in range(TIMED_BATCHES):
            flow = model(pairs[i % 2])
        end.record()
        torch.cuda.synchronize()
        launches, plain_calls = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        ms = start.elapsed_time(end) / TIMED_BATCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"correlation_fwd": TIMED_BATCHES,
                "resample2d_fwd": 2 * TIMED_BATCHES,
                "resample2d_fwd_multi": TIMED_BATCHES}
        print(f"  launches over {TIMED_BATCHES} forwards: {launches}; "
              f"plain-op calls: {plain_calls}")
        if launches != want or plain_calls:
            raise AssertionError(f"main path launches {launches} / plain "
                                 f"calls {plain_calls}; expected {want} / {{}}")
        if flow.shape != (BATCH, HEIGHT, WIDTH, 2) \
                or not torch.isfinite(flow).all():
            raise AssertionError(f"bad flow: {tuple(flow.shape)}, finite="
                                 f"{torch.isfinite(flow).all().item()}")
        print(f"  {ms:.3f} ms/batch, {BATCH / ms * 1e3:.2f} frames/s, peak "
              f"{peak_gib:.2f} GiB allocated  [{smi}]")

        flow = model(pairs[0])
        with mock.patch.object(corr, "correlation_cuda",
                               corr.correlation_plain), \
                mock.patch.object(r2d, "resample2d_cuda",
                                  r2d.resample2d_plain), \
                mock.patch.object(r2d, "resample2d_multi_cuda",
                                  r2d.resample2d_multi_plain):
            flow_plain = model(pairs[0])
            plain_model_ms = time_ms(lambda: model(pairs[0]), 3, warmup=0)
        err = (flow - flow_plain).abs().max().item()
        print(f"  against the plain-op model on the card: max abs diff "
              f"{err:.3e}, |flow| max {flow.abs().max().item():.3f}; "
              f"plain-op model {plain_model_ms:.3f} ms/batch")
        if not torch.allclose(flow, flow_plain, rtol=1e-3, atol=1e-3):
            raise AssertionError("kernel model disagrees with plain-op model")

        small = pairs[0][:1, :, :64, :128].contiguous()
        on_card = model(small).cpu()
        on_cpu = get_model("FlowNet2", device="cpu", seed=0)(small.cpu())
        err_cpu = (on_card - on_cpu).abs().max().item()
        print(f"  small pair against the model on the CPU: max abs diff "
              f"{err_cpu:.3e}")
        if not torch.allclose(on_card, on_cpu, rtol=1e-3, atol=1e-3):
            raise AssertionError("card and CPU disagree on the small pair")

    # -- 4. kernel times ------------------------------------------------------
    print("phase 4: kernel times at the main-path shapes")
    rows = []
    with torch.inference_mode():
        b, c, h, w = BATCH, 256, HEIGHT // 8, WIDTH // 8
        f1, f2 = randn(b, c, h, w), randn(b, c, h, w)
        disp = 21
        k1_bytes = 4 * (2 * b * c * h * w + b * disp * disp * h * w)
        k1_flops = 2 * b * disp * disp * h * w * c
        rows.append(("correlation_fwd", "correlation_pallas.py:83",
                     "correlation_fwd.cu",
                     lambda: corr.correlation_cuda(f1, f2, *corr_args),
                     lambda: corr.correlation_plain(f1, f2, *corr_args),
                     None, k1_bytes, k1_flops))

        b, h, w, ch = BATCH, HEIGHT, WIDTH, 3
        xs = torch.arange(w, device=dev).view(1, 1, -1)
        ys = torch.arange(h, device=dev).view(1, -1, 1)

        def grid_of(fl):
            gx = (xs + fl[:, 0]) * (2.0 / (w - 1)) - 1.0
            gy = (ys + fl[:, 1]) * (2.0 / (h - 1)) - 1.0
            return torch.stack([gx, gy], dim=-1)

        grid1 = grid_of(flow8)
        grid2 = torch.cat([grid_of(flow8), grid_of(flow200)], dim=0)
        img2 = img.unsqueeze(1).expand(b, 2, ch, h, w).reshape(2 * b, ch, h, w)
        # per output pixel ~10 flops of coordinates and weights, then 7 per
        # channel (4 multiplies, 3 adds)
        for name, nflows, fn, plain, lib, grid in (
                ("resample2d_fwd", 1,
                 lambda: r2d.resample2d_cuda(img, flow8),
                 lambda: r2d.resample2d_plain(img, flow8), img, grid1),
                ("resample2d_fwd_multi", 2,
                 lambda: r2d.resample2d_multi_cuda(img, flows),
                 lambda: r2d.resample2d_multi_plain(img, flows), img2, grid2)):
            nbytes = 4 * b * h * w * (ch + nflows * (2 + ch))
            flops = b * nflows * h * w * (10 + 7 * ch)
            rows.append((name, "resample2d_pallas.py:239", "resample2d_fwd.cu",
                         fn, plain,
                         (lambda lib=lib, grid=grid: F.grid_sample(
                             lib, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)),
                         nbytes, flops))

        kernels = []
        for name, replaces, src, fn, plain, lib, nbytes, flops in rows:
            k_ms = time_ms(fn, 50)
            p_ms = time_ms(plain, 5)
            l_ms = time_ms(lib, 50) if lib is not None else None
            b_ms, b_by = bound_ms(nbytes, flops, peaks)
            print(f"  {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                  f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
                  f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.3f} GFLOP)  [{smi}]")
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"flownet2_tpu_torch/csrc/{src}",
                "replaces": f"flownet2_tpu/ops/{replaces}",
                "launches": launches[name], "max_abs_err": max(errs[name]),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms})

    # -- 5. where the device time goes --------------------------------------
    print(f"phase 5: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} fp32, "
          f"{PROFILED_FORWARDS} forwards under torch.profiler")
    with torch.inference_mode():
        model(pairs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_FORWARDS):
                model(pairs[0])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: their self device time is the kernel's own time
    per_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us
    busy_ms = sum(per_kernel.values()) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    families = {name: 0.0 for name, _ in FAMILIES}
    for key, us in per_kernel.items():
        families[next(n for n, rx in FAMILIES if rx.search(key))] += us / 1e3
    n = PROFILED_FORWARDS
    print(f"  wall {wall_ms / n:.3f} ms/batch, device busy {busy_ms / n:.3f} "
          f"ms/batch, idle share {1 - busy_ms / wall_ms:.4f}  [{smi}]")
    for name, fam_ms in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {fam_ms / n:9.3f} ms/batch  "
              f"{fam_ms / busy_ms:7.2%}")
    print("  top kernels:")
    for key, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3 / n:9.3f} ms/batch  {key[:100]}")

    # -- 6. result ------------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
