#!/usr/bin/env python3
"""Smoke run of flownet2_tpu_torch on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases (any failure raises and the script exits non-zero):

1. Card: print nvidia-smi's name and power limit; build the CUDA kernels
   from flownet2_tpu_torch/csrc and print the build time and ptxas's
   register and spill lines under each kernel's (mangled) name.
2. Kernels against their plain PyTorch versions on the card, TF32 off: the
   correlation (K1) and its gradient (K5 d_f1, K6 d_f2) at
   (8, 256, 48, 64), at the wide (4, 256, 48, 128), at a ragged
   (2, 40, 20, 152) and at an odd-width ragged (2, 40, 20, 75), atol/rtol
   1e-4 (K5/K6 also at the training shape (8, 256, 48, 56)); K1, K5 and K6
   at two configurations the register-tiled bodies of K1 and K5 do not
   cover (maxd 8, s2 1 and maxd 4, s2 2, at (2, 40, 20, 75)), which their
   general bodies run, 1e-4; the
   warp (K2) for one flow of +-8 px and of +-200 px
   and for two flows over one (8, 3, 384, 512) image, and the warp with
   tangents (K3, one and two flows) and its flow gradient (K4) over one
   (8, 3, 384, 448) image at +-8 px and +-200 px, each also at a ragged
   (2, 3, 100, 150), atol/rtol 1e-5; K4 also against the tangent route's
   flow gradient on the same inputs.  The row-slab correlation (K7:
   forward, d_f1, d_slab) on the top, a middle and the bottom band of 2 and
   of 4 bands of the main-path, the wide and the two ragged maps, atol/rtol
   1e-5 against its plain version, the forward and d_f1 also bit for bit
   against the same rows of K1 and K5, and the bands' d_slab summed
   against K6 at 1e-5.  The local-rows forms of K2, K3 and K4 (one and two
   flows, +-8 px and +-200 px) on the bands of 2 and of 4: bit-equal to
   the same rows of the whole-image kernels' output.  The bf16 forms:
   K1 at the main-path, the wide and the two ragged maps and at
   (2, 40, 3, 64) and (2, 40, 5, 75) (its tensor-core body; the flip rate
   is printed), and at maxd 8, s2 1 and maxd 4, s2 2 (its general body),
   K2 for one flow
   of +-8 px and of +-200 px and for two flows over the (8, 3, 384, 512)
   image and the ragged (2, 3, 100, 150) one, K5 and K6 at the training,
   the main-path, the wide and the two ragged maps, at (2, 40, 20, 150)
   (4-byte copies) and at (2, 40, 3, 64) and (2, 40, 5, 75) (their
   tensor-core bodies; their flip rates are printed), and at maxd 8, s2 1
   and maxd 4, s2 2 (their general bodies), K3 (out)
   and K4 on K3's and K4's f32 cases, each element
   within one bf16 ulp (rtol 2^-7, atol 1e-6 of the largest |out|) of the
   plain version and at most 1% of them not bit-equal; K3's float32 d1 and
   d2 at 1e-5; K4 bf16 also at one ulp of the tangent route's bf16 flow
   gradient.  The bf16 row bands: K7 bf16 (forward, d_f1, d_slab) on the
   bands of 1, 2 and 4 of the maps of K7's f32 checks and of a
   (2, 40, 5, 64) map (bands of one row, whose slabs are all halo but that
   row), every band's forward
   and d_f1 bit for bit the same rows of K1 bf16 and K5 bf16, one band's
   d_slab rows [20, 20 + H) K6 bf16's (the flip rates of the d_f1 bands
   printed), the top, a middle and the bottom
   band at one ulp of the plain version; the bf16 local-rows K2, K3 (out;
   d1, d2 float32) and K4, one and two flows at +-8 px and +-200 px, on
   the bands of 2 and of 4 (the second band of two of a 384-row image
   starts at row 192, where a bf16 ulp is 1 px), bit-equal to the same rows
   of the whole-image bf16 kernels.  The row tiles of K2, K3 and K4 (one
   and two flows, f32 and bf16) at the smooth flow the stage glue makes
   (+-8 px at (H/4, W/4), bilinear x4) at K2's and K4's shapes, and in one
   launch whose blocks take both routes (half the batch at +-8 px, whose
   windows are staged in shared memory, half at +-200 px, gathered from
   global memory), at phase 2's tolerances; K3 and K4 (two flows, f32 and
   bf16) at (2, 3, 100, 136), where a bf16 K3 thread pair straddles the
   row's end, likewise.
3. FlowNet2 inference, seeded random weights, b8 384x512 fp32: warm-up,
   then 10 timed batches with CUDA events, with the launch counters set to
   0 just before and read just after (1 K1 and 3 K2 launches per forward,
   no plain-op call).  The output must be finite, (8, 384, 512, 2), agree
   with the same model run with the plain ops on the card, and agree on a
   small pair with the model run on the CPU, at rtol/atol 1e-3.
3b. FlowNet2 bf16 inference (``get_model(..., dtype=torch.bfloat16)``), the
   same weights and pairs: 10 timed batches counted as in phase 3 (1
   correlation_fwd_bf16, 2 resample2d_fwd_bf16 and 1
   resample2d_fwd_multi_bf16 launch per forward, nothing else, no plain-op
   call); the output finite, (8, 384, 512, 2) and bf16, and within the JAX
   package's bf16 contract (mean |d| < 0.05 (mean |ref| + 1e-3) + 5e-3) of
   the plain-op bf16 model on the card, of the fp32 model and, on the small
   pair, of the bf16 model on the CPU; under two row bands, with cuDNN
   deterministic, within the same contract of the whole-map output (printed:
   whether bit-equal).  Printed beside: the host's time to enqueue a
   forward, the model against itself with cuDNN's default algorithms, and
   against the plain-op model with deterministic ones.  The bf16 model is
   then freed (phase 7 builds it again), so that phase 4 runs beside the
   one fp32 model, as it did before.
4. FlowNet2 training through StepFactory, b8 384x448 fp32, MultiScale,
   Adam 1e-4, seeded weights, random images x255 and flow x5: the first
   step's loss and every parameter's gradient against the plain-op model
   on the card (loss at rtol 1e-4, each gradient within 1e-3 of its
   tensor's largest |g| with the forward shared, all gradients within 1e-3
   in relative L2 otherwise), and a (1, 2, 64, 128, 3) step against the CPU
   (loss at 1e-4, gradients at 1e-3 in relative L2); then 2 warm-up and 10
   timed steps per warp route, in turns (K2 + K4, tangents, tangents,
   K2 + K4), the counters
   set to 0 just before each route's first block and read after it (per
   step: 1 K1, 1 K5, 1 K6 and, on the default K2 + K4 route, 2 one-flow
   and 1 two-flow K2 and K4 and no K3, on the tangent route 2 one-flow and
   1 two-flow K3 and no K2 or K4; no plain-op call).  Loss and EPE must be
   finite.  Before the timed steps, on each warp route with cuDNN
   deterministic: two backward passes over one shared forward give the
   same bits in every sub-net, and one step under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` names no op
   as nondeterministic (torch's Python warnings and its C++ log on the
   standard error; the capture first shown to name torch.histc's op);
   the same two readings with torch's own bilinear upsample backward in
   place of the port's are printed beside, and its two backward passes
   must differ in flownetc, or the check of the port's is not shown to
   see what it checks for.  The small step against the CPU is also read,
   not gated, on three more draws.
4b. FlowNet2 bf16 training (``get_model(..., dtype=torch.bfloat16)``:
   float32 master weights, bf16 convolutions, glue and warps, the loss and
   Adam in float32), phase 4's weights and batch: with cuDNN deterministic
   and the forward shared, the backward kernels against the plain backward
   on both warp routes (loss bit-equal, each sub-net's gradients within
   5e-2 in relative L2, the worst tensor printed) and the routes against
   each other; the kernel model against the plain-op bf16 model (loss and
   EPE at 5e-3 relative; flownets_2, flownets_d and flownetfusion at 5e-2,
   flownetc and flownets_1 printed: two bf16 forwards put them on the
   noise line); a (1, 2, 64, 128, 3) step against the bf16 model on the
   CPU at the same gates; every gradient float32 and finite.  Then 2
   warm-up and 10 timed steps per route, in turns, counted as in phase 4
   (per step 1 correlation_fwd_bf16, 1 correlation_bwd_f1_bf16, 1
   correlation_bwd_f2_bf16 and, on the default route, 2 one-flow and 1
   two-flow resample2d_fwd_bf16 and resample2d_grad_flow_bf16, on the
   tangent route 2 one-flow and 1 two-flow resample2d_tangents_bf16; no
   f32 kernel, no plain-op call), after phase 4's determinism checks on
   the bf16 model.  The bf16 model is then freed, so that phase 5 runs as
   it did before.
5. The row-band path: with ``set_spatial_shards(2)`` the correlation runs
   as two bands against halo slabs on K7 and every warp as two bands on
   the local-rows K2, K3 and K4, all on this card in turn.  The phase 3
   model and pair: the output within 1e-5 of the whole-map model's with
   cuDNN made deterministic (printed: whether bit-equal, and how far the
   whole-map model is from itself with cuDNN's default algorithms), then 10
   timed batches with the counters set to 0 just before and read just after
   (per forward 2 K7 forward, no K1, 4 one-flow and 2 two-flow K2; no
   plain-op call); the dispatch log names the halo-slab and halo-gather
   compositions.  The phase 4 model and batch: one step's loss within 1e-4
   and all gradients within 1e-3 in relative L2 of the whole-map step's,
   then 2 warm-up and 10 timed steps, counted likewise (per step 2 of each
   K7 entry point, no K1, K5 or K6, twice phase 4's warp launches).
   FlowNet2C, seeded weights, b8 384x512: 10 timed whole-map forwards (1 K1
   each), and one MultiScale train step under two bands whose loss and EPE
   are finite and within 1e-4 of the plain-op model's.
5b. The row-band path in bf16: the bf16 model of the same weights, built
   again and freed after.  Inference b8 384x512, 10 timed batches under two
   bands and over the whole map in turns (whole, bands, bands, whole), the
   band runs counted (per forward 2 correlation_fwd_rows_bf16, 4
   resample2d_fwd_bf16, 2 resample2d_fwd_multi_bf16; no plain-op call).
   One train step b8 384x448 under two bands against the whole map, cuDNN
   deterministic: loss and EPE within 5e-3 relative, each sub-net's
   gradients within 5e-2 in relative L2 (flownetc and flownets_1 printed
   only), every gradient float32 and finite, the launches counted (2 of
   each K7 bf16 entry point, twice phase 4b's warp launches).  Then 2
   warm-up and 10 timed steps per warp route, in turns, over the whole map
   and then under two bands, each counted (the tangent route's K3 bf16 in
   place of K2 and K4).
6. Each kernel's time, its plain version's time, the card's bound for the
   same work and, where one PyTorch call computes the same function, that
   call's time, at the main-path shapes (K7 at one band of two; the bf16
   forms of K1, K2 at the bf16 forward's shapes and of K3, K4, K5, K6 at
   the bf16 step's, their operations at the bf16 tensor-core rate and,
   for the warps, whose bodies upcast and sum in f32, also at the f32
   rate; K7 bf16 at one band of two of the bf16 forward's and step's maps,
   likewise), each beside
   the SM clock, the two-flow K4 (+-8 px and +-200 px at (8, 3, 384, 448))
   among them, and K3's four forms with their share of the bound beside
   their times before the row tiles; K2, K3 and K4, one and two flows, f32
   and bf16, at the smooth flow beside their times at the noise flows;
   then the one-flow K2 and K4 and their library calls with a cold L2
   cache (six input sets of 31-44 MB taken in turn).
7. Where the device time goes: the phase 3 model and pair, 5 forwards, the
   phase 3b bf16 model, 5 forwards, and the phase 4 train step, 3 steps,
   under torch.profiler, the device time summed by kernel family and the
   device's idle share of the profiled window; the fp32 forward's
   convolution kernels by name, marked where one forward with
   cudnn.deterministic does not run them; the bf16 forward's convolution
   and NCHW<->NHWC layout-conversion kernels by name with their launches;
   then the phase 4b bf16 train step, 3 steps, by family (convolution
   forward, dgrad and wgrad, layout conversions, copies and casts, the
   port's kernels, Adam) with its layout-conversion launches a step; the
   fp32 and the bf16 step on the tangent route, 3 steps each, for K3's
   device time a step.  Raises if no device time is recorded.
8. The readings of phases 3 to 7 again, one JSON line listing the kernels;
   the last line is the result.

Uses one card, the first the environment lists.  Exits non-zero, printing
no result, where no CUDA device is available or the package is not beside
this script.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

# one card: the first one the environment lists (before torch sees CUDA)
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = Path(__file__).resolve().parent

# Kernel families of the phase 6 profiles, by kernel name; the first match
# wins.  cuDNN's kernels include its FFT algorithm's transforms and
# pointwise complex products.
CONV = re.compile(r"conv|cudnn|gemm|xmma|sm90|sm80|implicit|wgrad|dgrad|"
                  r"fprop|winograd|fft|complex", re.I)
FAMILIES = (
    ("correlation_fwd (K1)", re.compile(r"correlation_fwd")),
    ("resample2d_fwd (K2)", re.compile(r"resample2d_fwd")),
    ("convolution", CONV),
    ("other PyTorch kernels", re.compile(r".")),
)
# The bf16 forward's families: cuDNN's NCHW <-> NHWC layout conversions
# (its bf16 kernels are NHWC; a channels_last model would not run them;
# tensorTransformGeneric is its generic layout transform) and the copies,
# the dtype casts of the parameters at each call among them, apart from
# the rest.
BF16_FAMILIES = (
    ("correlation_fwd (K1 bf16)", re.compile(r"correlation_fwd")),
    ("resample2d_fwd (K2 bf16)", re.compile(r"resample2d_fwd")),
    ("layout conversions NCHW<->NHWC",
     re.compile(r"nchwToNhwc|nhwcToNchw|tensorTransform", re.I)),
    ("convolution", CONV),
    ("copies and dtype casts", re.compile(r"copy", re.I)),
    ("other PyTorch kernels", re.compile(r".")),
)
# The bf16 train step's families: the train families with the bf16
# forward's layout conversions and casts apart.
BF16_TRAIN_FAMILIES = (
    ("correlation_fwd (K1 bf16)", re.compile(r"correlation_fwd")),
    ("correlation_bwd_f1 (K5 bf16)", re.compile(r"correlation_bwd_f1")),
    ("correlation_bwd_f2 (K6 bf16)", re.compile(r"correlation_bwd_f2")),
    ("resample2d_fwd (K2 bf16)", re.compile(r"resample2d_fwd")),
    ("resample2d_tangents (K3 bf16)", re.compile(r"resample2d_tangents")),
    ("resample2d_grad_flow (K4 bf16)", re.compile(r"resample2d_grad_flow")),
    ("optimizer (Adam)", re.compile(r"multi_tensor_apply|adam", re.I)),
    ("layout conversions NCHW<->NHWC",
     re.compile(r"nchwToNhwc|nhwcToNchw|tensorTransform", re.I)),
    ("convolution wgrad", re.compile(r"wgrad", re.I)),
    ("convolution dgrad", re.compile(r"dgrad", re.I)),
    ("convolution forward and other cuDNN", CONV),
    ("copies and dtype casts", re.compile(r"copy", re.I)),
    ("other PyTorch kernels", re.compile(r".")),
)
TRAIN_FAMILIES = (
    ("correlation_fwd (K1)", re.compile(r"correlation_fwd")),
    ("correlation_bwd (K5, K6)", re.compile(r"correlation_bwd")),
    ("resample2d_fwd (K2)", re.compile(r"resample2d_fwd")),
    ("resample2d_tangents (K3)", re.compile(r"resample2d_tangents")),
    ("resample2d_grad_flow (K4)", re.compile(r"resample2d_grad_flow")),
    ("optimizer (Adam)", re.compile(r"multi_tensor_apply|adam", re.I)),
    ("convolution wgrad", re.compile(r"wgrad", re.I)),
    ("convolution dgrad", re.compile(r"dgrad", re.I)),
    ("convolution forward and other cuDNN", CONV),
    ("other PyTorch kernels", re.compile(r".")),
)
# K3's times before its row tiles, in the one-pixel-a-thread form (PERF.md's
# kernel table: this script's phase 6 on an NVIDIA H100 80GB HBM3 at 700 W),
# printed beside this run's
K3_BEFORE_MS = {"resample2d_tangents": 0.0443,
                "resample2d_tangents_multi": 0.0989,
                "resample2d_tangents_bf16": 0.0381,
                "resample2d_tangents_multi_bf16": 0.0844}
PROFILED_FORWARDS = 5
COLD_SETS = 6          # input sets a cold-cache timing takes in turn
PROFILED_STEPS = 3

# Published peaks: (memory bytes/s, float32 FLOP/s outside the tensor
# cores, dense bf16 tensor-core FLOP/s), from NVIDIA's data sheets; the
# first name that the card's name contains is taken.
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H100": (3.35e12, 67e12, 989e12)}

DEVICE = "cuda"
BATCH, HEIGHT, WIDTH = 8, 384, 512
TIMED_BATCHES = 10
TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH = 8, 384, 448
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
ROUTES = ("grad_flow", "tangents")
ROUTE_ROUNDS = 1
SHARDS = 2


# The readings of the timed phases, printed where they are taken and again
# before the kernels line, so that the end of the output carries them
SUMMARY: list = []


def note(line: str) -> None:
    """Print ``line`` and keep it for the summary at the end."""
    print(line)
    SUMMARY.append(line)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def bound_ms(nbytes: float, flops: float, peaks,
             tensor_cores: bool = False):
    """The larger of the bytes' time at the memory rate and the operations'
    at the float32 rate outside the tensor cores (or, with
    ``tensor_cores``, at the dense bf16 tensor-core rate), and which."""
    bw, f32, bf16_tc = peaks
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / (bf16_tc if tensor_cores else f32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def corr_flops(b: int, c: int, h: int, w: int, slab: bool = False,
               maxd: int = 20, s2: int = 2) -> int:
    """Flops of the correlation (forward, d_f1 and d_f2 alike) that touch
    data: a shift's multiply-add counts only where its f2 row and column lie
    inside the map (the kernels skip or zero-pad the rest).  A slab holds
    every row it is read at, so with ``slab`` all row shifts count."""
    shifts = range(-(maxd // s2), maxd // s2 + 1)
    rows = (len(shifts) * h if slab
            else sum(max(0, h - s2 * abs(t)) for t in shifts))
    cols = sum(max(0, w - s2 * abs(t)) for t in shifts)
    return 2 * b * c * rows * cols


def time_ms(fn, iters: int, warmup: int = 3,
            head_start: bool = False) -> float:
    """Milliseconds per call of ``fn`` by CUDA events.  With ``head_start``
    the card first spins for some 30 ms, so that the host has queued the
    launches before the card reaches them: a kernel shorter than its
    wrapper's time on the host otherwise reads as the host's launch rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if head_start:
        torch.cuda._sleep(60_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fns, iters: int) -> float:
    """Milliseconds per call, with the head start, of calls that take the
    functions in ``fns`` in turn: each works on buffers of its own, and
    together they hold several times the 50 MB L2 cache, so that every call
    finds its inputs in device memory, as a warp finds a fresh image in a
    model."""
    return time_ms(lambda it=iter(range(1 << 62)): fns[next(it) % len(fns)](),
                   iters, warmup=len(fns), head_start=True)


def sm_clock() -> str:
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


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


def ulp_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """A bfloat16 kernel against its plain version: every element within
    one bf16 ulp (rtol 2**-7, atol 1e-6 of the largest |want|) and at most
    1% of the elements not bit-equal."""
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: {got.dtype} and {want.dtype}, not "
                             "bfloat16")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    flips = (got != want).float().mean().item()
    atol = 1e-6 * w.abs().max().item()
    print(f"  {what}: max abs diff {err:.3e}, not bit-equal {flips:.4%} "
          f"(rtol 2^-7, atol {atol:.2e}; at most 1%)")
    if got.shape != want.shape or not torch.allclose(
            g, w, rtol=2.0 ** -7, atol=atol) or flips > 0.01:
        raise AssertionError(f"{what}: bf16 kernel disagrees with its plain "
                             "version")
    return err


def bf16_contract(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """The JAX package's bf16 contract (tests/test_models.py,
    TestBf16Precision): mean |got - want| < 0.05 (mean |want| + 1e-3)
    + 5e-3, with the relative L2 printed."""
    g, w = got.double().cpu(), want.double().cpu()
    err = (g - w).abs().mean().item()
    limit = 0.05 * (w.abs().mean().item() + 1e-3) + 5e-3
    rel = ((g - w).norm() / w.norm()).item()
    note(f"  {what}: mean error {err:.4g} against {limit:.4g}, relative L2 "
         f"{rel:.3e}")
    if not (torch.isfinite(g).all() and err < limit):
        raise AssertionError(f"{what}: outside the bf16 contract")


def grad_errors(got: dict, want: dict):
    """(worst ratio of a tensor's max |difference| to its max |g|, that
    tensor's name, |all differences| / |all gradients| in L2)."""
    worst, worst_name, diff2, norm2 = 0.0, None, 0.0, 0.0
    for name, w in want.items():
        w = w.double().cpu()
        d = got[name].double().cpu() - w
        ratio = (d.abs().max() / w.abs().max().clamp_min(1e-30)).item()
        if ratio >= worst:
            worst, worst_name = ratio, name
        diff2 += d.square().sum().item()
        norm2 += w.square().sum().item()
    return worst, worst_name, (diff2 / max(norm2, 1e-300)) ** 0.5


def subnets_close(got: dict, want: dict, gates: dict, what: str) -> None:
    """The gradients of each sub-net (the parameter name's first part)
    within ``gates.get(sub-net, 5e-2)`` of ``want`` in relative L2; a gate
    of None only prints the reading.  The worst single tensor is printed."""
    worst, worst_name = 0.0, None
    diff2, norm2 = {}, {}
    for name, w in want.items():
        w = w.double().cpu()
        d2 = (got[name].double().cpu() - w).square().sum().item()
        n2 = w.square().sum().item()
        rel = (d2 / max(n2, 1e-300)) ** 0.5
        if rel >= worst:
            worst, worst_name = rel, name
        sub = name.split(".")[0]
        diff2[sub] = diff2.get(sub, 0.0) + d2
        norm2[sub] = norm2.get(sub, 0.0) + n2
    failed = []
    readings = []
    for sub in sorted(diff2):
        rel = (diff2[sub] / max(norm2[sub], 1e-300)) ** 0.5
        gate = gates.get(sub, 5e-2)
        readings.append(f"{sub} {rel:.3e}" + ("" if gate is not None
                                              else " (printed only)"))
        if gate is not None and rel > gate:
            failed.append(sub)
    note(f"  {what}: relative L2 {', '.join(readings)}; worst tensor "
         f"{worst:.3e} ({worst_name})")
    if failed:
        raise AssertionError(f"{what}: {failed} beyond their gates in "
                             "relative L2")


def grads_close(got: dict, want: dict, tol: float, what: str,
                per_tensor: bool = True) -> None:
    """Every gradient within ``tol`` of its tensor's largest |g| or, with
    ``per_tensor`` False, all gradients within ``tol`` in relative L2."""
    worst, name, rel = grad_errors(got, want)
    print(f"  {what}: worst tensor {worst:.3e} of its max |g| ({name}); "
          f"all {len(want)} gradients {rel:.3e} in relative L2")
    if not (worst if per_tensor else rel) <= tol:
        raise AssertionError(f"{what}: gradients differ beyond {tol:g} "
                             f"{'per tensor' if per_tensor else 'in L2'}")


def nondeterministic_ops(run) -> list:
    """The ops that torch names, while ``run()`` runs under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, as having
    no deterministic implementation ("cuBLAS" for its alert on a cuBLAS
    call): from its Python warnings and from what its C++ side writes to
    the process's standard error (where an alert raised off the Python
    thread, in the autograd engine's, goes).  Under torch 2.11 it names
    nothing for torch's bilinear upsample backward, which then runs
    deterministically and raises no alert; two backward passes over one
    forward (``backward_twice``) are what show that op's atomics."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as err, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        os.dup2(err.fileno(), 2)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        err.seek(0)
        lines = (err.read().decode(errors="replace").splitlines()
                 + [str(w.message) for w in caught])
    # "<op> does not have ..." in a warning, "... Warning: <op> does not
    # have ..." in a C++ log line
    named = set()
    for line in lines:
        text = line.split("Warning: ")[-1]
        if "does not have a deterministic implementation" in text:
            named.add(text.split()[0])
        elif "is not deterministic because it uses CuBLAS" in text:
            named.add("cuBLAS")
    return sorted(named)


def profile_families(run, n: int, families, smi: str, unit: str,
                     say=print):
    """Profile ``run()`` (n repetitions of the work) and print (by ``say``)
    the device time by kernel family and the idle share of the window.
    Returns each kernel's device microseconds and its launch count over the
    window."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: their self device time is the kernel's own time
    per_kernel, counts = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        # (a user annotation's device range spans the kernels inside it)
        if (us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    busy_ms = sum(per_kernel.values()) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    totals = {name: 0.0 for name, _ in families}
    for key, us in per_kernel.items():
        totals[next(n for n, rx in families if rx.search(key))] += us / 1e3
    say(f"  wall {wall_ms / n:.3f} ms/{unit}, device busy {busy_ms / n:.3f} "
        f"ms/{unit}, idle share {1 - busy_ms / wall_ms:.4f}  [{smi}]")
    for name, fam_ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        say(f"  {name:38s} {fam_ms / n:9.3f} ms/{unit}  "
            f"{fam_ms / busy_ms:7.2%}")
    print("  top kernels:")
    for key, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3 / n:9.3f} ms/{unit}  {key[:100]}")
    return per_kernel, counts


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
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import flownet2 as flownet2_module
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import correlation_spatial as corr_sp
    from flownet2_tpu_torch.ops import resample2d as r2d
    from flownet2_tpu_torch.ops import sharding_hints, stage_glue, upsample
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    backward_kernels = (
        (corr, "correlation_bwd_cuda", corr.correlation_bwd_plain),
        (corr_sp, "corr_slab_bwd_cuda", corr_sp.corr_slab_bwd_plain),
        (r2d, "resample2d_grad_flow_cuda", r2d.resample2d_grad_flow_plain))
    forward_kernels = (
        (corr, "correlation_cuda", corr.correlation_plain),
        (corr_sp, "corr_slab_cuda", corr_sp.corr_slab_plain),
        (r2d, "resample2d_cuda", r2d.resample2d_plain),
        (r2d, "resample2d_multi_cuda", r2d.resample2d_multi_plain),
        (r2d, "resample2d_tangents_cuda", r2d.resample2d_tangents_plain))

    def plain_ops(wrappers=forward_kernels + backward_kernels):
        """The given CUDA wrappers (all of them by default) replaced by
        their plain versions."""
        stack = contextlib.ExitStack()
        for mod, name, plain in wrappers:
            stack.enter_context(mock.patch.object(mod, name, plain))
        return stack

    # -- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(kind)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"peaks taken for {peak_name}: {peaks[0] / 1e12:g} TB/s, "
          f"{peaks[1] / 1e12:g} TFLOP/s f32, {peaks[2] / 1e12:g} TFLOP/s "
          "bf16 tensor cores")
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    # ptxas's register and spill lines, each under the kernel they belong to
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
                print(f"  {name}: {kernel}")
            elif "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    # -- 2. kernels against their plain versions ----------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    # the row-band checks draw from a generator of their own, so that the
    # inputs of the other phases are the ones they always had
    band_gen = torch.Generator(device=dev).manual_seed(7)
    # and so do the checks at the odd-width map
    odd_gen = torch.Generator(device=dev).manual_seed(11)
    odd_shape = (2, 40, 20, 75)

    def randn(*shape, scale=1.0, gen=gen):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    corr_args = (20, 1, 20, 1, 2)
    disp = 21
    print("phase 2: kernels against their plain versions")
    errs = {}
    # no_grad, not inference_mode: the tangent route's check below builds
    # a graph from these tensors
    with torch.no_grad():
        # the main paths' shapes, the wide (384x1024 frames) one, a ragged
        # one (a partial channel chunk and a partial column tile) and an
        # odd-width one (no 16-byte alignment of the rows)
        for shape in ((BATCH, 256, HEIGHT // 8, WIDTH // 8),
                      (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
                      (4, 256, 48, 128), (2, 40, 20, 152), odd_shape):
            shape_gen = odd_gen if shape == odd_shape else gen
            f1, f2 = (randn(*shape, gen=shape_gen) for _ in range(2))
            if shape[3] != TRAIN_WIDTH // 8:
                errs.setdefault("correlation_fwd", []).append(max_err(
                    corr.correlation_cuda(f1, f2, *corr_args),
                    corr.correlation_plain(f1, f2, *corr_args), 1e-4, 1e-4,
                    f"K1 correlation {shape}"))
            if shape[3] == WIDTH // 8:
                continue
            g = randn(shape[0], disp * disp, *shape[2:], gen=shape_gen)
            got = corr.correlation_bwd_cuda(g, f1, f2, 20, 2)
            want = corr.correlation_bwd_plain(g, f1, f2, 20, 2)
            for k, name in enumerate(("correlation_bwd_f1",
                                      "correlation_bwd_f2")):
                errs.setdefault(name, []).append(max_err(
                    got[k], want[k], 1e-4, 1e-4,
                    f"K{5 + k} correlation d_f{1 + k} {shape}"))
        # K1's, K5's and K6's general bodies: configurations the
        # register-tiled ones do not cover
        for maxd, s2 in ((8, 1), (4, 2)):
            f1, f2 = (randn(*odd_shape, gen=odd_gen) for _ in range(2))
            other_args = (maxd, 1, maxd, 1, s2)
            errs["correlation_fwd"].append(max_err(
                corr.correlation_cuda(f1, f2, *other_args),
                corr.correlation_plain(f1, f2, *other_args), 1e-4, 1e-4,
                f"K1 correlation {odd_shape}, maxd {maxd}, s2 {s2}"))
            other_disp = 2 * (maxd // s2) + 1
            g = randn(odd_shape[0], other_disp ** 2, *odd_shape[2:],
                      gen=odd_gen)
            got = corr.correlation_bwd_cuda(g, f1, f2, maxd, s2)
            want = corr.correlation_bwd_plain(g, f1, f2, maxd, s2)
            for k, name in enumerate(("correlation_bwd_f1",
                                      "correlation_bwd_f2")):
                errs[name].append(max_err(
                    got[k], want[k], 1e-4, 1e-4,
                    f"K{5 + k} correlation d_f{1 + k} {odd_shape}, maxd "
                    f"{maxd}, s2 {s2}"))
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

        t_img = randn(TRAIN_BATCH, 3, TRAIN_HEIGHT, TRAIN_WIDTH)
        t_flows = torch.stack([
            uniform(TRAIN_BATCH, 2, TRAIN_HEIGHT, TRAIN_WIDTH, scale=px)
            for px in (8.0, 200.0)], dim=1)
        cases = [(f"+-{px} px", t_img, t_flows[:, i:i + 1].contiguous())
                 for i, px in enumerate((8, 200))]
        cases += [("two flows", t_img, t_flows),
                  ("(2, 3, 100, 150)", ragged_img, ragged_flow.unsqueeze(1))]
        for what, im, fl in cases:
            nflows = fl.shape[1]
            k3 = r2d._per_flow("resample2d_tangents", nflows)
            got = r2d.resample2d_tangents_cuda(im, fl)
            want = r2d.resample2d_tangents_plain(im, fl)
            for part, a, b in zip(("out", "d1", "d2"), got, want):
                errs.setdefault(k3, []).append(max_err(
                    a, b, 1e-5, 1e-5, f"K3 warp tangents {part}, {what}"))
            g = randn(*want[0].shape)
            k4 = r2d.resample2d_grad_flow_cuda(g, im, fl)
            errs.setdefault(r2d._per_flow("resample2d_grad_flow", nflows),
                            []).append(max_err(
                k4, r2d.resample2d_grad_flow_plain(g, im, fl), 1e-5, 1e-5,
                f"K4 warp flow gradient, {what}"))
            # the tangent route's flow gradient for the same cotangent
            with torch.enable_grad():
                leaf = fl.clone().requires_grad_()
                (tangent_grad,) = torch.autograd.grad(
                    r2d.resample2d_tangents(im, leaf), leaf, g)
            max_err(k4, tangent_grad, 1e-5, 1e-5,
                    f"K4 against the tangent route's d_flow, {what}")

        # K7 on bands of the main paths', the wide and the ragged maps: one
        # band (whose d_slab rows [20, 20 + H) are K6's bits), and the top, a
        # middle and the bottom band of 2 and 4 (12 rows < maxd 20 at 4)
        slab_names = ("correlation_fwd_rows", "correlation_bwd_f1_rows",
                      "correlation_bwd_f2_rows")
        for shape in ((BATCH, 256, HEIGHT // 8, WIDTH // 8),
                      (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
                      (4, 256, 48, 128), (2, 40, 20, 152), odd_shape):
            shape_gen = odd_gen if shape == odd_shape else band_gen
            f1, f2 = (randn(*shape, gen=shape_gen) for _ in range(2))
            g = randn(shape[0], disp * disp, *shape[2:], gen=shape_gen)
            whole = (corr.correlation_cuda(f1, f2, *corr_args),
                     *corr.correlation_bwd_cuda(g, f1, f2, 20, 2))
            f2p = F.pad(f2, (0, 0, 20, 20))
            for shards in (1, 2, 4):
                local_h = shape[2] // shards
                d_f2p = torch.zeros_like(f2p)
                for band in range(shards):
                    off = band * local_h
                    rows = slice(off, off + local_h)
                    f1_loc = f1[:, :, rows].contiguous()
                    g_loc = g[:, :, rows].contiguous()
                    slab = f2p[:, :, off:off + local_h + 40].contiguous()
                    got = (corr_sp.corr_slab_cuda(f1_loc, slab, 20, 2),
                           *corr_sp.corr_slab_bwd_cuda(g_loc, f1_loc, slab,
                                                       20, 2))
                    d_f2p[:, :, off:off + local_h + 40] += got[2]
                    for k in range(2):
                        if not torch.equal(got[k], whole[k][:, :, rows]):
                            raise AssertionError(
                                f"{slab_names[k]} {shape}, band {band} of "
                                f"{shards}: not the whole-map kernel's bits")
                    if 1 < band < shards - 1:
                        continue   # one middle band is held to the plain op
                    want = (corr_sp.corr_slab_plain(f1_loc, slab, 20, 2),
                            *corr_sp.corr_slab_bwd_plain(g_loc, f1_loc, slab,
                                                         20, 2))
                    for name, a, b in zip(slab_names, got, want):
                        errs.setdefault(name, []).append(max_err(
                            a, b, 1e-5, 1e-5, f"K7 {name} {shape}, band "
                            f"{band} of {shards}"))
                if shards == 1:
                    if not torch.equal(d_f2p[:, :, 20:-20], whole[2]):
                        raise AssertionError(
                            f"{slab_names[2]} {shape}, one band: rows "
                            "[20, 20 + H) not the whole-map kernel's bits")
                    continue
                max_err(d_f2p[:, :, 20:-20], whole[2], 1e-5, 1e-5,
                        f"K7 d_slab summed over {shards} bands against K6 "
                        f"{shape} (forward and d_f1 bit-equal to K1, K5)")

        # the local-rows K2, K3, K4 against the same rows of the whole image
        for what, im, fl in (
                ("K2 shape, one flow of +-8 px", img, flow8.unsqueeze(1)),
                ("K2 shape, one flow of +-200 px", img, flow200.unsqueeze(1)),
                ("K2 shape, two flows", img, flows),
                ("K3/K4 shape, one flow of +-200 px", t_img,
                 t_flows[:, 1:].contiguous()),
                ("K3/K4 shape, two flows", t_img, t_flows)):
            g = randn(fl.shape[0], fl.shape[1], 3, *fl.shape[3:], gen=band_gen)
            whole = (r2d.resample2d_multi_cuda(im, fl),
                     *r2d.resample2d_tangents_cuda(im, fl),
                     r2d.resample2d_grad_flow_cuda(g, im, fl))
            for shards in (2, 4):
                local_h = im.shape[2] // shards
                for off in range(0, im.shape[2], local_h):
                    rows = slice(off, off + local_h)
                    fl_loc = fl[:, :, :, rows].contiguous()
                    got = (r2d.resample2d_multi_cuda(im, fl_loc, off),
                           *r2d.resample2d_tangents_cuda(im, fl_loc, off),
                           r2d.resample2d_grad_flow_cuda(
                               g[:, :, :, rows].contiguous(), im, fl_loc, off))
                    for part, a, b in zip(("K2", "K3 out", "K3 d1", "K3 d2",
                                           "K4"), got, whole):
                        if not torch.equal(a, b[:, :, :, rows]):
                            raise AssertionError(
                                f"{part} local rows [{off}, {off + local_h})"
                                f", {what}: not the whole-image kernel's "
                                "bits")
            print(f"  K2, K3, K4 on the bands of 2 and of 4, {what}: bit-equal "
                  "to the whole-image kernels' rows")

        # the bf16 forms of K1 and K2 against their plain versions (which
        # upcast, compute in f32 and round once), on inputs of their own
        # generator: the other phases' inputs stay the ones they had
        print("  bf16 kernels against their plain versions, one bf16 ulp")
        bf16_gen = torch.Generator(device=dev).manual_seed(13)
        # K1 bf16's tensor-core body at maxd 20, s2 2: C = 40 is no multiple
        # of its 16-channel k-steps, W = 152 none of its 64-column tiles
        # (16-byte copies) and 75 odd (2-byte copies), and maps of 3 and 5
        # rows end inside a block's rows; the general body at two other
        # configurations
        fwd16_cases = [(shape, 20, 2) for shape in (
            (BATCH, 256, HEIGHT // 8, WIDTH // 8), (4, 256, 48, 128),
            (2, 40, 20, 152), odd_shape, (2, 40, 3, 64), (2, 40, 5, 75))]
        fwd16_cases += [(odd_shape, 8, 1), (odd_shape, 4, 2)]
        for shape, maxd, s2 in fwd16_cases:
            f1, f2 = (randn(*shape, gen=bf16_gen).bfloat16() for _ in range(2))
            args = (maxd, 1, maxd, 1, s2)
            errs.setdefault("correlation_fwd_bf16", []).append(ulp_err(
                corr.correlation_cuda(f1, f2, *args),
                corr.correlation_plain(f1, f2, *args),
                f"K1 bf16 correlation {shape}, maxd {maxd}, s2 {s2}"))
        img16, ragged16 = img.bfloat16(), ragged_img.bfloat16()
        for what, im, fl in (("one flow of +-8 px", img16, flow8),
                             ("one flow of +-200 px", img16, flow200),
                             ("one flow, (2, 3, 100, 150)", ragged16,
                              ragged_flow)):
            fl = fl.bfloat16()
            errs.setdefault("resample2d_fwd_bf16", []).append(ulp_err(
                r2d.resample2d_cuda(im, fl), r2d.resample2d_plain(im, fl),
                f"K2 bf16 warp, {what}"))
        ragged_flows = torch.stack(
            [ragged_flow, randn(2, 2, 100, 150, gen=bf16_gen) * 200.0], dim=1)
        for what, im, fl in (("two flows", img16, flows),
                             ("two flows, (2, 3, 100, 150)", ragged16,
                              ragged_flows)):
            fl = fl.bfloat16()
            errs.setdefault("resample2d_fwd_multi_bf16", []).append(ulp_err(
                r2d.resample2d_multi_cuda(im, fl),
                r2d.resample2d_multi_plain(im, fl), f"K2 bf16 warp, {what}"))

        # the bf16 forms of K5 and K6 (their tensor-core bodies at maxd 20,
        # s2 2) at the training, the main-path, the wide and the two ragged
        # maps, at W = 150 (even, no multiple of 8: 4-byte copies) and at
        # maps of 3 and 5 rows, which end inside a block's rows (W = 75
        # odd: 2-byte copies), and at the two other configurations (the
        # general bodies)
        bwd_cases = [(shape, 20, 2) for shape in (
            (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
            (BATCH, 256, HEIGHT // 8, WIDTH // 8), (4, 256, 48, 128),
            (2, 40, 20, 152), odd_shape, (2, 40, 20, 150), (2, 40, 3, 64),
            (2, 40, 5, 75))]
        bwd_cases += [(odd_shape, 8, 1), (odd_shape, 4, 2)]
        bwd_flips = ([], [])
        for shape, maxd, s2 in bwd_cases:
            f1, f2 = (randn(*shape, gen=bf16_gen).bfloat16() for _ in range(2))
            g = randn(shape[0], (2 * (maxd // s2) + 1) ** 2, *shape[2:],
                      gen=bf16_gen).bfloat16()
            got = corr.correlation_bwd_cuda(g, f1, f2, maxd, s2)
            want = corr.correlation_bwd_plain(g, f1, f2, maxd, s2)
            for k, name in enumerate(("correlation_bwd_f1_bf16",
                                      "correlation_bwd_f2_bf16")):
                errs.setdefault(name, []).append(ulp_err(
                    got[k], want[k], f"K{5 + k} bf16 correlation d_f{1 + k} "
                    f"{shape}, maxd {maxd}, s2 {s2}"))
            if maxd == 20:
                for k in range(2):
                    bwd_flips[k].append(
                        (got[k] != want[k]).float().mean().item())
        for k, flips in enumerate(bwd_flips):
            note(f"  K{5 + k} bf16 (tensor-core body) against its plain "
                 f"version: {min(flips):.4%} to {max(flips):.4%} of the "
                 f"values not bit-equal over the {len(flips)} maxd 20 maps")
        # the bf16 forms of K3 and K4 on phase 2's K3/K4 cases: out and the
        # flow gradient at one ulp, K3's float32 d1 and d2 at 1e-5, and K4
        # against the tangent route's bf16 flow gradient
        t_img16 = t_img.bfloat16()
        for what, im, fl in cases:
            im, fl = im.bfloat16(), fl.bfloat16()
            nflows = fl.shape[1]
            k3 = r2d._per_flow("resample2d_tangents", nflows) + "_bf16"
            got = r2d.resample2d_tangents_cuda(im, fl)
            want = r2d.resample2d_tangents_plain(im, fl)
            errs.setdefault(k3, []).append(ulp_err(
                got[0], want[0], f"K3 bf16 warp tangents out, {what}"))
            for part, a, b in zip(("d1", "d2"), got[1:], want[1:]):
                if a.dtype != torch.float32:
                    raise AssertionError(f"K3 bf16 {part}: {a.dtype}")
                errs[k3].append(max_err(a, b, 1e-5, 1e-5,
                                        f"K3 bf16 warp tangents {part} "
                                        f"(float32), {what}"))
            g = randn(*want[0].shape, gen=bf16_gen).bfloat16()
            k4 = r2d.resample2d_grad_flow_cuda(g, im, fl)
            errs.setdefault(r2d._per_flow("resample2d_grad_flow", nflows)
                            + "_bf16", []).append(ulp_err(
                k4, r2d.resample2d_grad_flow_plain(g, im, fl),
                f"K4 bf16 warp flow gradient, {what}"))
            with torch.enable_grad():
                leaf = fl.clone().requires_grad_()
                (tangent_grad,) = torch.autograd.grad(
                    r2d.resample2d_tangents(im, leaf), leaf, g)
            ulp_err(k4, tangent_grad, f"K4 bf16 against the tangent route's "
                    f"bf16 d_flow, {what}")

        # the bf16 row bands: K7 bf16 (the forward, d_f1 and d_slab on K1's,
        # K5's and K6's bf16 tensor-core bodies) on the bands of the main
        # paths', the wide and the ragged maps, as the f32 K7 above, and of
        # a 5-row map, whose bands of 4 are one row each, so that 40 of the
        # 41 rows of each slab are halo: every band's forward and d_f1 the
        # same rows of K1 bf16 and K5 bf16 bit for bit, one band's d_slab
        # rows [20, 20 + H) K6 bf16's, and the top, a middle and the bottom
        # band at one ulp of the plain version (the d_f1 bands' flip rates
        # noted)
        rows16_names = tuple(n + "_bf16" for n in slab_names)
        d_f1_flips = []
        for shape in ((BATCH, 256, HEIGHT // 8, WIDTH // 8),
                      (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
                      (4, 256, 48, 128), (2, 40, 20, 152), odd_shape,
                      (2, 40, 5, 64)):
            f1, f2 = (randn(*shape, gen=bf16_gen).bfloat16() for _ in range(2))
            g = randn(shape[0], disp * disp, *shape[2:],
                      gen=bf16_gen).bfloat16()
            whole = (corr.correlation_cuda(f1, f2, *corr_args),
                     *corr.correlation_bwd_cuda(g, f1, f2, 20, 2))
            f2p = F.pad(f2, (0, 0, 20, 20))
            for shards in (1, 2, 4):
                local_h = shape[2] // shards
                for band in range(shards):
                    off = band * local_h
                    rows = slice(off, off + local_h)
                    f1_loc = f1[:, :, rows].contiguous()
                    g_loc = g[:, :, rows].contiguous()
                    slab = f2p[:, :, off:off + local_h + 40].contiguous()
                    got = (corr_sp.corr_slab_cuda(f1_loc, slab, 20, 2),
                           *corr_sp.corr_slab_bwd_cuda(g_loc, f1_loc, slab,
                                                       20, 2))
                    for k in range(2):
                        if not torch.equal(got[k], whole[k][:, :, rows]):
                            raise AssertionError(
                                f"{rows16_names[k]} {shape}, band {band} of "
                                f"{shards}: not the whole-map bf16 kernel's "
                                "bits")
                    if shards == 1 and not torch.equal(got[2][:, :, 20:-20],
                                                       whole[2]):
                        raise AssertionError(
                            f"{rows16_names[2]} {shape}, one band: rows "
                            "[20, 20 + H) not K6 bf16's bits")
                    if 1 < band < shards - 1:
                        continue   # one middle band is held to the plain op
                    want = (corr_sp.corr_slab_plain(f1_loc, slab, 20, 2),
                            *corr_sp.corr_slab_bwd_plain(g_loc, f1_loc, slab,
                                                         20, 2))
                    for name, a, b in zip(rows16_names, got, want):
                        errs.setdefault(name, []).append(ulp_err(
                            a, b, f"K7 bf16 {name} {shape}, band {band} of "
                            f"{shards}"))
                    d_f1_flips.append(
                        (got[1] != want[1]).float().mean().item())
            print(f"  K7 bf16 {shape}: one band bit-equal to K1, K5, K6 bf16; "
                  "the bands of 2 and of 4 bit-equal to K1, K5 bf16's rows")
        note(f"  K7 bf16 d_f1 (K5's tensor-core body) against its plain "
             f"version: {min(d_f1_flips):.4%} to {max(d_f1_flips):.4%} of the "
             f"values not bit-equal over {len(d_f1_flips)} bands")

        # the bf16 local-rows K2, K3, K4 against the same rows of the
        # whole-image bf16 kernels, at +-8 px and +-200 px, one and two
        # flows, on the bands of 2 and of 4: the second band of two of a
        # 384-row image starts at row 192, where a bf16 ulp is 1 px, so a
        # port that added the offset to the bf16 flow would fail here
        for what, im, fl in (
                ("K2 shape, one flow of +-8 px", img16, flow8.unsqueeze(1)),
                ("K2 shape, one flow of +-200 px", img16,
                 flow200.unsqueeze(1)),
                ("K2 shape, two flows", img16, flows),
                ("K3/K4 shape, one flow of +-8 px", t_img16,
                 t_flows[:, :1].contiguous()),
                ("K3/K4 shape, one flow of +-200 px", t_img16,
                 t_flows[:, 1:].contiguous()),
                ("K3/K4 shape, two flows", t_img16, t_flows)):
            fl = fl.bfloat16()
            g = randn(fl.shape[0], fl.shape[1], 3, *fl.shape[3:],
                      gen=bf16_gen).bfloat16()
            whole = (r2d.resample2d_multi_cuda(im, fl),
                     *r2d.resample2d_tangents_cuda(im, fl),
                     r2d.resample2d_grad_flow_cuda(g, im, fl))
            for shards in (2, 4):
                local_h = im.shape[2] // shards
                for off in range(0, im.shape[2], local_h):
                    rows = slice(off, off + local_h)
                    fl_loc = fl[:, :, :, rows].contiguous()
                    got = (r2d.resample2d_multi_cuda(im, fl_loc, off),
                           *r2d.resample2d_tangents_cuda(im, fl_loc, off),
                           r2d.resample2d_grad_flow_cuda(
                               g[:, :, :, rows].contiguous(), im, fl_loc, off))
                    for part, a, b in zip(("K2", "K3 out", "K3 d1", "K3 d2",
                                           "K4"), got, whole):
                        if a.dtype != b.dtype or not torch.equal(
                                a, b[:, :, :, rows]):
                            raise AssertionError(
                                f"{part} bf16 local rows [{off}, "
                                f"{off + local_h}), {what}: not the "
                                "whole-image bf16 kernel's bits")
            print(f"  K2, K3, K4 bf16 on the bands of 2 and of 4, {what}: "
                  "bit-equal to the whole-image bf16 kernels' rows")

        # the row tiles of K2 and K4 (one and two flows, f32 and bf16) at
        # the smooth flow the stage glue makes (+-8 px at (H/4, W/4),
        # bilinear x4), and in one launch whose blocks take both routes:
        # half the batch at +-8 px (the window in shared memory), half at
        # +-200 px (the image in global memory); inputs of their own
        # generator
        tile_gen = torch.Generator(device=dev).manual_seed(17)

        def tile_uniform(*shape, scale):
            return (torch.rand(shape, generator=tile_gen, device=dev) * 2
                    - 1) * scale

        def smooth_flows(b, nflows, h, w):
            coarse = tile_uniform(b * nflows, 2, h // 4, w // 4, scale=8.0)
            return upsample.upsample_bilinear(coarse).reshape(
                b, nflows, 2, h, w)

        half = BATCH // 2
        tile_cases = []
        for nflows in (1, 2):
            for h, w in ((HEIGHT, WIDTH), (TRAIN_HEIGHT, TRAIN_WIDTH)):
                tile_cases.append((f"smooth flow, {nflows} flow(s), {h}x{w}",
                                   smooth_flows(BATCH, nflows, h, w)))
            tile_cases.append((
                f"both routes in one launch, {nflows} flow(s)",
                torch.cat([tile_uniform(half, nflows, 2, HEIGHT, WIDTH,
                                        scale=8.0),
                           tile_uniform(BATCH - half, nflows, 2, HEIGHT,
                                        WIDTH, scale=200.0)])))
        for what, fl in tile_cases:
            im = randn(BATCH, 3, *fl.shape[3:], gen=tile_gen)
            g = randn(*fl.shape[:2], 3, *fl.shape[3:], gen=tile_gen)
            nflows = fl.shape[1]
            k2 = r2d._per_flow("resample2d_fwd", nflows)
            k4 = r2d._per_flow("resample2d_grad_flow", nflows)
            k3 = r2d._per_flow("resample2d_tangents", nflows)
            # K3 (f32, then bf16: out at one ulp, d1 and d2 at 1e-5)
            for dtype in (torch.float32, torch.bfloat16):
                got = r2d.resample2d_tangents_cuda(im.to(dtype), fl.to(dtype))
                want = r2d.resample2d_tangents_plain(im.to(dtype),
                                                     fl.to(dtype))
                sfx = "_bf16" if dtype == torch.bfloat16 else ""
                for part, a, b in zip(("out", "d1", "d2"), got, want):
                    errs[k3 + sfx].append(
                        ulp_err(a, b, f"K3 bf16 warp tangents {part}, {what}")
                        if a.dtype == torch.bfloat16 else
                        max_err(a, b, 1e-5, 1e-5, f"K3{sfx.replace('_', ' ')}"
                                f" warp tangents {part}, {what}"))
            errs[k2].append(max_err(
                r2d.resample2d_multi_cuda(im, fl),
                r2d.resample2d_multi_plain(im, fl), 1e-5, 1e-5,
                f"K2 warp, {what}"))
            errs[k4].append(max_err(
                r2d.resample2d_grad_flow_cuda(g, im, fl),
                r2d.resample2d_grad_flow_plain(g, im, fl), 1e-5, 1e-5,
                f"K4 warp flow gradient, {what}"))
            im, fl, g = im.bfloat16(), fl.bfloat16(), g.bfloat16()
            errs[k2 + "_bf16"].append(ulp_err(
                r2d.resample2d_multi_cuda(im, fl),
                r2d.resample2d_multi_plain(im, fl), f"K2 bf16 warp, {what}"))
            errs[k4 + "_bf16"].append(ulp_err(
                r2d.resample2d_grad_flow_cuda(g, im, fl),
                r2d.resample2d_grad_flow_plain(g, im, fl),
                f"K4 bf16 warp flow gradient, {what}"))
        print("  K2, K3 and K4 (f32, bf16) at the smooth flow and with both "
              "routes in one launch: within the tolerances")

        # K3 and K4 (f32, bf16) at W = 136: the last column tile's first
        # thread pair of a bf16 K3 row has one thread in the map and one
        # past its end (the tangents' paired stores); inputs of their own
        # generator
        pair_gen = torch.Generator(device=dev).manual_seed(19)
        im = randn(2, 3, 100, 136, gen=pair_gen)
        fl = (torch.rand((2, 2, 2, 100, 136), generator=pair_gen,
                         device=dev) * 2 - 1) * 8.0
        g = randn(2, 2, 3, 100, 136, gen=pair_gen)
        what = "two flows, (2, 3, 100, 136)"
        for dtype in (torch.float32, torch.bfloat16):
            sfx = "_bf16" if dtype == torch.bfloat16 else ""
            im_d, fl_d, g_d = im.to(dtype), fl.to(dtype), g.to(dtype)
            got = r2d.resample2d_tangents_cuda(im_d, fl_d)
            want = r2d.resample2d_tangents_plain(im_d, fl_d)
            for part, a, b in zip(("out", "d1", "d2"), got, want):
                errs["resample2d_tangents_multi" + sfx].append(
                    ulp_err(a, b, f"K3 bf16 warp tangents {part}, {what}")
                    if a.dtype == torch.bfloat16 else
                    max_err(a, b, 1e-5, 1e-5, f"K3{sfx.replace('_', ' ')} "
                            f"warp tangents {part}, {what}"))
            k4 = r2d.resample2d_grad_flow_cuda(g_d, im_d, fl_d)
            k4_plain = r2d.resample2d_grad_flow_plain(g_d, im_d, fl_d)
            errs["resample2d_grad_flow_multi" + sfx].append(
                ulp_err(k4, k4_plain, f"K4 bf16 warp flow gradient, {what}")
                if sfx else max_err(k4, k4_plain, 1e-5, 1e-5,
                                    f"K4 warp flow gradient, {what}"))

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
        note(f"  phase 3, fp32 inference: {ms:.3f} ms/batch, "
             f"{BATCH / ms * 1e3:.2f} frames/s, peak {peak_gib:.2f} GiB "
             f"allocated  [{smi}]")

        flow = model(pairs[0])
        with plain_ops():
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

    # -- 3b. FlowNet2 bf16 inference ------------------------------------------
    print(f"phase 3b: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} bf16 (float32 "
          "parameters, bf16 convolutions, glue and warps)")
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)
    with torch.inference_mode():
        for pair in pairs:
            model16(pair)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.reset_counts()
        start.record()
        for i in range(TIMED_BATCHES):
            flow16 = model16(pairs[i % 2])
        end.record()
        torch.cuda.synchronize()
        launches16, plain16 = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        ms16 = start.elapsed_time(end) / TIMED_BATCHES
        peak16_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"correlation_fwd_bf16": TIMED_BATCHES,
                "resample2d_fwd_bf16": 2 * TIMED_BATCHES,
                "resample2d_fwd_multi_bf16": TIMED_BATCHES}
        print(f"  launches over {TIMED_BATCHES} forwards: {launches16}; "
              f"plain-op calls: {plain16}")
        if launches16 != want or plain16:
            raise AssertionError(f"bf16 path launches {launches16} / plain "
                                 f"calls {plain16}; expected {want} / {{}}")
        if flow16.shape != (BATCH, HEIGHT, WIDTH, 2) \
                or flow16.dtype != torch.bfloat16 \
                or not torch.isfinite(flow16).all():
            raise AssertionError(f"bad bf16 flow: {tuple(flow16.shape)} "
                                 f"{flow16.dtype}, finite="
                                 f"{torch.isfinite(flow16).all().item()}")
        note(f"  phase 3b, bf16 inference: {ms16:.3f} ms/batch, "
             f"{BATCH / ms16 * 1e3:.2f} frames/s, peak {peak16_gib:.2f} GiB "
             f"allocated; launches over {TIMED_BATCHES} forwards "
             f"{launches16}  [{smi}]")

        # how far the host holds the card back: the host's time to enqueue
        # a forward against the card's time for one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIMED_BATCHES):
            model16(pairs[i % 2])
        host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_BATCHES
        torch.cuda.synchronize()
        note(f"  the host enqueues a bf16 forward in {host_ms:.3f} ms, the "
             f"card runs one in {ms16:.3f} ms (CUDA events above)")

        flow16 = model16(pairs[0])
        with plain_ops():
            bf16_contract(flow16, model16(pairs[0]),
                          "against the plain-op bf16 model on the card")
        def rel_l2(a, b):
            return ((a - b).float().norm() / b.float().norm()).item()

        # what of that is the kernels' and what cuDNN's: the model against
        # itself with cuDNN's default algorithms, and the two with
        # deterministic ones
        again = model16(pairs[0])
        print(f"  the bf16 model against itself, cuDNN's defaults: relative "
              f"L2 {rel_l2(again, flow16):.3e}")
        torch.backends.cudnn.deterministic = True
        again = model16(pairs[0])
        with plain_ops():
            plain_again = model16(pairs[0])
        torch.backends.cudnn.deterministic = False
        print(f"  against the plain-op bf16 model, cuDNN deterministic: "
              f"relative L2 {rel_l2(again, plain_again):.3e}, not bit-equal "
              f"{(again != plain_again).float().mean().item():.4%}")
        del again, plain_again
        bf16_contract(flow16, model(pairs[0]),
                      "against the fp32 model of the same weights")
        small16 = model16(small)
        bf16_contract(small16, get_model(
            "FlowNet2", device="cpu", seed=0, dtype=torch.bfloat16)(
                small.cpu()), "small pair against the bf16 model on the CPU")
        # the bf16 model under the row bands (K7 bf16 and the bf16
        # local-rows warps) against the whole map, cuDNN deterministic: the
        # same bodies in the same order, the offsets joined first
        torch.backends.cudnn.deterministic = True
        flow_whole16 = model16(pairs[0])
        with sharding_hints.scoped_spatial_shards(SHARDS):
            flow_bands16 = model16(pairs[0])
        torch.backends.cudnn.deterministic = False
        note(f"  bf16 model under {SHARDS} row bands against the whole map, "
             "cuDNN deterministic: bit-equal "
             f"{torch.equal(flow_bands16, flow_whole16)}, not bit-equal "
             f"{(flow_bands16 != flow_whole16).float().mean().item():.4%}")
        bf16_contract(flow_bands16, flow_whole16, f"bf16 model under {SHARDS} "
                      "row bands against the whole map")
        del flow16, small16, flow_whole16, flow_bands16
    # phase 4 runs as it did before phase 3b: no second model beside it
    del model16
    torch.cuda.empty_cache()

    # -- 4. FlowNet2 training -------------------------------------------------
    print(f"phase 4: FlowNet2 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
          f"{TRAIN_WIDTH} fp32, TF32 off, MultiScale, Adam 1e-4")
    tmodel = get_model("FlowNet2", device=DEVICE, seed=0)
    images = torch.rand((TRAIN_BATCH, 2, TRAIN_HEIGHT, TRAIN_WIDTH, 3),
                        generator=gen, device=dev) * 255.0
    target = torch.rand((TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 2),
                        generator=gen, device=dev) * 5.0
    loss_fn = MultiScale()

    def loss_and_grads(net, imgs, tgt):
        net.train()
        net.zero_grad(set_to_none=True)
        lossvalue, epevalue = loss_fn(net(imgs), tgt)
        lossvalue.backward()
        grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return lossvalue.item(), epevalue.item(), grads

    # The gradient is discontinuous in the forward's values (floor() in
    # the warps, the LeakyReLU kinks), so two forwards that differ in the
    # last bit give gradients that differ well beyond rounding.  The checks
    # are therefore: with the forward shared, the backward kernels against
    # the plain backward, per tensor; both warp routes against each other,
    # per tensor (their forwards are the same arithmetic); the plain-op
    # model in relative L2 over all gradients, its per-tensor spread printed
    # beside the kernel model's own spread from run to run.  cuDNN is made
    # deterministic for the comparisons, so that only the ops differ.
    torch.backends.cudnn.deterministic = True
    loss_k, epe_k, grads_k = loss_and_grads(tmodel, images, target)
    print(f"  first step: loss {loss_k:.6f}, EPE {epe_k:.6f}")
    for route in ROUTES:
        with mock.patch.object(stage_glue, "TRAIN_WARP", route):
            grads_r = (grads_k if route == stage_glue.TRAIN_WARP else
                       loss_and_grads(tmodel, images, target)[2])
            with plain_ops(backward_kernels):
                ops.reset_counts()
                grads_b = loss_and_grads(tmodel, images, target)[2]
                if any(k in ops.LAUNCHES for k in (
                        "correlation_bwd_f1", "correlation_bwd_f2",
                        "resample2d_grad_flow", "resample2d_grad_flow_multi")):
                    raise AssertionError(f"plain backward launched "
                                         f"{dict(ops.LAUNCHES)}")
            grads_close(grads_r, grads_b, 1e-3, f"{route} route, backward "
                        "kernels against the plain backward")
        if route != stage_glue.TRAIN_WARP:
            grads_close(grads_r, grads_k, 1e-3, f"{route} route against the "
                        f"{stage_glue.TRAIN_WARP} route")
    del grads_r, grads_b
    with plain_ops():
        ops.reset_counts()
        loss_p, epe_p, grads_p = loss_and_grads(tmodel, images, target)
        if sum(ops.LAUNCHES.values()):
            raise AssertionError(f"plain-op step launched {ops.LAUNCHES}")
    print(f"  plain-op model: loss {loss_p:.6f}, EPE {epe_p:.6f}")
    for a, b, what in ((loss_k, loss_p, "loss"), (epe_k, epe_p, "EPE")):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"{what}: kernels {a} vs plain ops {b}")
    grads_close(grads_k, grads_p, 1e-3, "against the plain-op model",
                per_tensor=False)
    del grads_p
    torch.backends.cudnn.deterministic = False
    grads_1 = loss_and_grads(tmodel, images, target)[2]
    worst, name, rel = grad_errors(loss_and_grads(tmodel, images, target)[2],
                                   grads_1)
    print(f"  the kernel model against itself, cuDNN not deterministic: "
          f"worst tensor {worst:.3e} of its max |g| ({name}), {rel:.3e} in "
          f"relative L2")
    del grads_1

    small_img = images[:1, :, :64, :128].contiguous()
    small_tgt = target[:1, :64, :128].contiguous()
    cpu_model = get_model("FlowNet2", device="cpu", seed=0)
    loss_s, epe_s, grads_s = loss_and_grads(tmodel, small_img, small_tgt)
    loss_c, epe_c, grads_c = loss_and_grads(cpu_model, small_img.cpu(),
                                            small_tgt.cpu())
    print(f"  small step: loss {loss_s:.6f} / EPE {epe_s:.6f} on the card, "
          f"{loss_c:.6f} / {epe_c:.6f} on the CPU")
    for a, b, what in ((loss_s, loss_c, "small loss"),
                       (epe_s, epe_c, "small EPE")):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"{what}: card {a} vs CPU {b}")
    # in relative L2, as against the plain-op model: the card's and the
    # CPU's forwards differ in the last bit too, and a per-tensor reading
    # swings from 3e-4 to 2e-2 with the random batch
    grads_close(grads_s, grads_c, 1e-3, "small step against the CPU",
                per_tensor=False)
    # the gate holds on this draw; on other draws it has read over 1e-3,
    # with torch's upsample as with the port's (ROADMAP.md, section 3), so
    # three more are read and printed, not gated
    draw_gen = torch.Generator(device=dev)
    for draw_seed in (1, 2, 3):
        draw_gen.manual_seed(draw_seed)
        draw_img = torch.rand((1, 2, 64, 128, 3), generator=draw_gen,
                              device=dev) * 255.0
        draw_tgt = torch.rand((1, 64, 128, 2), generator=draw_gen,
                              device=dev) * 5.0
        g_card = loss_and_grads(tmodel, draw_img, draw_tgt)[2]
        g_cpu = loss_and_grads(cpu_model, draw_img.cpu(),
                               draw_tgt.cpu())[2]
        by_net = {net: grad_errors(
            {n: g for n, g in g_card.items() if n.startswith(net + ".")},
            {n: g for n, g in g_cpu.items() if n.startswith(net + ".")})[2]
            for net in ("flownetc", "flownets_1")}
        all_rel = grad_errors(g_card, g_cpu)[2]
        note(f"  phase 4, small step against the CPU, draw of seed "
             f"{draw_seed} (not gated): all gradients {all_rel:.3e} in "
             f"relative L2, flownetc {by_net['flownetc']:.3e}, "
             f"flownets_1 {by_net['flownets_1']:.3e}")
    del grads_k, grads_s, grads_c, cpu_model, g_card, g_cpu, draw_img, \
        draw_tgt

    # F3: torch's bilinear upsample backward accumulates with atomic adds on
    # the card, so two backward passes over one forward gave flownetc's and
    # flownets_1's gradients other bits; the port's upsample has a fixed
    # backward (ops/upsample.py).  The capture of torch's alerts is tried on
    # an op that it names (torch.histc of floats), so that "names no op"
    # below cannot pass for a capture that sees nothing.
    histc_gen = torch.Generator(device=dev).manual_seed(23)
    histc_named = nondeterministic_ops(lambda: torch.histc(
        torch.rand(1000, generator=histc_gen, device=dev)))
    print(f"  the capture of torch's alerts names {histc_named} for "
          "torch.histc")
    if "_histc_cuda" not in histc_named:
        raise AssertionError("the capture of torch's nondeterminism alerts "
                             f"did not name torch.histc's op: {histc_named}")

    def interpolate_upsample(x, scale=4):
        """torch's own bilinear upsample, forward and backward."""
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=False)

    def backward_twice(net):
        """One forward of phase 4's batch and two backward passes over it:
        the sub-nets whose gradients are not the same bits in both."""
        net.train()
        net.zero_grad(set_to_none=True)
        lossvalue = loss_fn(net(images), target)[0]
        lossvalue.backward(retain_graph=True)
        first = {n: p.grad.clone() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        lossvalue.backward()
        differ = sorted({n.split(".")[0] for n, p in net.named_parameters()
                         if not torch.equal(p.grad, first[n])})
        net.zero_grad(set_to_none=True)
        return differ

    def deterministic_step(net, phase: str):
        """On each warp route, with cuDNN deterministic: two backward passes
        over one shared forward give the same bits in every sub-net, and one
        step under torch.use_deterministic_algorithms names no op; printed
        beside them, the same two readings with torch's own upsample
        backward in place of the port's."""
        torch.backends.cudnn.deterministic = True
        for route in ROUTES:
            with mock.patch.object(stage_glue, "TRAIN_WARP", route):
                differ = backward_twice(net)
                ops_named = nondeterministic_ops(
                    lambda: loss_and_grads(net, images, target))
                with mock.patch.object(flownet2_module, "upsample_bilinear",
                                       interpolate_upsample):
                    torch_differ = backward_twice(net)
                    torch_named = nondeterministic_ops(
                        lambda: loss_and_grads(net, images, target))
            note(f"  phase {phase}, {route} route, cuDNN deterministic: two "
                 "backward passes over one forward differ in "
                 f"{differ or 'no sub-net'}, a step under deterministic "
                 f"algorithms names {ops_named or 'no op'}; with torch's "
                 f"upsample backward: {torch_differ or 'no sub-net'}, "
                 f"{torch_named or 'no op'}")
            if differ or ops_named:
                raise AssertionError(
                    f"phase {phase}, {route} route: the step is not "
                    f"deterministic: {differ} differ, {ops_named} named")
            if "flownetc" not in torch_differ:
                raise AssertionError(
                    f"phase {phase}, {route} route: with torch's upsample "
                    "backward two backward passes did not differ in "
                    f"flownetc ({torch_differ}): the check did not show "
                    "that it sees the atomics it checks for")
        torch.backends.cudnn.deterministic = False

    deterministic_step(tmodel, "4")

    def timed_routes(step, phase: str, suffix: str = "", shards: int = 1):
        """TRAIN_WARMUP warm-up and TRAIN_STEPS timed steps of ``step`` on
        phase 4's batch per warp route, in turns, each route's launches
        counted over its first timed block and held to the exact counts
        (kernel names ending in ``suffix``; with ``shards`` row bands each
        kernel launched once a band, the correlation's K7 forms); prints
        ms/step and frames/s.  Returns the times by route, the launches by
        route and the peak memory in GiB."""
        route_ms = {route: [] for route in ROUTES}
        route_launches = {}
        torch.cuda.reset_peak_memory_stats()
        for route in (ROUTES + ROUTES[::-1]) * ROUTE_ROUNDS:
            with mock.patch.object(stage_glue, "TRAIN_WARP", route), \
                    sharding_hints.scoped_spatial_shards(shards):
                for _ in range(TRAIN_WARMUP):
                    step(images, target)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                ops.reset_counts()
                start.record()
                metrics = [step(images, target) for _ in range(TRAIN_STEPS)]
                end.record()
                torch.cuda.synchronize()
            route_ms[route].append(start.elapsed_time(end) / TRAIN_STEPS)
            route_launches.setdefault(route, (dict(ops.LAUNCHES),
                                              dict(ops.PLAIN_CALLS)))
            losses = torch.stack([torch.stack([m["loss"], m["epe"]])
                                  for m in metrics])
            if not torch.isfinite(losses).all():
                raise AssertionError(f"{route}: non-finite loss/EPE {losses}")
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        n = TRAIN_STEPS * shards
        rows = "_rows" if shards > 1 else ""
        each = {f"correlation_{k}{rows}": n
                for k in ("fwd", "bwd_f1", "bwd_f2")}
        want_launches = {
            "tangents": dict(each, resample2d_tangents=2 * n,
                             resample2d_tangents_multi=n),
            "grad_flow": dict(each, resample2d_fwd=2 * n,
                              resample2d_fwd_multi=n,
                              resample2d_grad_flow=2 * n,
                              resample2d_grad_flow_multi=n)}
        for route in ROUTES:
            got, plain = route_launches[route]
            want = {k + suffix: v for k, v in want_launches[route].items()}
            print(f"  {route} route, launches over {TRAIN_STEPS} steps: "
                  f"{got}; plain-op calls: {plain}")
            if got != want or plain:
                raise AssertionError(f"{route} route launches {got} / plain "
                                     f"calls {plain}; expected {want} / {{}}")
        for route in ROUTES:
            times = route_ms[route]
            mean = sum(times) / len(times)
            note(f"  phase {phase}, {route} route: {mean:.3f} ms/step "
                 f"({', '.join(f'{t:.3f}' for t in times)}), "
                 f"{TRAIN_BATCH / mean * 1e3:.2f} frames/s  [{smi}]")
        print(f"  last loss {metrics[-1]['loss'].item():.6f}, EPE "
              f"{metrics[-1]['epe'].item():.6f}; peak {peak_gib:.2f} GiB "
              f"allocated")
        return route_ms, route_launches, peak_gib

    step = StepFactory(tmodel, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    route_ms, route_launches, _ = timed_routes(step, "4")
    train_launches = route_launches[stage_glue.TRAIN_WARP][0]

    # -- 4b. FlowNet2 bf16 training -------------------------------------------
    print(f"phase 4b: FlowNet2 bf16 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
          f"{TRAIN_WIDTH} (float32 master weights, bf16 convolutions, glue "
          "and warps), MultiScale, Adam 1e-4")
    # what the earlier phases leave allocated (phase 4's fp32 model,
    # gradients and Adam moments among them), so that the bf16 step's own
    # peak can be read apart
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)

    def bf16_grads(net, imgs, tgt, what):
        """loss_and_grads of the bf16 model, every gradient float32 and
        finite."""
        out = loss_and_grads(net, imgs, tgt)
        bad = [n for n, g in out[2].items()
               if g.dtype != torch.float32 or not torch.isfinite(g).all()]
        if bad:
            raise AssertionError(f"{what}: gradients not float32 and finite: "
                                 f"{bad[:5]}")
        return out

    # The bf16 gradient is held per sub-net: two bf16 forwards that differ
    # in the last bit put flownetc and flownets_1 on the noise line (a bf16
    # flow of 16-32 px has an ulp of 0.125; the warps' flow gradient jumps
    # where a sample point crosses an integer), so those two are printed
    # beside the JAX package's own bf16-against-f32 reading (1.20, 1.45 on
    # the CPU, tests/test_torch_bf16_train.py) and held only below 1.0.
    # With the forward shared every sub-net is held at 5e-2.
    torch.backends.cudnn.deterministic = True
    loss_16, epe_16, grads_16 = bf16_grads(model16, images, target,
                                           "bf16 step")
    print(f"  first step: loss {loss_16:.6f}, EPE {epe_16:.6f}")
    for route in ROUTES:
        with mock.patch.object(stage_glue, "TRAIN_WARP", route):
            loss_r, _, grads_r = (
                (loss_16, epe_16, grads_16)
                if route == stage_glue.TRAIN_WARP
                else bf16_grads(model16, images, target, f"bf16 {route}"))
            with plain_ops(backward_kernels):
                ops.reset_counts()
                loss_b, _, grads_b = bf16_grads(model16, images, target,
                                                "bf16 plain backward")
                if any(k.startswith(("correlation_bwd",
                                     "resample2d_grad_flow"))
                       for k in ops.LAUNCHES):
                    raise AssertionError(f"plain backward launched "
                                         f"{dict(ops.LAUNCHES)}")
        if loss_b != loss_r:
            raise AssertionError(f"bf16 {route}: the forward is not shared "
                                 f"(loss {loss_r} against {loss_b})")
        subnets_close(grads_r, grads_b, {}, f"bf16 {route} route, backward "
                      "kernels against the plain backward (loss bit-equal)")
        if route != stage_glue.TRAIN_WARP:
            subnets_close(grads_r, grads_16, {}, f"bf16 {route} route "
                          f"against the {stage_glue.TRAIN_WARP} route")
    del grads_r, grads_b
    with plain_ops():
        ops.reset_counts()
        loss_p, epe_p, grads_p = bf16_grads(model16, images, target,
                                            "bf16 plain-op step")
        if sum(ops.LAUNCHES.values()):
            raise AssertionError(f"plain-op step launched {ops.LAUNCHES}")
    torch.backends.cudnn.deterministic = False
    noise_line = {"flownetc": None, "flownets_1": None}
    for a, b, what in ((loss_16, loss_p, "loss"), (epe_16, epe_p, "EPE")):
        note(f"  phase 4b, {what}: kernels {a:.6f}, plain-op model {b:.6f}")
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"bf16 {what}: kernels {a} vs plain ops {b}")
    subnets_close(grads_16, grads_p, noise_line,
                  "bf16 kernel model against the plain-op bf16 model")
    del grads_p

    small16 = get_model("FlowNet2", device="cpu", seed=0,
                        dtype=torch.bfloat16)
    loss_s, epe_s, grads_s = bf16_grads(model16, small_img, small_tgt,
                                        "bf16 small step")
    loss_c, epe_c, grads_c = bf16_grads(small16, small_img.cpu(),
                                        small_tgt.cpu(), "bf16 CPU step")
    print(f"  small step: loss {loss_s:.6f} / EPE {epe_s:.6f} on the card, "
          f"{loss_c:.6f} / {epe_c:.6f} on the CPU")
    for a, b, what in ((loss_s, loss_c, "small loss"),
                       (epe_s, epe_c, "small EPE")):
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"bf16 {what}: card {a} vs CPU {b}")
    subnets_close(grads_s, grads_c, noise_line,
                  "bf16 small step against the CPU")
    del grads_16, grads_s, grads_c, small16
    deterministic_step(model16, "4b, bf16")

    step16 = StepFactory(model16, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    route16_ms, route16_launches, peak16_train_gib = timed_routes(
        step16, "4b, bf16", "_bf16")
    note(f"  phase 4b, bf16 step: peak {peak16_train_gib:.2f} GiB allocated, "
         f"{peak16_train_gib - base_gib:.2f} GiB above the {base_gib:.2f} "
         f"GiB the earlier phases leave allocated  [{smi}]")
    # how far the host holds the card back: the host's time to enqueue a
    # step against the card's time for one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step16(images, target)
    host16_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    torch.cuda.synchronize()
    note(f"  the host enqueues a bf16 step in {host16_ms:.3f} ms, the card "
         f"runs one in {min(route16_ms['grad_flow']):.3f} ms (grad_flow "
         "route, CUDA events above)")
    # phase 5 runs as it did before phase 4b: no second model beside it
    del model16, step16
    torch.cuda.empty_cache()

    # -- 5. the row-band path ---------------------------------------------------
    print(f"phase 5: {SHARDS} row bands (K7 and the local-rows K2, K3, K4), "
          "fp32, TF32 off")

    def per_run(counts: dict, runs: int) -> dict:
        return {k: v / runs for k, v in counts.items()}

    def check_counts(what, runs, want):
        got, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        print(f"  {what}, launches over {runs} runs: {got}; plain-op calls: "
              f"{plain}")
        if per_run(got, runs) != want or plain:
            raise AssertionError(f"{what}: launches per run "
                                 f"{per_run(got, runs)} / plain calls {plain};"
                                 f" expected {want} / {{}}")
        return got

    def check_dispatch(what):
        log = sharding_hints.dispatch_log()
        print(f"  {what}, dispatch: {log}")
        if (f"bands(spatial={SHARDS})+halo-slab, kernel=cuda-rows"
                != log.get("correlation")
                or f"bands(spatial={SHARDS})+halo-gather, kernel=cuda-rows"
                != log.get("resample2d")):
            raise AssertionError(f"{what}: not the row-band compositions")

    band_fwd = {"correlation_fwd_rows": SHARDS, "resample2d_fwd": 2 * SHARDS,
                "resample2d_fwd_multi": SHARDS}
    band_step = dict(band_fwd, correlation_bwd_f1_rows=SHARDS,
                     correlation_bwd_f2_rows=SHARDS,
                     resample2d_grad_flow=2 * SHARDS,
                     resample2d_grad_flow_multi=SHARDS)
    with torch.inference_mode():
        # cuDNN's default forward algorithms differ from run to run in the
        # last bits, so the two models are compared with deterministic ones
        noise = (model(pairs[0]) - model(pairs[0])).abs().max().item()
        torch.backends.cudnn.deterministic = True
        flow_whole = model(pairs[0])
        with sharding_hints.scoped_spatial_shards(SHARDS):
            sharding_hints.clear_dispatch_log()
            flow_bands = model(pairs[0])
            check_dispatch("FlowNet2 inference")
        torch.backends.cudnn.deterministic = False
        with sharding_hints.scoped_spatial_shards(SHARDS):
            model(pairs[0])
            ops.reset_counts()
            bands_ms = time_ms(lambda: model(pairs[0]), TIMED_BATCHES,
                               warmup=0)
            band_fwd_launches = check_counts("FlowNet2 inference",
                                             TIMED_BATCHES, band_fwd)
        whole_ms = time_ms(lambda: model(pairs[0]), TIMED_BATCHES, warmup=1)
    err = (flow_bands - flow_whole).abs().max().item()
    print(f"  FlowNet2 b{BATCH} {HEIGHT}x{WIDTH}: {bands_ms:.3f} ms/batch under "
          f"{SHARDS} bands, whole-map {whole_ms:.3f} ms/batch now and "
          f"{ms:.3f} in phase 3  [{smi}]")
    print(f"  {SHARDS} bands against the whole-map model, cuDNN deterministic: "
          f"max abs diff {err:.3e}, bit-equal: "
          f"{torch.equal(flow_bands, flow_whole)}; the whole-map model against "
          f"itself with cuDNN's default algorithms: {noise:.3e}")
    if not torch.allclose(flow_bands, flow_whole, rtol=0, atol=1e-5):
        raise AssertionError("the row-band model disagrees with the "
                             "whole-map model")
    del flow_whole, flow_bands

    torch.backends.cudnn.deterministic = True
    loss_w, _, grads_w = loss_and_grads(tmodel, images, target)
    with sharding_hints.scoped_spatial_shards(SHARDS):
        sharding_hints.clear_dispatch_log()
        ops.reset_counts()
        loss_b, epe_b, grads_b = loss_and_grads(tmodel, images, target)
        check_counts("FlowNet2 loss and gradients", 1, band_step)
        check_dispatch("FlowNet2 train step")
    torch.backends.cudnn.deterministic = False
    print(f"  train step under {SHARDS} bands: loss {loss_b:.6f}, EPE "
          f"{epe_b:.6f}; whole-map loss {loss_w:.6f}")
    if not abs(loss_b - loss_w) <= 1e-4 * abs(loss_w):
        raise AssertionError(f"loss: {SHARDS} bands {loss_b} vs whole-map "
                             f"{loss_w}")
    grads_close(grads_b, grads_w, 1e-3, f"{SHARDS} bands against the "
                "whole-map step", per_tensor=False)
    del grads_w, grads_b
    metrics = []
    with sharding_hints.scoped_spatial_shards(SHARDS):
        for _ in range(TRAIN_WARMUP):
            step(images, target)
        ops.reset_counts()
        bands_step_ms = time_ms(
            lambda: metrics.append(step(images, target)), TRAIN_STEPS,
            warmup=0)
        band_step_launches = check_counts("FlowNet2 train step", TRAIN_STEPS,
                                          band_step)
    whole_step_ms = time_ms(lambda: step(images, target), TRAIN_STEPS,
                            warmup=1)
    if not all(torch.isfinite(m["loss"]) and torch.isfinite(m["epe"])
               for m in metrics):
        raise AssertionError(f"{SHARDS} bands: non-finite loss or EPE")
    phase4_ms = sum(route_ms[stage_glue.TRAIN_WARP]) / len(
        route_ms[stage_glue.TRAIN_WARP])
    print(f"  FlowNet2 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x{TRAIN_WIDTH}: "
          f"{bands_step_ms:.3f} ms/step under {SHARDS} bands, whole-map "
          f"{whole_step_ms:.3f} ms/step now and {phase4_ms:.3f} in phase 4  "
          f"[{smi}]")

    cmodel = get_model("FlowNet2C", device=DEVICE, seed=1)
    c_target = torch.rand((BATCH, HEIGHT, WIDTH, 2), generator=band_gen,
                          device=dev) * 5.0
    with torch.inference_mode():
        c_flow = cmodel(pairs[0])
        ops.reset_counts()
        c_ms = time_ms(lambda: cmodel(pairs[0]), TIMED_BATCHES, warmup=0)
        check_counts("FlowNet2C inference, whole map", TIMED_BATCHES,
                     {"correlation_fwd": 1})
    if c_flow.shape != (BATCH, HEIGHT, WIDTH, 2) \
            or not torch.isfinite(c_flow).all():
        raise AssertionError(f"bad FlowNet2C flow: {tuple(c_flow.shape)}")
    print(f"  FlowNet2C b{BATCH} {HEIGHT}x{WIDTH}: {c_ms:.3f} ms/batch  "
          f"[{smi}]")
    c_step = StepFactory(cmodel, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    with sharding_hints.scoped_spatial_shards(SHARDS):
        with plain_ops():
            ops.reset_counts()
            c_loss_p = loss_and_grads(cmodel, pairs[0], c_target)[0]
            if sum(ops.LAUNCHES.values()):
                raise AssertionError(f"plain-op FlowNet2C launched "
                                     f"{ops.LAUNCHES}")
        ops.reset_counts()
        c_metrics = c_step(pairs[0], c_target)
        torch.cuda.synchronize()
        check_counts("FlowNet2C train step", 1, {
            name: SHARDS for name in (
                "correlation_fwd_rows", "correlation_bwd_f1_rows",
                "correlation_bwd_f2_rows")})
    c_loss, c_epe = c_metrics["loss"].item(), c_metrics["epe"].item()
    print(f"  FlowNet2C train step under {SHARDS} bands, MultiScale: loss "
          f"{c_loss:.6f}, EPE {c_epe:.6f}; plain-op model's loss "
          f"{c_loss_p:.6f}")
    if not (math.isfinite(c_loss) and math.isfinite(c_epe)):
        raise AssertionError("FlowNet2C: non-finite loss or EPE")
    if not abs(c_loss - c_loss_p) <= 1e-4 * abs(c_loss_p):
        raise AssertionError(f"FlowNet2C loss: kernels {c_loss} vs plain ops "
                             f"{c_loss_p}")
    del cmodel, c_step

    # -- 5b. the row-band path in bf16 ----------------------------------------
    print(f"phase 5b: {SHARDS} row bands in bf16 (K7 bf16 and the bf16 "
          "local-rows K2, K3, K4)")
    # the bf16 model of the same weights, built again and freed after, as in
    # phases 3b and 4b
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)
    band16_fwd = {f"{k}_bf16": v for k, v in band_fwd.items()}
    band16_step = {f"{k}_bf16": v for k, v in band_step.items()}
    fwd16_ms = {1: [], SHARDS: []}
    with torch.inference_mode():
        for pair in pairs:
            model16(pair)
        # whole map and bands in turns, 10 timed batches each
        for shards in (1, SHARDS, SHARDS, 1):
            with sharding_hints.scoped_spatial_shards(shards):
                model16(pairs[0])
                sharding_hints.clear_dispatch_log()
                ops.reset_counts()
                fwd16_ms[shards].append(time_ms(lambda: model16(pairs[0]),
                                                TIMED_BATCHES, warmup=0))
                if shards > 1:
                    band16_fwd_launches = check_counts(
                        "FlowNet2 bf16 inference", TIMED_BATCHES, band16_fwd)
                    check_dispatch("FlowNet2 bf16 inference")
    whole16, bands16 = (sum(fwd16_ms[k]) / 2 for k in (1, SHARDS))
    note(f"  phase 5b, bf16 inference b{BATCH} {HEIGHT}x{WIDTH}: "
         f"{bands16:.3f} ms/batch under {SHARDS} bands "
         f"({', '.join(f'{t:.3f}' for t in fwd16_ms[SHARDS])}), "
         f"{BATCH / bands16 * 1e3:.2f} frames/s; whole map {whole16:.3f} "
         f"({', '.join(f'{t:.3f}' for t in fwd16_ms[1])}) in turns, "
         f"{ms16:.3f} in phase 3b  [{smi}]")

    # one step whole and under bands, cuDNN deterministic: the forwards are
    # the same bits, so the gradients differ by d_f2's halo sums only
    torch.backends.cudnn.deterministic = True
    loss_w, epe_w, grads_w = bf16_grads(model16, images, target,
                                        "bf16 whole-map step")
    with sharding_hints.scoped_spatial_shards(SHARDS):
        sharding_hints.clear_dispatch_log()
        ops.reset_counts()
        loss_b, epe_b, grads_b = bf16_grads(model16, images, target,
                                            "bf16 band step")
        check_counts("FlowNet2 bf16 loss and gradients", 1, band16_step)
        check_dispatch("FlowNet2 bf16 train step")
    torch.backends.cudnn.deterministic = False
    for a, b, what in ((loss_b, loss_w, "loss"), (epe_b, epe_w, "EPE")):
        note(f"  phase 5b, bf16 {what}: {SHARDS} bands {a:.6f}, whole map "
             f"{b:.6f}, bit-equal {a == b}")
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"bf16 {what}: {SHARDS} bands {a} vs whole "
                                 f"map {b}")
    subnets_close(grads_b, grads_w, noise_line, f"bf16 step under {SHARDS} "
                  "bands against the whole map, cuDNN deterministic")
    del grads_w, grads_b

    step16 = StepFactory(model16, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    whole16_step_ms = timed_routes(step16, "5b, bf16, whole map", "_bf16")[0]
    bands16_step_ms, band16_launches, peak16_bands_gib = timed_routes(
        step16, f"5b, bf16, {SHARDS} bands", "_bf16", SHARDS)
    for route in ROUTES:
        a, b = (sum(t[route]) / len(t[route])
                for t in (bands16_step_ms, whole16_step_ms))
        note(f"  phase 5b, bf16 step, {route} route: {a:.3f} ms/step under "
             f"{SHARDS} bands, {b:.3f} whole map ({a - b:+.3f} ms); peak "
             f"{peak16_bands_gib:.2f} GiB allocated under bands  [{smi}]")
    del model16, step16
    torch.cuda.empty_cache()

    # -- 6. kernel times ------------------------------------------------------
    print("phase 6: kernel times at the main-path shapes")
    rows = []
    with torch.no_grad():
        b, c, h, w = BATCH, 256, HEIGHT // 8, WIDTH // 8
        f1, f2 = randn(b, c, h, w), randn(b, c, h, w)
        k1_bytes = 4 * (2 * b * c * h * w + b * disp * disp * h * w)
        k1_flops = corr_flops(b, c, h, w)
        rows.append(("correlation_fwd", "correlation_pallas.py:83",
                     "correlation_fwd.cu",
                     lambda: corr.correlation_cuda(f1, f2, *corr_args),
                     lambda: corr.correlation_plain(f1, f2, *corr_args),
                     None, k1_bytes, k1_flops))

        b, h, w, ch = BATCH, HEIGHT, WIDTH, 3
        xs = torch.arange(w, device=dev).view(1, 1, -1)
        ys = torch.arange(h, device=dev).view(1, -1, 1)

        def grid_of(fl, xs=xs, ys=ys, h=h, w=w):
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

        # the training shapes: K5/K6 at FlowNetC's (8, 256, 48, 56), K3/K4
        # at (8, 3, 384, 448) with +-8 px flows
        b, c, h, w = TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8
        tf1, tf2 = randn(b, c, h, w), randn(b, c, h, w)
        tg = randn(b, disp * disp, h, w)
        bwd_bytes = 4 * (2 * b * c * h * w + b * disp * disp * h * w)
        bwd_flops = corr_flops(b, c, h, w)
        for name, needs, replaces in (
                ("correlation_bwd_f1", (True, False),
                 "correlation_pallas.py:449"),
                ("correlation_bwd_f2", (False, True),
                 "correlation_pallas.py:478")):
            rows.append((name, replaces, "correlation_bwd.cu",
                         (lambda needs=needs: corr.correlation_bwd_cuda(
                             tg, tf1, tf2, 20, 2, needs=needs)),
                         (lambda needs=needs: corr.correlation_bwd_plain(
                             tg, tf1, tf2, 20, 2, needs=needs)),
                         None, bwd_bytes, bwd_flops))

        b, h, w, ch = TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 3
        one, two = t_flows[:, :1].contiguous(), t_flows
        # per output pixel ~10 flops of coordinates and weights, then 17 per
        # channel (7 for out, 5 each for d1 and d2)
        for name, fl in (("resample2d_tangents", one),
                         ("resample2d_tangents_multi", two)):
            nflows = fl.shape[1]
            rows.append((name, "resample2d_pallas.py:262",
                         "resample2d_tangents.cu",
                         (lambda fl=fl: r2d.resample2d_tangents_cuda(t_img,
                                                                     fl)),
                         (lambda fl=fl: r2d.resample2d_tangents_plain(t_img,
                                                                      fl)),
                         None, 4 * b * h * w * (ch + nflows * (2 + 3 * ch)),
                         b * nflows * h * w * (10 + 17 * ch)))
        tg4 = randn(b, 1, ch, h, w)
        grid = grid_of(one[:, 0], xs=torch.arange(w, device=dev).view(1, 1, -1),
                       ys=torch.arange(h, device=dev).view(1, -1, 1), h=h, w=w)
        with torch.enable_grad():
            grid_leaf = grid.clone().requires_grad_()
            sampled = F.grid_sample(t_img, grid_leaf, mode="bilinear",
                                    padding_mode="border", align_corners=True)
        # the same function as one library call: grid_sample's backward for
        # the grid (its gradient times (W-1)/2 and (H-1)/2 is d_flow)
        rows.append(("resample2d_grad_flow", "resample2d_pallas.py:312",
                     "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4, t_img, one),
                     lambda: r2d.resample2d_grad_flow_plain(tg4, t_img, one),
                     lambda: torch.autograd.grad(sampled, grid_leaf, tg4[:, 0],
                                                 retain_graph=True),
                     4 * b * h * w * (2 * ch + 2 + 2),
                     b * h * w * (10 + 12 * ch)))
        # the two-flow K4 (+-8 px and +-200 px, K3's two-flow input) and,
        # as one library call, grid_sample's grid gradient over the image
        # taken once for each flow
        tg4_2 = randn(b, 2, ch, h, w, gen=tile_gen)
        t_img2 = t_img.repeat(2, 1, 1, 1)  # flow-major, as the grids
        with torch.enable_grad():
            grid_leaf2 = torch.cat([
                grid_of(two[:, k], xs=torch.arange(w, device=dev).view(
                    1, 1, -1), ys=torch.arange(h, device=dev).view(1, -1, 1),
                    h=h, w=w) for k in range(2)]).requires_grad_()
            sampled2 = F.grid_sample(t_img2, grid_leaf2, mode="bilinear",
                                     padding_mode="border",
                                     align_corners=True)
        g_by_flow = tg4_2.transpose(0, 1).reshape(2 * b, ch, h, w)
        rows.append(("resample2d_grad_flow_multi", "resample2d_pallas.py:312",
                     "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_2, t_img, two),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_2, t_img, two),
                     lambda: torch.autograd.grad(sampled2, grid_leaf2,
                                                 g_by_flow, retain_graph=True),
                     4 * b * h * w * (ch + 2 * (ch + 2 + 2)),
                     2 * b * h * w * (10 + 12 * ch)))

        def k7_rows(dtype=torch.float32):
            """K7's rows at one band of SHARDS: the forward at the inference
            map, the backward at the training map; d_slab does the same
            multiply-adds as d_f1 and writes the taller slab."""
            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            for base, replaces, src, (b, c, h, w) in (
                    ("correlation_fwd_rows", "correlation_pallas.py:615",
                     "correlation_fwd.cu",
                     (BATCH, 256, HEIGHT // 8, WIDTH // 8)),
                    ("correlation_bwd_f1_rows", "correlation_pallas.py:528",
                     "correlation_bwd.cu",
                     (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8)),
                    ("correlation_bwd_f2_rows", "correlation_pallas.py:528",
                     "correlation_bwd.cu",
                     (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8,
                      TRAIN_WIDTH // 8))):
                h //= SHARDS
                sf1, sslab = (randn(b, c, h, w).to(dtype),
                              randn(b, c, h + 40, w).to(dtype))
                sg = randn(b, disp * disp, h, w).to(dtype)
                sizes = {"correlation_fwd_rows": (sf1, sslab, sg),
                         "correlation_bwd_f1_rows": (sg, sslab, sf1),
                         "correlation_bwd_f2_rows": (sg, sf1, sslab)}[base]
                if base == "correlation_fwd_rows":
                    fn = lambda sf1=sf1, sslab=sslab: corr_sp.corr_slab_cuda(
                        sf1, sslab, 20, 2)
                    plain = (lambda sf1=sf1, sslab=sslab:
                             corr_sp.corr_slab_plain(sf1, sslab, 20, 2))
                else:
                    needs = (base == "correlation_bwd_f1_rows",
                             base == "correlation_bwd_f2_rows")
                    fn = (lambda sf1=sf1, sslab=sslab, sg=sg, needs=needs:
                          corr_sp.corr_slab_bwd_cuda(sg, sf1, sslab, 20, 2,
                                                     needs=needs))
                    plain = (lambda sf1=sf1, sslab=sslab, sg=sg, needs=needs:
                             corr_sp.corr_slab_bwd_plain(sg, sf1, sslab, 20,
                                                         2, needs=needs))
                rows.append((base + suffix, replaces, src, fn, plain, None,
                             sum(t.numel() * t.element_size() for t in sizes),
                             corr_flops(b, c, h, w, slab=True)))

        k7_rows()

        # the bf16 forms at the bf16 path's shapes, 2 bytes a value; the
        # operations at the card's rate for bf16 (its tensor cores), the
        # warps' also at the f32 rate that their bodies, which upcast and
        # sum in f32, can reach (bound_ms_f32_body; the correlation runs on
        # the tensor cores).  No library
        # call: F.grid_sample wants its grid in the image's dtype, and a bf16
        # grid moves the sample point 2-4 px at 512 columns
        b, c, h, w = BATCH, 256, HEIGHT // 8, WIDTH // 8
        f1_16 = randn(b, c, h, w).bfloat16()
        f2_16 = randn(b, c, h, w).bfloat16()
        rows.append(("correlation_fwd_bf16", "correlation_pallas.py:83",
                     "correlation_fwd.cu",
                     lambda: corr.correlation_cuda(f1_16, f2_16, *corr_args),
                     lambda: corr.correlation_plain(f1_16, f2_16, *corr_args),
                     None, k1_bytes // 2, k1_flops))
        b, h, w, ch = BATCH, HEIGHT, WIDTH, 3
        img16, flow16, flows16 = (t.bfloat16() for t in (img, flow8, flows))
        for name, nflows, fn, plain in (
                ("resample2d_fwd_bf16", 1,
                 lambda: r2d.resample2d_cuda(img16, flow16),
                 lambda: r2d.resample2d_plain(img16, flow16)),
                ("resample2d_fwd_multi_bf16", 2,
                 lambda: r2d.resample2d_multi_cuda(img16, flows16),
                 lambda: r2d.resample2d_multi_plain(img16, flows16))):
            rows.append((name, "resample2d_pallas.py:239", "resample2d_fwd.cu",
                         fn, plain, None,
                         2 * b * h * w * (ch + nflows * (2 + ch)),
                         b * nflows * h * w * (10 + 7 * ch)))
        # the bf16 training kernels at the bf16 step's shapes: K5 and K6
        # (tensor-core bodies) at (8, 256, 48, 56), K3 and K4 at
        # (8, 3, 384, 448) with +-8 px flows; K3's d1 and d2 are float32
        b, c, h, w = TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8
        tf1_16, tf2_16, tg_16 = (t.bfloat16() for t in (tf1, tf2, tg))
        for name, needs, replaces in (
                ("correlation_bwd_f1_bf16", (True, False),
                 "correlation_pallas.py:449"),
                ("correlation_bwd_f2_bf16", (False, True),
                 "correlation_pallas.py:478")):
            rows.append((name, replaces, "correlation_bwd.cu",
                         (lambda needs=needs: corr.correlation_bwd_cuda(
                             tg_16, tf1_16, tf2_16, 20, 2, needs=needs)),
                         (lambda needs=needs: corr.correlation_bwd_plain(
                             tg_16, tf1_16, tf2_16, 20, 2, needs=needs)),
                         None, bwd_bytes // 2, bwd_flops))
        b, h, w, ch = TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 3
        t_img16 = t_img.bfloat16()
        one16, two16 = one.bfloat16(), two.bfloat16()
        for name, fl in (("resample2d_tangents_bf16", one16),
                         ("resample2d_tangents_multi_bf16", two16)):
            nflows = fl.shape[1]
            rows.append((name, "resample2d_pallas.py:262",
                         "resample2d_tangents.cu",
                         (lambda fl=fl: r2d.resample2d_tangents_cuda(t_img16,
                                                                     fl)),
                         (lambda fl=fl: r2d.resample2d_tangents_plain(t_img16,
                                                                      fl)),
                         None,
                         2 * b * h * w * ch
                         + b * nflows * h * w * (2 * 2 + 2 * ch + 8 * ch),
                         b * nflows * h * w * (10 + 17 * ch)))
        tg4_16 = tg4.bfloat16()
        rows.append(("resample2d_grad_flow_bf16", "resample2d_pallas.py:312",
                     "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_16, t_img16,
                                                           one16),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_16, t_img16,
                                                            one16),
                     None, 2 * b * h * w * (2 * ch + 2 + 2),
                     b * h * w * (10 + 12 * ch)))
        tg4_2_16 = tg4_2.bfloat16()
        rows.append(("resample2d_grad_flow_multi_bf16",
                     "resample2d_pallas.py:312", "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_2_16, t_img16,
                                                           two16),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_2_16, t_img16,
                                                            two16),
                     None, 2 * b * h * w * (ch + 2 * (ch + 2 + 2)),
                     2 * b * h * w * (10 + 12 * ch)))
        # K7 bf16 (tensor-core bodies) at one band of the bf16 forward's and
        # the bf16 step's maps
        k7_rows(torch.bfloat16)

        kernels = []
        for name, replaces, src, fn, plain, lib, nbytes, flops in rows:
            k_ms = time_ms(fn, 50, head_start=True)
            p_ms = time_ms(plain, 5)
            l_ms = (time_ms(lib, 50, head_start=True) if lib is not None
                    else None)
            bf16 = name.endswith("_bf16")
            b_ms, b_by = bound_ms(nbytes, flops, peaks, tensor_cores=bf16)
            say = note if bf16 else print
            say(f"  {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP)  [{smi}; SM clock, max: "
                f"{sm_clock()}]")
            if name in K3_BEFORE_MS:
                note(f"  {name}: {k_ms:.4f} ms, {b_ms / k_ms:.0%} of its "
                     f"bound [{K3_BEFORE_MS[name]:.4f} ms, "
                     f"{b_ms / K3_BEFORE_MS[name]:.0%}, before the row tiles]"
                     f"  [{smi}]")
            extra = {}
            if bf16 and not name.startswith("correlation"):
                extra["bound_ms_f32_body"] = bound_ms(nbytes, flops, peaks)[0]
            step16_k = route16_launches[
                "tangents" if "tangents" in name else "grad_flow"][0]
            if name in launches:      # over the phase 3 forwards
                count = launches[name]
            elif name in launches16:  # over the phase 3b forwards
                count = launches16[name]
            elif name == "correlation_fwd_rows_bf16":  # phase 5b forwards
                count = band16_fwd_launches[name]
            elif name.endswith("_rows_bf16"):      # per phase 5b step
                count = band16_launches["grad_flow"][0][name] / TRAIN_STEPS
            elif bf16:                # per phase 4b step
                count = step16_k[name] / TRAIN_STEPS
            elif name == "correlation_fwd_rows":   # over the phase 5 forwards
                count = band_fwd_launches[name]
            elif name.endswith("_rows"):           # per phase 5 train step
                count = band_step_launches[name] / TRAIN_STEPS
            elif name.startswith("resample2d_tangents"):
                count = route_launches["tangents"][0][name] / TRAIN_STEPS
            else:                      # per step of the default route
                count = train_launches[name] / TRAIN_STEPS
            if name.endswith("_rows_bf16"):
                fwd = name == "correlation_fwd_rows_bf16"
                note(f"  {name}: library none; "
                     f"{count / TIMED_BATCHES if fwd else count:g} launches "
                     f"a phase 5b {'forward' if fwd else 'step'}")
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"flownet2_tpu_torch/csrc/{src}",
                "replaces": f"flownet2_tpu/ops/{replaces}",
                "launches": count, "max_abs_err": max(errs[name]),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms, **extra})
        del sampled, grid_leaf, sampled2, grid_leaf2
        by_name = {k["name"]: k for k in kernels}

        # K2, K3 and K4 at the smooth flow the stage glue makes (+-8 px at
        # (H/4, W/4), bilinear x4), one and two flows, f32 and bf16, beside
        # the noise flows timed above
        for dtype in (torch.float32, torch.bfloat16):
            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            im, t_im = img.to(dtype), t_img.to(dtype)
            for nflows in (1, 2):
                fl = smooth_flows(BATCH, nflows, HEIGHT, WIDTH).to(dtype)
                t_fl = smooth_flows(TRAIN_BATCH, nflows, TRAIN_HEIGHT,
                                    TRAIN_WIDTH).to(dtype)
                t_g = randn(TRAIN_BATCH, nflows, 3, TRAIN_HEIGHT,
                            TRAIN_WIDTH, gen=tile_gen).to(dtype)
                for base, fn in (
                        ("resample2d_fwd", lambda im=im, fl=fl:
                         r2d.resample2d_multi_cuda(im, fl)),
                        ("resample2d_grad_flow",
                         lambda t_g=t_g, t_im=t_im, t_fl=t_fl:
                         r2d.resample2d_grad_flow_cuda(t_g, t_im, t_fl)),
                        ("resample2d_tangents", lambda t_im=t_im, t_fl=t_fl:
                         r2d.resample2d_tangents_cuda(t_im, t_fl))):
                    name = r2d._per_flow(base, nflows) + suffix
                    note(f"  {name} at the smooth flow: "
                         f"{time_ms(fn, 50, head_start=True):.4f} ms (at the "
                         f"noise flow {by_name[name]['ms']:.4f})  [{smi}]")

        # cold L2: the one-flow K2 and K4 and their library calls, each call
        # on input buffers of its own, COLD_SETS sets of them in turn
        cold = {"K2": [], "grid_sample": [], "K4": [], "grid_sample grad": []}
        for _ in range(COLD_SETS):
            im = randn(BATCH, 3, HEIGHT, WIDTH)
            fl = uniform(BATCH, 2, HEIGHT, WIDTH, scale=8.0)
            gr = grid_of(fl)
            cold["K2"].append(lambda im=im, fl=fl: r2d.resample2d_cuda(im, fl))
            cold["grid_sample"].append(lambda im=im, gr=gr: F.grid_sample(
                im, gr, mode="bilinear", padding_mode="border",
                align_corners=True))
            th, tw = TRAIN_HEIGHT, TRAIN_WIDTH
            im = randn(TRAIN_BATCH, 3, th, tw)
            fl = uniform(TRAIN_BATCH, 1, 2, th, tw, scale=8.0)
            gt = randn(TRAIN_BATCH, 1, 3, th, tw)
            cold["K4"].append(lambda im=im, fl=fl, gt=gt:
                              r2d.resample2d_grad_flow_cuda(gt, im, fl))
            with torch.enable_grad():
                leaf = grid_of(fl[:, 0], xs=torch.arange(tw, device=dev).view(
                    1, 1, -1), ys=torch.arange(th, device=dev).view(1, -1, 1),
                    h=th, w=tw).requires_grad_()
                out = F.grid_sample(im, leaf, mode="bilinear",
                                    padding_mode="border", align_corners=True)
            cold["grid_sample grad"].append(
                lambda out=out, leaf=leaf, gt=gt: torch.autograd.grad(
                    out, leaf, gt[:, 0], retain_graph=True))
        k2, k4 = by_name["resample2d_fwd"], by_name["resample2d_grad_flow"]
        warm = {"K2": k2["ms"], "grid_sample": k2["library_ms"],
                "K4": k4["ms"], "grid_sample grad": k4["library_ms"]}
        for what, fns in cold.items():
            print(f"  cold L2, {what} (one flow, {COLD_SETS} input sets in "
                  f"turn): {cold_ms(fns, 60):.4f} ms, warm {warm[what]:.4f} "
                  f"ms  [{smi}; SM clock, max: {sm_clock()}]")
        del cold

    # -- 7. where the device time goes --------------------------------------
    print(f"phase 7: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} fp32, "
          f"{PROFILED_FORWARDS} forwards under torch.profiler")
    with torch.inference_mode():
        model(pairs[0])

        def forwards():
            for _ in range(PROFILED_FORWARDS):
                model(pairs[0])

        by_kernel = profile_families(forwards, PROFILED_FORWARDS, FAMILIES,
                                     smi, "batch")[0]
        # which convolution kernels cuDNN's default algorithms run, and which
        # of them a deterministic cuDNN does not (the one forward that
        # differs from run to run, phase 5)
        torch.backends.cudnn.deterministic = True
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(pairs[0])
            torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        deterministic = {ev.key for ev in prof.key_averages()
                         if ev.device_type == torch.autograd.DeviceType.CUDA}
        print("  convolution kernels of the forward, cuDNN's defaults "
              "('*': not run with cudnn.deterministic):")
        for key, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
            if CONV.search(key):
                mark = " " if key in deterministic else "*"
                print(f"   {mark}{us / 1e3 / PROFILED_FORWARDS:9.3f} ms/batch"
                      f"  {key[:160]}")
        for key in sorted(deterministic - set(by_kernel)):
            if CONV.search(key):
                print(f"    only with cudnn.deterministic: {key[:160]}")
    note(f"  phase 7, FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} bf16, "
         f"{PROFILED_FORWARDS} forwards under torch.profiler")
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)
    with torch.inference_mode():
        model16(pairs[0])

        def forwards16():
            for _ in range(PROFILED_FORWARDS):
                model16(pairs[0])

        by_kernel16, counts16 = profile_families(
            forwards16, PROFILED_FORWARDS, BF16_FAMILIES, smi, "batch",
            say=note)
    layout = BF16_FAMILIES[2][1]
    n_layout = sum(n for key, n in counts16.items()
                   if layout.search(key)) / PROFILED_FORWARDS
    note(f"  phase 7, bf16 forward: {n_layout:g} layout-conversion launches "
         "a forward")
    print("  the "
          "convolution and layout-conversion kernels of the bf16 forward "
          "(launches a forward):")
    for key, us in sorted(by_kernel16.items(), key=lambda kv: -kv[1]):
        if layout.search(key) or CONV.search(key):
            print(f"    {us / 1e3 / PROFILED_FORWARDS:9.3f} ms/batch "
                  f"{counts16[key] / PROFILED_FORWARDS:6g}x  {key[:150]}")
    print(f"  FlowNet2 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x{TRAIN_WIDTH}, "
          f"{PROFILED_STEPS} steps under torch.profiler "
          f"({stage_glue.TRAIN_WARP} route)")
    step(images, target)

    def steps(step=step):
        for _ in range(PROFILED_STEPS):
            step(images, target)

    profile_families(steps, PROFILED_STEPS, TRAIN_FAMILIES, smi, "step")

    def k3_per_step(step, families, dtype):
        """K3's device time a step on the tangent route, from a profile of
        PROFILED_STEPS steps."""
        with mock.patch.object(stage_glue, "TRAIN_WARP", "tangents"):
            step(images, target)
            print(f"  {dtype} train step, {PROFILED_STEPS} steps on the "
                  "tangent route under torch.profiler")
            by_kernel, counts = profile_families(
                lambda: steps(step), PROFILED_STEPS, families, smi, "step")
        k3 = [k for k in by_kernel if "resample2d_tangents" in k]
        note(f"  phase 7, {dtype} step, tangent route: K3 "
             f"{sum(by_kernel[k] for k in k3) / 1e3 / PROFILED_STEPS:.3f} "
             f"ms a step in {sum(counts[k] for k in k3) / PROFILED_STEPS:g} "
             f"launches  [{smi}]")

    k3_per_step(step, TRAIN_FAMILIES, "fp32")

    def upsample_backward_per_step(step, dtype):
        """The bilinear upsample's backward a step, the port's and torch's:
        the device time and kernel launches under the autograd engine's
        range of its node, in a profile of PROFILED_STEPS steps."""
        def under(ev):
            return (len(ev.kernels)
                    + sum(under(child) for child in ev.cpu_children))

        readings = []
        for what, patch in (
                ("the port's", contextlib.nullcontext()),
                ("torch's", mock.patch.object(
                    flownet2_module, "upsample_bilinear",
                    interpolate_upsample))):
            with patch:
                step(images, target)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    steps(step)
                    torch.cuda.synchronize()
            nodes = [ev for ev in prof.events()
                     if ev.name.startswith("autograd::engine::evaluate_"
                                           "function")
                     and "UpsampleBilinear" in ev.name]
            node_ms = sum(ev.device_time_total for ev in nodes) / 1e3
            readings.append(
                f"{what} {node_ms / PROFILED_STEPS:.3f} "
                f"ms in {len(nodes) / PROFILED_STEPS:g} calls, "
                f"{sum(under(ev) for ev in nodes) / PROFILED_STEPS:g} "
                "launches")
        note(f"  phase 7, {dtype} step, {stage_glue.TRAIN_WARP} route: the "
             f"bilinear upsample's backward a step: {'; '.join(readings)}  "
             f"[{smi}]")

    upsample_backward_per_step(step, "fp32")
    note(f"  phase 7, FlowNet2 bf16 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
         f"{TRAIN_WIDTH}, {PROFILED_STEPS} steps under torch.profiler "
         f"({stage_glue.TRAIN_WARP} route)")
    step16 = StepFactory(model16, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    step16(images, target)
    step_counts16 = profile_families(
        lambda: steps(step16), PROFILED_STEPS, BF16_TRAIN_FAMILIES, smi,
        "step", say=note)[1]
    n_layout = sum(n for key, n in step_counts16.items()
                   if layout.search(key)) / PROFILED_STEPS
    note(f"  phase 7, bf16 step: {n_layout:g} layout-conversion launches a "
         "step")
    k3_per_step(step16, BF16_TRAIN_FAMILIES, "bf16")
    upsample_backward_per_step(step16, "bf16")

    # -- 8. result ------------------------------------------------------------
    print("summary of the timed phases:")
    for line in SUMMARY:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
