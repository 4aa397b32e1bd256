#!/usr/bin/env python3
"""Time the port's whole-map kernels of one checkout on one CUDA card.

    python3 kernel_ab.py <checkout root> <tag>

Builds the kernels of ``<root>/flownet2_tpu_torch`` and prints one line:
the tag, the milliseconds per launch of K1 at (8, 256, 48, 64), of K7
forward at one band of two, (8, 256, 24, 64) against its (8, 256, 64, 64)
slab, of K5 and K6 at (8, 256, 48, 56), of K7 d_f1 and K7 d_slab at one
band of two, (8, 441, 24, 56) against its (8, 256, 64, 56) slab, of the
two-flow and the one-flow K2 at (8, 3, 384, 512), of ``F.grid_sample``
on the one-flow K2's inputs (the library call that computes the same warp;
timed here, used nowhere in the port), of the one-flow and the two-flow K3
and K4 at (8, 3, 384, 448), float32, and the bf16 forms of K5, K6, K3,
K4, K7 (forward, d_f1, d_slab), K1 and the one-flow and two-flow K2 on
the same inputs rounded to bf16, and the fp16 forms of K1, K7 forward,
K5, K6, K7 d_f1 and K7 d_slab on those inputs rounded to fp16 ("n/a" for
a checkout that has no form of a kernel in that dtype: its wrapper raises
TypeError), CUDA events over 300 launches after 20 that the host queues
while the card is kept busy (and,
for the one-flow K2, also without that head start: a 0.04 ms kernel then
reads as the wrapper's time on the host), the first 12 hex digits of the
sha1 of the output bytes of K1, K7 forward, K5, K7 d_f1, K6, K7 d_slab,
the one-flow and the two-flow K2, K3 (its three outputs) and K4 (the
twelve float32 digests), then of the bf16 K5, K6, K3, K4, K7, K1 and K2
and the fp16 K1, K7 forward, K5, K6, K7 d_f1 and K7 d_slab (the inputs
come from a fixed seed, so two checkouts that print the same digest
computed the same bits), the SM clock and its maximum as nvidia-smi
reads them after the timings, and ptxas's register counts (none for
libraries an earlier run in that checkout has built), those of the warp
bodies (K2's, K3's and K4's instantiations) with their spills.  Drawn
after every input above, so that the digests above stay comparable with
those of older checkouts, three more flows time and digest the one-flow
and two-flow K2 (at (8, 3, 384, 512)), K3 and K4 (at (8, 3, 384, 448)),
float32 and bf16: a zero flow (every gather in the pixel's own sector),
the smooth flow of the stage glue (+-8 px at (H/4, W/4), bilinear x4) and
+-200 px.
It keeps the outputs of the bf16 kernels that run a tensor-core body (K1,
K7 forward, K5, K7 d_f1, K6 and K7 d_slab) and of their fp16 forms in
``build/kernel_ab/<tag>.pt`` under the working
directory and prints, on a second line, the share of their values that
differ from those a run of another tag kept there, over the kernels that
both runs kept (a run of an older checkout kept fewer).

Two commits are compared on one card in one call, in turns, since two calls
may land on two cards: unpack the parent with ``git archive <commit>
flownet2_tpu_torch | tar -x -C build/parent`` and run

    python3 kernel_ab.py build/parent parent; python3 kernel_ab.py . change
    python3 kernel_ab.py . change; python3 kernel_ab.py build/parent parent
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def time_ms(fn, iters: int = 300, warmup: int = 20,
            head_start: bool = True) -> float:
    """Milliseconds of device time per call of ``fn``.  With ``head_start``
    the card first spins for some 30 ms, so that the host has queued the
    launches before the card reaches them and the events read the kernels
    back to back; without it a kernel shorter than its wrapper's time on
    the host reads as the host's launch rate."""
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


def sm_clock() -> str:
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(root: str, tag: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import correlation_spatial as corr_sp
    from flownet2_tpu_torch.ops import resample2d as r2d

    logs = _cuda.build()
    registers = [line.split("Used ")[1].split(",")[0]
                 for name in sorted(logs) for line in logs[name].splitlines()
                 if "registers" in line]
    # the warp bodies (K2, K3, K4): each instantiation's registers and
    # spills
    warp_bodies = []
    for name in ("resample2d_fwd", "resample2d_tangents",
                 "resample2d_grad_flow"):
        body = spill = ""
        for line in logs[name].splitlines():
            if "Compiling entry function" in line:
                body = line.split("'")[1].split("_kernel")[-1].split(
                    "EEEv")[0]
            elif "spill stores" in line:
                spill = line.split(",")[1].strip().split(" ")[0]
            elif "registers" in line:
                warp_bodies.append(
                    f"{name}{body} {line.split('Used ')[1].split(' ')[0]} "
                    f"registers, {spill} bytes spilled")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def digest(*ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    f1, f2 = randn(8, 256, 48, 64), randn(8, 256, 48, 64)
    sf1, slab = randn(8, 256, 24, 64), randn(8, 256, 64, 64)
    tf1, tf2 = randn(8, 256, 48, 56), randn(8, 256, 48, 56)
    tg = randn(8, 441, 48, 56)
    bg, bslab = randn(8, 441, 24, 56), randn(8, 256, 64, 56)
    bf1 = tf1[:, :, :24].contiguous()
    img = randn(8, 3, 384, 512)
    flows = randn(8, 2, 2, 384, 512) * 4.0
    flow = flows[:, 0].contiguous()
    xs = torch.arange(512, device=dev).view(1, 1, -1)
    ys = torch.arange(384, device=dev).view(1, -1, 1)
    grid = torch.stack([(xs + flow[:, 0]) * (2.0 / 511) - 1.0,
                        (ys + flow[:, 1]) * (2.0 / 383) - 1.0], dim=-1)
    # the training shape of K3 and K4, drawn after every other input
    t_img = randn(8, 3, 384, 448)
    t_flows = randn(8, 2, 2, 384, 448) * 4.0
    t_flow = t_flows[:, :1].contiguous()
    t_g, t_g2 = randn(8, 1, 3, 384, 448), randn(8, 2, 3, 384, 448)

    # K2, K3 and K4 at three more flows, drawn after every input above so
    # that the digests above stay comparable with those of older checkouts:
    # a zero flow (every gather in the pixel's own sector), the smooth flow
    # of the stage glue (+-8 px at (H/4, W/4), bilinear x4) and +-200 px;
    # two flows at K2's and at K3's and K4's shape each, the one-flow forms
    # on the first
    def uniform(*shape, scale):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    def smooth(b, nflows, _, h, w):
        coarse = uniform(b * nflows, 2, h // 4, w // 4, scale=8.0)
        return F.interpolate(coarse, scale_factor=4, mode="bilinear",
                             align_corners=False).reshape(b, nflows, 2, h, w)

    more_flows = {}
    for kind in ("zero", "smooth", "200 px"):
        more_flows[kind] = [
            torch.zeros(shape, device=dev) if kind == "zero"
            else smooth(*shape) if kind == "smooth"
            else uniform(*shape, scale=200.0)
            for shape in ((8, 2, 2, 384, 512), (8, 2, 2, 384, 448))]
    def if_present(fn):
        """``fn()``'s result, or None where the checkout has no form of the
        kernel in that dtype."""
        try:
            return fn()
        except TypeError:
            return None

    tg16, tf1_16, tf2_16 = tg.bfloat16(), tf1.bfloat16(), tf2.bfloat16()
    t_img16, t_flow16, t_flows16 = (t.bfloat16() for t in (t_img, t_flow,
                                                            t_flows))
    t_g16, t_g2_16 = t_g.bfloat16(), t_g2.bfloat16()
    sf1_16, slab16 = sf1.bfloat16(), slab.bfloat16()
    f1_16, f2_16 = f1.bfloat16(), f2.bfloat16()
    img16, flow16, flows16 = (t.bfloat16() for t in (img, flow, flows))
    bg16, bf1_16, bslab16 = bg.bfloat16(), bf1.bfloat16(), bslab.bfloat16()
    bf16_kernels = {
        "K5 bf16": lambda: corr.correlation_bwd_cuda(
            tg16, tf1_16, tf2_16, needs=(True, False))[0],
        "K6 bf16": lambda: corr.correlation_bwd_cuda(
            tg16, tf1_16, tf2_16, needs=(False, True))[1],
        "K3 bf16, one flow": lambda: r2d.resample2d_tangents_cuda(
            t_img16, t_flow16),
        "K3 bf16, two flows": lambda: r2d.resample2d_tangents_cuda(
            t_img16, t_flows16),
        "K4 bf16, one flow": lambda: r2d.resample2d_grad_flow_cuda(
            t_g16, t_img16, t_flow16),
        "K4 bf16, two flows": lambda: r2d.resample2d_grad_flow_cuda(
            t_g2_16, t_img16, t_flows16),
        "K7 fwd bf16": lambda: corr_sp.corr_slab_cuda(sf1_16, slab16),
        "K7 d_f1 bf16": lambda: corr_sp.corr_slab_bwd_cuda(
            bg16, bf1_16, bslab16, needs=(True, False))[0],
        "K7 d_slab bf16": lambda: corr_sp.corr_slab_bwd_cuda(
            bg16, bf1_16, bslab16, needs=(False, True))[1],
        "K1 bf16": lambda: corr.correlation_cuda(f1_16, f2_16),
        "K2 bf16, one flow": lambda: r2d.resample2d_cuda(img16, flow16),
        "K2 bf16, two flows": lambda: r2d.resample2d_multi_cuda(img16,
                                                                flows16)}
    # the fp16 forms of the correlation, whose bodies are shared with
    # bf16's at maxd 20, s2 2, on the same inputs rounded to fp16 (no new
    # draws)
    f1_h, f2_h, sf1_h, slab_h = (t.half() for t in (f1, f2, sf1, slab))
    tg_h, tf1_h, tf2_h = tg.half(), tf1.half(), tf2.half()
    bg_h, bf1_h, bslab_h = bg.half(), bf1.half(), bslab.half()
    fp16_kernels = {
        "K1 fp16": lambda: corr.correlation_cuda(f1_h, f2_h),
        "K7 fwd fp16": lambda: corr_sp.corr_slab_cuda(sf1_h, slab_h),
        "K5 fp16": lambda: corr.correlation_bwd_cuda(
            tg_h, tf1_h, tf2_h, needs=(True, False))[0],
        "K6 fp16": lambda: corr.correlation_bwd_cuda(
            tg_h, tf1_h, tf2_h, needs=(False, True))[1],
        "K7 d_f1 fp16": lambda: corr_sp.corr_slab_bwd_cuda(
            bg_h, bf1_h, bslab_h, needs=(True, False))[0],
        "K7 d_slab fp16": lambda: corr_sp.corr_slab_bwd_cuda(
            bg_h, bf1_h, bslab_h, needs=(False, True))[1]}
    low_kernels = {**bf16_kernels, **fp16_kernels}
    times = {
        "K1": time_ms(lambda: corr.correlation_cuda(f1, f2)),
        "K7 fwd": time_ms(lambda: corr_sp.corr_slab_cuda(sf1, slab)),
        "K5": time_ms(lambda: corr.correlation_bwd_cuda(
            tg, tf1, tf2, needs=(True, False))),
        "K7 d_f1": time_ms(lambda: corr_sp.corr_slab_bwd_cuda(
            bg, bf1, bslab, needs=(True, False))),
        "K6": time_ms(lambda: corr.correlation_bwd_cuda(
            tg, tf1, tf2, needs=(False, True))),
        "K7 d_slab": time_ms(lambda: corr_sp.corr_slab_bwd_cuda(
            bg, bf1, bslab, needs=(False, True))),
        "K2, two flows": time_ms(lambda: r2d.resample2d_multi_cuda(img,
                                                                   flows)),
        "K2, one flow": time_ms(lambda: r2d.resample2d_cuda(img, flow)),
        "K2, one flow, no head start": time_ms(
            lambda: r2d.resample2d_cuda(img, flow), head_start=False),
        "grid_sample, one flow": time_ms(lambda: F.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)),
        "K3, one flow": time_ms(lambda: r2d.resample2d_tangents_cuda(
            t_img, t_flow)),
        "K3, two flows": time_ms(lambda: r2d.resample2d_tangents_cuda(
            t_img, t_flows)),
        "K4, one flow": time_ms(lambda: r2d.resample2d_grad_flow_cuda(
            t_g, t_img, t_flow)),
        "K4, two flows": time_ms(lambda: r2d.resample2d_grad_flow_cuda(
            t_g2, t_img, t_flows)),
    }
    # the warps at the three more flows, f32 and bf16
    more_kernels = {}
    for kind, (k2_fl, k4_fl) in more_flows.items():
        for sfx, cast in (("", lambda t: t), (" bf16", lambda t: t.bfloat16())):
            im, fl2, t_im, fl4 = (cast(t) for t in (img, k2_fl, t_img, k4_fl))
            fl1, fl4_1 = fl2[:, :1].contiguous(), fl4[:, :1].contiguous()
            g1, g2 = cast(t_g), cast(t_g2)
            more_kernels.update({
                f"K2{sfx}, one flow, {kind}": (
                    lambda im=im, fl=fl1: r2d.resample2d_multi_cuda(im, fl)),
                f"K2{sfx}, two flows, {kind}": (
                    lambda im=im, fl=fl2: r2d.resample2d_multi_cuda(im, fl)),
                f"K4{sfx}, one flow, {kind}": (
                    lambda g=g1, im=t_im, fl=fl4_1:
                    r2d.resample2d_grad_flow_cuda(g, im, fl)),
                f"K4{sfx}, two flows, {kind}": (
                    lambda g=g2, im=t_im, fl=fl4:
                    r2d.resample2d_grad_flow_cuda(g, im, fl)),
                f"K3{sfx}, one flow, {kind}": (
                    lambda im=t_im, fl=fl4_1:
                    r2d.resample2d_tangents_cuda(im, fl)),
                f"K3{sfx}, two flows, {kind}": (
                    lambda im=t_im, fl=fl4:
                    r2d.resample2d_tangents_cuda(im, fl))})
    for name, fn in {**bf16_kernels, **more_kernels, **fp16_kernels}.items():
        times[name] = (time_ms(fn) if if_present(fn) is not None
                       else float("nan"))
    clock = sm_clock()
    digests = {"K1": digest(corr.correlation_cuda(f1, f2)),
               "K7 fwd": digest(corr_sp.corr_slab_cuda(sf1, slab)),
               "K5": digest(corr.correlation_bwd_cuda(
                   tg, tf1, tf2, needs=(True, False))[0]),
               "K7 d_f1": digest(corr_sp.corr_slab_bwd_cuda(
                   bg, bf1, bslab, needs=(True, False))[0]),
               "K6": digest(corr.correlation_bwd_cuda(
                   tg, tf1, tf2, needs=(False, True))[1]),
               "K7 d_slab": digest(corr_sp.corr_slab_bwd_cuda(
                   bg, bf1, bslab, needs=(False, True))[1]),
               "K2": digest(r2d.resample2d_cuda(img, flow)),
               "K2 two flows": digest(r2d.resample2d_multi_cuda(img, flows)),
               "K3": digest(*r2d.resample2d_tangents_cuda(t_img, t_flow)),
               "K3 two flows": digest(*r2d.resample2d_tangents_cuda(
                   t_img, t_flows)),
               "K4": digest(r2d.resample2d_grad_flow_cuda(t_g, t_img,
                                                          t_flow)),
               "K4 two flows": digest(r2d.resample2d_grad_flow_cuda(
                   t_g2, t_img, t_flows))}
    for name, fn in {**bf16_kernels, **more_kernels, **fp16_kernels}.items():
        out = if_present(fn)
        digests[name] = ("n/a" if out is None else digest(
            *(t.float() for t in (out if isinstance(out, tuple)
                                  else (out,)))))
    print(tag, "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
          "| sha1:", ", ".join(f"{k} {v}" for k, v in digests.items()),
          "| SM clock, max:", clock,
          "| registers:", ", ".join(registers),
          "| warp bodies:", "; ".join(warp_bodies))
    # the outputs of the bf16 tensor-core bodies and of the fp16 forms
    # that share them against those of runs of other tags
    kept = {name: if_present(low_kernels[name])
            for name in ("K1 bf16", "K7 fwd bf16", "K5 bf16", "K7 d_f1 bf16",
                         "K6 bf16", "K7 d_slab bf16", *fp16_kernels)}
    kept = {k: v for k, v in kept.items() if v is not None}
    if kept:
        store = Path("build") / "kernel_ab"
        store.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in kept.items()}, store / f"{tag}.pt")
        for other in sorted(store.glob("*.pt")):
            if other.stem == tag:
                continue
            theirs = torch.load(other)
            print(tag, f"against {other.stem}: not bit-equal", ", ".join(
                f"{k} {(v.cpu() != theirs[k]).float().mean().item():.4%}"
                for k, v in kept.items() if k in theirs))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
