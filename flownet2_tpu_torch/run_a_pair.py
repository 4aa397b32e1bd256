"""Single-pair demo of the port: run FlowNet2 on two frames, save .flo.

  python -m flownet2_tpu_torch.run_a_pair img0.png img1.png \
      [--checkpoint FlowNet2_checkpoint.pth.tar] [--out flow.flo] \
      [--viz flow.png] [--device cpu]

The device defaults to the CUDA device.  Frames are centre-cropped to
multiples of 64.  Without --checkpoint the weights are the reference's
random init (seed 0).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .checkpoints import load_checkpoint
from .data import flow_to_image, read_gen, write_flo
from .models import get_model


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("img0")
    p.add_argument("img1")
    p.add_argument("--checkpoint", default="",
                   help="reference FlowNet2 .pth.tar; random init if omitted")
    p.add_argument("--out", default="out.flo")
    p.add_argument("--viz", default="", help="also save a colour-wheel PNG")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    im0 = read_gen(args.img0).astype(np.float32)
    im1 = read_gen(args.img1).astype(np.float32)
    h, w = im0.shape[:2]
    h64, w64 = (h // 64) * 64, (w // 64) * 64
    if (h64, w64) != (h, w):
        print(f"center-cropping {h}x{w} -> {h64}x{w64} (inputs must be /64)")
        y0, x0 = (h - h64) // 2, (w - w64) // 2
        im0 = im0[y0:y0 + h64, x0:x0 + w64]
        im1 = im1[y0:y0 + h64, x0:x0 + w64]

    model = get_model("FlowNet2", device=args.device)
    if args.checkpoint:
        meta = load_checkpoint(args.checkpoint, model)
        print(f"loaded checkpoint: {meta}")
    else:
        print("WARNING: random init (no --checkpoint)")

    device = next(model.parameters()).device
    pair = torch.from_numpy(np.stack([im0, im1])[None]).to(device)
    with torch.inference_mode():
        flow = model(pair)[0].cpu().numpy()
    write_flo(args.out, flow)
    print(f"wrote {args.out} ({flow.shape[1]}x{flow.shape[0]}, "
          f"max |flow| = {np.abs(flow).max():.2f})")
    if args.viz:
        from PIL import Image
        Image.fromarray(flow_to_image(flow)).save(args.viz)
        print(f"wrote {args.viz}")
    return flow


if __name__ == "__main__":
    main()
