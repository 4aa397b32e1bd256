"""Convert a released FlowNet2 ``.caffemodel`` into a native checkpoint of
the port.

    python -m flownet2_tpu_torch.checkpoints.convert \
        FlowNet2_weights.caffemodel ./ckpts [--model FlowNet2] [--tag T]

The model is ``--model``, or else it is read off the release's directory
name (``FlowNet2-CS/``, as the download script lays the files out).  The
checkpoint, ``<out_dir>/<tag>`` (tag ``<model>-caffe`` by default), holds
the weights alone, with epoch 0: it serves inference
(``python -m flownet2_tpu_torch.cli --inference --resume <out_dir>/<tag>``),
not a training resume, which needs an optimizer's state.  The conversion
runs on the CPU.  One JSON line ``{"arch", "params", "checkpoint"}`` goes
to the standard output, the seconds to parse and to save to the standard
error; the exit code is 2 when the model cannot be inferred.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("caffemodel", help="path to the released .caffemodel")
    ap.add_argument("out_dir", help="directory to write the checkpoint into")
    ap.add_argument("--model", default=None,
                    help="model name; when omitted it is inferred from the "
                         "release DIRECTORY layout (a parent directory "
                         "named e.g. FlowNet2-CS/, as the download script "
                         "creates) — pass --model for a bare file")
    ap.add_argument("--tag", default=None,
                    help="checkpoint tag (default: <model>-caffe)")
    args = ap.parse_args(argv)

    from .caffe_import import load_caffe_checkpoint, model_name_from_path
    from .native import save_checkpoint
    from ..models import get_model

    name = args.model or model_name_from_path(args.caffemodel)
    if name is None:
        print("cannot infer the model from the filename; pass --model",
              file=sys.stderr)
        return 2
    model = get_model(name, device="cpu")
    t0 = time.perf_counter()
    meta = load_caffe_checkpoint(args.caffemodel, model, name)
    t1 = time.perf_counter()
    tag = args.tag or f"{name}-caffe"
    path = save_checkpoint(args.out_dir, model, None, epoch=0,
                           best_epe=meta["best_EPE"], tag=tag)
    t2 = time.perf_counter()
    n = sum(p.numel() for p in model.state_dict().values())
    print(f"convert: {os.path.getsize(args.caffemodel)} bytes parsed and "
          f"loaded in {t1 - t0:.3f} s, saved in {t2 - t1:.3f} s",
          file=sys.stderr)
    print(json.dumps({"arch": name, "params": int(n), "checkpoint": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
