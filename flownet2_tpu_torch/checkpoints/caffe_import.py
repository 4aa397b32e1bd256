"""Weights of the released ``.caffemodel`` files into the port: the port's
copy of flownet2_tpu/checkpoints/caffe_import.py.

The caffemodel's protobuf wire format is read directly (no caffe, no
protoc), and its layers are mapped by name onto the reference's state_dict
keys, which the port's modules carry, with the reference converter's
(``param_utils``) semantics:

- caffe Convolution weights are (Cout, Cin, kh, kw) and Deconvolution
  weights (Cin, Cout, kh, kw): torch's Conv2d and ConvTranspose2d layouts,
  copied as they are;
- BGR -> RGB: the caffe models were trained on BGR frames, so the first
  convolution of each sub-net has the input channels of each 3-channel
  image group reversed (``_BGR``);
- the layer-name tables keep the release's quirks: the stacked FlowNetS
  upsample layers carry a doubled prefix (``net2_net2_...``), their torch
  modules have no bias (the caffe bias is dropped), and Fusion's predict
  layers are ``_Convolution5..7``.

``load_caffe_checkpoint(path, model)`` loads the weights into a port model
with ``strict=True``.  Where the JAX package converts the state dict into
Flax variables, the port loads it as it is.  ``checkpoints/convert.py``
writes the result as a native checkpoint.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader (enough for NetParameter).
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    """BlobProto: packed float data (field 5) + shape (field 7 BlobShape, or
    legacy num/channels/height/width fields 1-4)."""
    data_chunks: List[np.ndarray] = []
    dims: List[int] = []
    legacy = [None, None, None, None]
    for field, wt, val in _fields(buf):
        if field == 5:  # data
            if wt == 2:  # packed
                data_chunks.append(np.frombuffer(bytes(val), "<f4"))
            else:  # unpacked single float
                data_chunks.append(np.frombuffer(bytes(val), "<f4"))
        elif field == 7 and wt == 2:  # shape: BlobShape {repeated int64 dim=1}
            for f2, wt2, v2 in _fields(val):
                if f2 == 1:
                    if wt2 == 2:  # packed varints
                        p = 0
                        mv = memoryview(v2)
                        while p < len(mv):
                            d, p = _read_varint(mv, p)
                            dims.append(d)
                    else:
                        dims.append(v2)
        elif field in (1, 2, 3, 4) and wt == 0:  # legacy N,C,H,W
            legacy[field - 1] = val
        elif field == 8 and wt == 2:  # double_data
            data_chunks.append(
                np.frombuffer(bytes(val), "<f8").astype(np.float32))
    data = (np.concatenate(data_chunks) if data_chunks
            else np.zeros((0,), np.float32))
    if not dims and any(v is not None for v in legacy):
        dims = [v if v is not None else 1 for v in legacy]
    if dims and int(np.prod(dims)) == data.size:
        data = data.reshape(dims)
    return data


def _parse_layer(buf: memoryview, v1: bool) -> Tuple[str, List[np.ndarray]]:
    """LayerParameter (name=1, blobs=7) or V1LayerParameter (name=4, blobs=6)."""
    name_field = 4 if v1 else 1
    blob_field = 6 if v1 else 7
    name = ""
    blobs: List[np.ndarray] = []
    for field, wt, val in _fields(buf):
        if field == name_field and wt == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == blob_field and wt == 2:
            blobs.append(_parse_blob(val))
    return name, blobs


def read_caffemodel(path: str | pathlib.Path) -> Dict[str, List[np.ndarray]]:
    """Parse a .caffemodel (NetParameter) into {layer_name: [blobs...]}.

    Handles both the modern ``layer`` (field 100) and legacy ``layers``
    (field 2, V1LayerParameter) encodings; layers without blobs are skipped.
    """
    raw = pathlib.Path(path).read_bytes()
    out: Dict[str, List[np.ndarray]] = {}
    for field, wt, val in _fields(memoryview(raw)):
        if wt != 2 or field not in (2, 100):
            continue
        name, blobs = _parse_layer(val, v1=(field == 2))
        if name and blobs:
            out[name] = blobs
    if not out:
        raise ValueError(f"{path}: no parameter-carrying layers found")
    return out


# ---------------------------------------------------------------------------
# Layer-name tables (caffe layer -> torch-style module path).
# ---------------------------------------------------------------------------

_C_CONVS = ["conv1", "conv2", "conv3", "conv_redir", "conv3_1", "conv4",
            "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"]
_S_CONVS = ["conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1",
            "conv5", "conv5_1", "conv6", "conv6_1"]
_SD_CONVS = ["conv0", "conv1", "conv1_1", "conv2", "conv2_1", "conv3",
             "conv3_1", "conv4", "conv4_1", "conv5", "conv5_1", "conv6",
             "conv6_1"]
_DECONVS = ["deconv5", "deconv4", "deconv3", "deconv2"]
_UPS = [("upsample_flow6to5", "upsampled_flow6_to_5"),
        ("upsample_flow5to4", "upsampled_flow5_to_4"),
        ("upsample_flow4to3", "upsampled_flow4_to_3"),
        ("upsample_flow3to2", "upsampled_flow3_to_2")]
_PREDICTS = [("Convolution1", "predict_flow6"), ("Convolution2", "predict_flow5"),
             ("Convolution3", "predict_flow4"), ("Convolution4", "predict_flow3"),
             ("Convolution5", "predict_flow2")]


# Torch-module key styles (third column of _net_table rows):
SEQ = "seq"                    # conv()/i_conv()/deconv() Sequential: key
                               # carries a ".0" index (submodules.py:7-38)
BARE = "bare"                  # bare module name, has a bias parameter
BARE_NO_BIAS = "bare_no_bias"  # bare name, torch module has bias=False
                               # (FlowNetS upsample deconvs,
                               # FlowNetS.py:42-45; param_utils skips the
                               # caffe bias via `m.bias is not None`,
                               # param_utils.py:95-100)


def _net_table(kind: str, caffe_prefix: str) -> List[Tuple[str, str, str]]:
    """[(caffe_key, torch_module, style)] for one sub-network."""
    p = caffe_prefix
    t: List[Tuple[str, str, str]] = []
    if kind == "C":
        t += [(p + k, k, SEQ) for k in _C_CONVS]
        t += [(p + k, k, SEQ) for k in _DECONVS]
        t += [(p + ck, m, BARE) for ck, m in _PREDICTS]
        t += [(p + p + ck, m, BARE) for ck, m in _UPS]
    elif kind == "S":  # stacked FlowNetS (predict_conv* keys)
        t += [(p + k, k, SEQ) for k in _S_CONVS]
        t += [(p + k, k, SEQ) for k in _DECONVS]
        t += [(p + f"predict_conv{i}", f"predict_flow{i}", BARE)
              for i in (6, 5, 4, 3, 2)]
        t += [(p + p + ck, m, BARE_NO_BIAS) for ck, m in _UPS]
    elif kind == "S_only":  # standalone FlowNet2-S (Convolution* keys)
        t += [(p + k, k, SEQ) for k in _S_CONVS]
        t += [(p + k, k, SEQ) for k in _DECONVS]
        t += [(p + ck, m, BARE) for ck, m in _PREDICTS]
        t += [(p + p + ck, m, BARE_NO_BIAS) for ck, m in _UPS]
    elif kind == "SD":
        t += [(p + k, k, SEQ) for k in _SD_CONVS]
        t += [(p + k, k, SEQ) for k in _DECONVS]
        t += [(p + f"interconv{i}", f"inter_conv{i}", SEQ)
              for i in (5, 4, 3, 2)]
        t += [(p + ck, m, BARE) for ck, m in _PREDICTS]
        t += [(p + ck, m, BARE) for ck, m in _UPS]
    elif kind == "Fusion":
        t += [(p + k, k, SEQ)
              for k in ("conv0", "conv1", "conv1_1", "conv2", "conv2_1")]
        t += [(p + k, k, SEQ) for k in ("deconv1", "deconv0")]
        t += [(p + f"interconv{i}", f"inter_conv{i}", SEQ) for i in (1, 0)]
        t += [(p + "_Convolution5", "predict_flow2", BARE),
              (p + "_Convolution6", "predict_flow1", BARE),
              (p + "_Convolution7", "predict_flow0", BARE)]
        t += [(p + "upsample_flow2to1", "upsampled_flow2_to_1", BARE),
              (p + "upsample_flow1to0", "upsampled_flow1_to_0", BARE)]
    else:
        raise ValueError(kind)
    return t


# (first conv torch-module, channel groups to BGR-flip) per net kind
_BGR = {
    "C": ("conv1", [(0, 3)]),              # param_utils.py:42 (full flip = one 3-ch group)
    "S": ("conv1", [(0, 3), (3, 6), (6, 9)]),   # param_utils.py:91-94
    "S_only": ("conv1", [(0, 3), (3, 6)]),      # param_utils.py:145-146
    "SD": ("conv0", [(0, 3), (3, 6)]),          # param_utils.py:202-203
    "Fusion": ("conv0", [(0, 3)]),              # param_utils.py:244-245
}

# model name -> [(subnet_kind, caffe_prefix, torch_subnet_prefix)]
_MODEL_NETS = {
    "FlowNet2": [("C", "", "flownetc."), ("S", "net2_", "flownets_1."),
                 ("S", "net3_", "flownets_2."), ("SD", "netsd_", "flownets_d."),
                 ("Fusion", "fuse_", "flownetfusion.")],
    "FlowNet2C": [("C", "", "")],
    "FlowNet2CS": [("C", "", "flownetc."), ("S", "net2_", "flownets_1.")],
    "FlowNet2CSS": [("C", "", "flownetc."), ("S", "net2_", "flownets_1."),
                    ("S", "net3_", "flownets_2.")],
    "FlowNet2S": [("S_only", "", "")],
    "FlowNet2SD": [("SD", "", "")],
}


def model_name_from_path(path: str) -> Optional[str]:
    """convert.py:57-133 dispatches on the caffemodel's directory name."""
    p = str(path)
    for tag, name in [("FlowNet2-CSS-ft-sd/", "FlowNet2CSS"),
                      ("FlowNet2-CSS/", "FlowNet2CSS"),
                      ("FlowNet2-CS/", "FlowNet2CS"),
                      ("FlowNet2-C/", "FlowNet2C"),
                      ("FlowNet2-SD/", "FlowNet2SD"),
                      ("FlowNet2-S/", "FlowNet2S"),
                      ("FlowNet2/", "FlowNet2")]:
        if tag in p:
            return name
    return None


def caffe_to_state_dict(layers: Dict[str, List[np.ndarray]],
                        model_name: str) -> Dict[str, np.ndarray]:
    """Map parsed caffe layers to a reference-style torch state dict
    (keys as in models.py:42-90), applying the BGR input-channel flips."""
    if model_name not in _MODEL_NETS:
        raise KeyError(f"unknown model {model_name!r}; "
                       f"available: {sorted(_MODEL_NETS)}")
    state: Dict[str, np.ndarray] = {}
    for kind, cprefix, tprefix in _MODEL_NETS[model_name]:
        first_conv, groups = _BGR[kind]
        for caffe_key, module, style in _net_table(kind, cprefix):
            if caffe_key not in layers:
                raise KeyError(
                    f"caffemodel is missing layer {caffe_key!r} "
                    f"(wanted for {tprefix}{module})")
            blobs = layers[caffe_key]
            weight = np.asarray(blobs[0], np.float32)
            if module == first_conv:
                weight = weight.copy()
                for lo, hi in groups:
                    weight[:, lo:hi] = weight[:, lo:hi][:, ::-1]
            mid = f"{module}.0" if style == SEQ else module
            state[f"{tprefix}{mid}.weight"] = weight
            if style != BARE_NO_BIAS and len(blobs) > 1 and blobs[1].size:
                state[f"{tprefix}{mid}.bias"] = np.asarray(blobs[1], np.float32)
    return state


def load_caffe_checkpoint(path: str | pathlib.Path, model: torch.nn.Module,
                          model_name: Optional[str] = None) -> Dict[str, Any]:
    """Load an original FlowNet2 ``.caffemodel`` into ``model`` (a port model
    of the same architecture) with ``strict=True``, onto the device its
    parameters live on.  The architecture is ``model_name`` or, without
    it, read off the release's directory name.  Returns ``{'arch',
    'epoch', 'best_EPE'}`` as ``load_checkpoint`` does."""
    name = model_name or model_name_from_path(str(path))
    if name is None:
        raise ValueError(
            f"cannot infer model from path {str(path)!r}; pass model_name=")
    state = caffe_to_state_dict(read_caffemodel(path), name)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
    return {"arch": name, "epoch": 0, "best_EPE": 1e10}
