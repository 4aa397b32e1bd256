"""The port's caffemodel import (``checkpoints/caffe_import.py``) and its
``convert`` entry against the JAX package's, on the CPU.

- Every wire-format case of ``tests/test_caffe_import.py`` (``TestWireParser``
  and ``TestRealFileQuirks``), written by this file's own copy of the byte
  writers, read by both packages' ``read_caffemodel``: the same layers,
  bit for bit.
- For every model of ``_MODEL_NETS``, a synthetic caffemodel with small
  blobs through both ``caffe_to_state_dict``: the same keys and arrays,
  the BGR flips included.
- FlowNet2S at its real shapes, written from seeded weights with the first
  convolution's BGR groups reversed, through both
  ``load_caffe_checkpoint``: the port's model holds the seeded weights and
  ``from_jax_variables`` of the JAX variables bit for bit, and a 64x128
  forward agrees with the JAX model's to EPE < 1e-4.
- ``python -m flownet2_tpu_torch.checkpoints.convert`` as a subprocess:
  exit 0, one JSON line, and the checkpoint restores into the model bit
  for bit; exit 2 where the model cannot be inferred.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.checkpoints import caffe_import as jax_caffe
from flownet2_tpu.models import get_model as jax_get_model

from flownet2_tpu_torch.checkpoints import (caffe_import, from_jax_variables,
                                            restore_checkpoint)
from flownet2_tpu_torch.checkpoints import convert
from flownet2_tpu_torch.models import get_model

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# protobuf writer (test side), enough to write caffemodels
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _vi(field: int, v: int) -> bytes:  # varint field
    return _varint((field << 3) | 0) + _varint(v)


def _blob(arr: np.ndarray) -> bytes:
    # BlobShape dims are field 1 varints (unpacked here)
    shape = b"".join(_vi(1, d) for d in arr.shape)
    return _ld(7, shape) + _ld(5, arr.astype("<f4").tobytes())


def _layer_new(name: str, blobs) -> bytes:
    payload = _ld(1, name.encode()) + _ld(2, b"Convolution")
    for b in blobs:
        payload += _ld(7, _blob(b))
    return _ld(100, payload)


def _layer_v1(name: str, blobs) -> bytes:
    payload = _ld(4, name.encode())
    for b in blobs:
        payload += _ld(6, _blob(b))
    return _ld(2, payload)


def caffe_layers(state: dict, model_name: str, bias_rng=None) -> dict:
    """The caffe layers {name: [weight, bias]} whose import is ``state``
    (a reference-keyed state dict of numpy arrays): each table row's
    weight, the first convolutions' BGR groups reversed, and its bias; a
    module without a bias gets a bias blob from ``bias_rng`` (the release
    has one; the import drops it)."""
    bias_rng = bias_rng or np.random.RandomState(0)
    layers = {}
    for kind, cprefix, tprefix in caffe_import._MODEL_NETS[model_name]:
        first_conv, groups = caffe_import._BGR[kind]
        for caffe_key, module, style in caffe_import._net_table(kind,
                                                                cprefix):
            mid = f"{module}.0" if style == caffe_import.SEQ else module
            weight = np.array(state[f"{tprefix}{mid}.weight"], np.float32)
            if module == first_conv:
                for lo, hi in groups:
                    weight[:, lo:hi] = weight[:, lo:hi][:, ::-1]
            bias = state.get(f"{tprefix}{mid}.bias")
            if bias is None:
                bias = bias_rng.randn(weight.shape[1]).astype(np.float32)
            layers[caffe_key] = [weight, np.asarray(bias, np.float32)]
    return layers


def write_caffemodel(path, layers: dict) -> None:
    """A V1-era NetParameter (``layers``, field 2), as the release's."""
    payload = _ld(1, b"net")
    for name, blobs in layers.items():
        payload += _layer_v1(name, blobs)
    pathlib.Path(path).write_bytes(payload)


# ---------------------------------------------------------------------------
# the wire-format cases of tests/test_caffe_import.py
# ---------------------------------------------------------------------------

def _roundtrip(maker):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3, 5, 5).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    return _ld(1, b"net") + maker("conv1", [w, b]) + maker("nodata", [])


def _multiple_packed_data_chunks():
    w = np.random.RandomState(1).randn(2, 3, 3, 3).astype(np.float32)
    flat = w.ravel()
    shape = b"".join(_vi(1, d) for d in w.shape)
    blob = (_ld(7, shape)
            + _ld(5, flat[:20].astype("<f4").tobytes())
            + _ld(5, flat[20:40].astype("<f4").tobytes())
            + _ld(5, flat[40:].astype("<f4").tobytes()))
    return _ld(100, _ld(1, b"conv1") + _ld(7, blob))


def _v1_legacy_nchw_shape():
    w = np.random.RandomState(2).randn(4, 2, 5, 5).astype(np.float32)
    n, c, h, wd = w.shape
    blob = (_vi(1, n) + _vi(2, c) + _vi(3, h) + _vi(4, wd)
            + _ld(5, w.astype("<f4").tobytes()))
    return _ld(2, _ld(4, b"conv1") + _ld(6, blob))


def _v1_partial_legacy_dims():
    b = np.arange(6, dtype=np.float32)
    blob = _vi(1, 6) + _ld(5, b.astype("<f4").tobytes())
    return _ld(2, _ld(4, b"conv1") + _ld(6, blob))


def _unknown_fields_every_wire_type():
    w = np.random.RandomState(3).randn(2, 2, 3, 3).astype(np.float32)
    shape = b"".join(_vi(1, d) for d in w.shape)
    junk = (_vi(90, 12345)                           # varint
            + _varint((91 << 3) | 1) + b"\x01" * 8   # 64-bit
            + _varint((92 << 3) | 5) + b"\x02" * 4   # 32-bit
            + _ld(93, b"opaque-sub-message"))        # length-delimited
    blob = junk + _ld(7, shape) + _ld(5, w.astype("<f4").tobytes()) + junk
    payload = (junk + _ld(1, b"conv1") + _ld(2, b"Convolution")
               + _ld(7, blob) + junk)
    return junk + _ld(1, b"net") + _ld(100, payload) + junk


def _packed_blobshape_dims():
    w = np.random.RandomState(4).randn(3, 2, 1, 1).astype(np.float32)
    packed_dims = b"".join(_varint(d) for d in w.shape)
    blob = _ld(7, _ld(1, packed_dims)) + _ld(5, w.astype("<f4").tobytes())
    return _ld(100, _ld(1, b"conv1") + _ld(7, blob))


def _double_data_blob():
    w = np.array([1.5, -2.25, 3.0, 0.125], np.float64).reshape(2, 2)
    shape = b"".join(_vi(1, d) for d in w.shape)
    blob = _ld(7, shape) + _ld(8, w.astype("<f8").tobytes())
    return _ld(100, _ld(1, b"conv1") + _ld(7, blob))


WIRE_CASES = {
    "roundtrip_new": (lambda: _roundtrip(_layer_new), (4, 3, 5, 5)),
    "roundtrip_v1": (lambda: _roundtrip(_layer_v1), (4, 3, 5, 5)),
    "multiple_packed_data_chunks": (_multiple_packed_data_chunks,
                                    (2, 3, 3, 3)),
    "v1_legacy_nchw_shape": (_v1_legacy_nchw_shape, (4, 2, 5, 5)),
    "v1_partial_legacy_dims_default_to_one": (_v1_partial_legacy_dims,
                                              (6, 1, 1, 1)),
    "unknown_fields_every_wire_type_skipped": (
        _unknown_fields_every_wire_type, (2, 2, 3, 3)),
    "packed_blobshape_dims": (_packed_blobshape_dims, (3, 2, 1, 1)),
    "double_data_blob": (_double_data_blob, (2, 2)),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_read_caffemodel_matches_jax(case, tmp_path):
    """The same bytes read by both packages: the same layer names, blob
    counts, shapes, dtypes and bits."""
    make, shape = WIRE_CASES[case]
    path = tmp_path / f"{case}.caffemodel"
    path.write_bytes(make())
    got = caffe_import.read_caffemodel(path)
    want = jax_caffe.read_caffemodel(path)
    assert list(got) == list(want) == ["conv1"]
    assert got["conv1"][0].shape == shape
    assert len(got["conv1"]) == len(want["conv1"])
    for a, b in zip(got["conv1"], want["conv1"]):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_empty_raises_and_model_name_from_path(tmp_path):
    path = tmp_path / "empty.caffemodel"
    path.write_bytes(_ld(1, b"net"))
    for mod in (caffe_import, jax_caffe):
        with pytest.raises(ValueError, match="no parameter"):
            mod.read_caffemodel(path)
    for p in ("/m/FlowNet2/FlowNet2_weights.caffemodel",
              "/m/FlowNet2-CSS-ft-sd/x.caffemodel",
              "/m/FlowNet2-CSS/x.caffemodel", "/m/FlowNet2-CS/x.caffemodel",
              "/m/FlowNet2-C/x.caffemodel", "/m/FlowNet2-SD/x.caffemodel",
              "/m/FlowNet2-S/x.caffemodel", "/m/elsewhere/x.caffemodel"):
        assert (caffe_import.model_name_from_path(p)
                == jax_caffe.model_name_from_path(p))
    assert caffe_import.model_name_from_path(
        "/m/FlowNet2-CSS-ft-sd/x.caffemodel") == "FlowNet2CSS"
    assert caffe_import.model_name_from_path("/m/x.caffemodel") is None


# ---------------------------------------------------------------------------
# the layer tables, every model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name", sorted(jax_caffe._MODEL_NETS))
def test_caffe_to_state_dict_matches_jax(model_name, tmp_path):
    """Small blobs (weights (2, 9, 1, 1), biases (2,)) under every caffe
    key of the model, read from one file: both packages' state dicts have
    the same keys and arrays, the BGR flips and the dropped biases
    included, and the keys are the port model's."""
    assert caffe_import._MODEL_NETS == jax_caffe._MODEL_NETS
    rng = np.random.RandomState(len(model_name))
    layers = {}
    for kind, cprefix, _ in jax_caffe._MODEL_NETS[model_name]:
        for caffe_key, _, _ in jax_caffe._net_table(kind, cprefix):
            layers[caffe_key] = [rng.randn(2, 9, 1, 1).astype(np.float32),
                                 rng.randn(2).astype(np.float32)]
    path = tmp_path / "small.caffemodel"
    write_caffemodel(path, layers)
    got = caffe_import.caffe_to_state_dict(
        caffe_import.read_caffemodel(path), model_name)
    want = jax_caffe.caffe_to_state_dict(jax_caffe.read_caffemodel(path),
                                         model_name)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key
    model = get_model(model_name, device="cpu")
    assert set(got) == set(model.state_dict())
    # each sub-net's first convolution has its BGR groups reversed
    for kind, cprefix, tprefix in jax_caffe._MODEL_NETS[model_name]:
        first_conv, groups = jax_caffe._BGR[kind]
        blob = layers[cprefix + first_conv][0]
        weight = got[f"{tprefix}{first_conv}.0.weight"]
        for lo, hi in groups:
            np.testing.assert_array_equal(weight[:, lo:hi],
                                          blob[:, lo:hi][:, ::-1])


# ---------------------------------------------------------------------------
# FlowNet2S at its real shapes, and convert
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flownet2s_caffemodel(tmp_path_factory):
    """A FlowNet2S caffemodel in the release's directory layout, written
    from the seeded port model (seed 3); returns (path, seeded model)."""
    root = tmp_path_factory.mktemp("caffe") / "FlowNet2-S"
    root.mkdir()
    seeded = get_model("FlowNet2S", device="cpu", seed=3)
    state = {k: v.numpy() for k, v in seeded.state_dict().items()}
    path = root / "FlowNet2-S_weights.caffemodel"
    write_caffemodel(path, caffe_layers(state, "FlowNet2S"))
    return path, seeded


def _assert_state_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_flownet2s_loads_as_in_jax(flownet2s_caffemodel):
    """The port's model from the caffemodel holds the seeded weights, and
    the JAX package's variables of the same file, brought over by
    ``from_jax_variables``, bit for bit; a 64x128 forward agrees with the
    JAX model's to EPE < 1e-4."""
    path, seeded = flownet2s_caffemodel
    model = get_model("FlowNet2S", device="cpu", seed=0)
    meta = caffe_import.load_caffe_checkpoint(path, model)
    assert meta == {"arch": "FlowNet2S", "epoch": 0, "best_EPE": 1e10}
    _assert_state_equal(model.state_dict(), seeded.state_dict())
    variables, jmeta = jax_caffe.load_caffe_checkpoint(path)
    assert jmeta == meta
    from_jax = {k: torch.as_tensor(np.asarray(v))
                for k, v in from_jax_variables(
                    jax.tree_util.tree_map(np.asarray, variables),
                    "FlowNet2S").items()}
    assert set(from_jax) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert torch.equal(value, from_jax[key]), key

    pair = np.random.RandomState(5).rand(1, 2, 64, 128, 3).astype(
        np.float32) * 255
    with torch.inference_mode():
        got = model(torch.from_numpy(pair)).numpy()
    jax_model = jax_get_model("FlowNet2S")
    want = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(pair)))
    epe = float(np.sqrt(((got - want) ** 2).sum(-1)).mean())
    print(f"FlowNet2S from one caffemodel: EPE {epe:.3e} between the "
          f"packages, |flow| max {np.abs(want).max():.3f}")
    assert got.shape == want.shape == (1, 64, 128, 2)
    assert np.abs(want).max() > 0
    assert epe < 1e-4
    with pytest.raises(ValueError, match="cannot infer"):
        caffe_import.load_caffe_checkpoint(
            path.parent.parent / "x.caffemodel", model)


def test_convert_subprocess(flownet2s_caffemodel, tmp_path):
    """``python -m flownet2_tpu_torch.checkpoints.convert``: exit 0, one
    JSON line, a checkpoint of the weights alone that restores bit-equal
    to the seeded model; exit 2 for a file whose model it cannot infer."""
    path, seeded = flownet2s_caffemodel
    out = tmp_path / "ckpts"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "flownet2_tpu_torch.checkpoints.convert",
         str(path), str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    n_params = sum(p.numel() for p in seeded.parameters())
    assert line == {"arch": "FlowNet2S", "params": n_params,
                    "checkpoint": str((out / "FlowNet2S-caffe").absolute())}
    assert "parsed and loaded in" in proc.stderr
    model = get_model("FlowNet2S", device="cpu", seed=0)
    meta = restore_checkpoint(line["checkpoint"], model, None, tag=None)
    assert meta == {"epoch": 0, "best_EPE": 1e10}
    _assert_state_equal(model.state_dict(), seeded.state_dict())
    state = torch.load(pathlib.Path(line["checkpoint"]) / "state.pt",
                       weights_only=True)
    assert state["optimizer"] is None

    bare = tmp_path / "bare.caffemodel"
    bare.write_bytes(path.read_bytes())
    assert convert.main([str(bare), str(out)]) == 2
