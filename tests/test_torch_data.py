"""The port's data path against the JAX package's, on the same synthetic
files on the CPU: every dataset class and ``get_dataset`` (index, samples,
crops across ``set_epoch``, the native batch plan), the ``DataLoader``
(shuffled, a padded tail, two stripes) on the native and the numpy route,
the native decoders against numpy and PIL, where the native library is
built, and ``device_prefetch`` on the CPU."""

import pathlib
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from flownet2_tpu.data import datasets as jax_datasets
from flownet2_tpu.data import loader as jax_loader

from flownet2_tpu_torch import native
from flownet2_tpu_torch.data import (
    DATASETS,
    Batch,
    DataLoader,
    DeviceLoader,
    device_prefetch,
    flow_io,
    frame_io,
    get_dataset,
)
from flownet2_tpu_torch.ops import _cuda

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "flownet2_tpu_torch"


def _img(rng, h, w):
    return rng.randint(0, 256, (h, w, 3), dtype=np.uint8)


def _flo(rng, h, w):
    return (rng.randn(h, w, 2) * 3).astype(np.float32)


def _save(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".flo":
        flow_io.write_flo(path, arr)
    else:
        Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One directory per dataset layout, as tests/test_data.py builds them:
    Sintel at 100x150 (its render size snaps to 64x128), FlyingChairs .ppm
    at 70x100, FlyingThings at 64x96, ChairsSDHom and a folder of frames at
    64x64."""
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.RandomState(0)
    sintel = root / "sintel"
    for dstype in ("clean", "final"):
        for i in (1, 2, 3):
            _save(sintel / dstype / "alley_1" / f"frame_{i:04d}.png",
                  _img(rng, 100, 150))
    for i in (1, 2):
        _save(sintel / "flow" / "alley_1" / f"frame_{i:04d}.flo",
              _flo(rng, 100, 150))
    # a 'test' scene, which the index skips
    _save(sintel / "flow" / "test_scene" / "frame_0001.flo",
          _flo(rng, 100, 150))
    chairs = root / "chairs"
    for i in range(5):
        for j in (1, 2):
            _save(chairs / f"{i:05d}_img{j}.ppm", _img(rng, 70, 100))
        _save(chairs / f"{i:05d}_flow.flo", _flo(rng, 70, 100))
    things = root / "things"
    for pas in ("frames_cleanpass", "frames_finalpass"):
        for side in ("left", "right"):
            for i in (6, 7, 8):
                _save(things / pas / "TRAIN" / "A" / "0000" / side
                      / f"{i:04d}.png", _img(rng, 64, 96))
    for side in ("left", "right"):
        for i in (6, 7):
            _save(things / "optical_flow_flo_format" / "TRAIN" / "A" / "0000"
                  / "into_future" / side / f"OpticalFlowIntoFuture_{i:04d}"
                  ".flo", _flo(rng, 64, 96))
    sdhom = root / "sdhom"
    for split in ("train", "test"):
        for k in range(2):
            for sub in ("t0", "t1"):
                _save(sdhom / split / sub / f"{k:05d}.png", _img(rng, 64, 64))
            _save(sdhom / split / "flow" / f"{k:05d}.flo", _flo(rng, 64, 64))
    frames = root / "frames"
    for i in range(4):
        _save(frames / f"f{i}.png", _img(rng, 64, 64))
    return {"MpiSintelClean": sintel, "MpiSintelFinal": sintel,
            "FlyingChairs": chairs, "FlyingThingsClean": things,
            "FlyingThingsFinal": things, "ChairsSDHomTrain": sdhom,
            "ChairsSDHomTest": sdhom, "ImagesFromFolder": frames}


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """The port's decoders: the native library, or numpy and PIL (the
    library marked as not available)."""
    if request.param == "native":
        if not native.available():
            pytest.skip(f"native decoders not built: {native.build_error()}")
    else:
        monkeypatch.setattr(native, "_TRIED", True)
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_ERROR", "switched off by the test")
    return request.param


CROPS = {"MpiSintelClean": (48, 64), "MpiSintelFinal": (48, 64),
         "FlyingChairs": (32, 48), "FlyingThingsClean": (32, 64),
         "FlyingThingsFinal": (32, 64), "ChairsSDHomTrain": (32, 32),
         "ChairsSDHomTest": (32, 32), "ImagesFromFolder": (32, 32)}


def _pair(name, root, **kw):
    return (get_dataset(name, root=str(root), **kw),
            jax_datasets.get_dataset(name, root=str(root), **kw))


@pytest.mark.parametrize("name", sorted(CROPS))
@pytest.mark.parametrize("cropped", [False, True])
def test_datasets_match_jax(trees, route, name, cropped):
    """The same index, render size, batch plan and samples, bit for bit,
    centre-cropped and randomly cropped, across set_epoch."""
    kw = dict(seed=3, replicates=2)
    if cropped:
        kw.update(is_cropped=True, crop_size=CROPS[name])
    port, ref = _pair(name, trees[name], **kw)
    assert type(port).__name__ == type(ref).__name__ == name
    assert len(port) == len(ref) > 0
    assert port.image_list == ref.image_list
    assert port.flow_list == ref.flow_list
    assert port.render_size == ref.render_size
    assert tuple(port.frame_size) == tuple(ref.frame_size)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for index in range(len(port)):
            for a, b in zip(port[index], ref[index]):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
        got, want = (ds.batch_plan(list(range(len(ds)))) for ds in (port, ref))
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(np.asarray(got[key], dtype=object),
                                          np.asarray(want[key], dtype=object))


def test_dataset_details(trees):
    """The Sintel index skips the test scene and snaps its render size; the
    ChairsSDHom flow is flipped; the folder's targets are zero; crops move
    with the epoch; unknown names raise."""
    sintel = get_dataset("MpiSintelClean", root=str(trees["MpiSintelClean"]))
    assert sintel.size == 2 and sintel.render_size == [64, 128]
    assert sintel[0][0].shape == (2, 64, 128, 3)
    sdhom = get_dataset("ChairsSDHomTrain",
                        root=str(trees["ChairsSDHomTrain"]))
    flow = frame_io.read_gen(sdhom.flow_list[0])
    np.testing.assert_array_equal(sdhom[0][1], flow[::-1])
    folder = get_dataset("ImagesFromFolder",
                         root=str(trees["ImagesFromFolder"]))
    assert folder.size == 3 and not folder[0][1].any()
    chairs = get_dataset("FlyingChairs", root=str(trees["FlyingChairs"]),
                         is_cropped=True, crop_size=(32, 48), seed=1)
    first = chairs[0][0]
    chairs.set_epoch(1)
    assert not np.array_equal(first, chairs[0][0])
    assert sorted(DATASETS) == sorted(jax_datasets.DATASETS)
    with pytest.raises(KeyError, match="available"):
        get_dataset("KITTI", root=str(trees["FlyingChairs"]))


def _batches(loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out += [(b.images, b.flow, b.n_valid) for b in loader]
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gi, gf, gn), (wi, wf, wn) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("stripes", [1, 2])
def test_loader_matches_jax(trees, route, stripes):
    """Shuffled, cropped, drop_last off (10 samples at batch 4: a tail of
    2 padded back to 4), one stripe or two: the same batches and n_valid as
    the JAX loader, over two epochs, on either route of the port."""
    kw = dict(is_cropped=True, crop_size=(32, 48), seed=5, replicates=2)
    port_ds, ref_ds = _pair("FlyingChairs", trees["FlyingChairs"], **kw)
    for index in range(stripes):
        lkw = dict(batch_size=4, shuffle=True, drop_last=False, seed=2,
                   num_workers=2, process_count=stripes, process_index=index)
        port = DataLoader(port_ds, **lkw)
        ref = jax_loader.DataLoader(ref_ds, **lkw)
        assert port.use_native == (route == "native")
        assert len(port) == len(ref) == 3
        got = _batches(port)
        _assert_same_batches(got, _batches(ref))
        assert [n for _, _, n in got] == [4, 4, 2] * 2
        assert got[0][0].shape == (4 // stripes, 2, 32, 48, 3)


def test_loader_routes_agree(trees, monkeypatch):
    """The native batch path and the per-sample numpy path of the port give
    the same batches (uncropped Sintel, a flow-less folder)."""
    if not native.available():
        pytest.skip(f"native decoders not built: {native.build_error()}")
    for name in ("MpiSintelFinal", "ImagesFromFolder"):
        ds = get_dataset(name, root=str(trees[name]), replicates=3)
        fast = DataLoader(ds, batch_size=2, shuffle=True, drop_last=False)
        slow = DataLoader(ds, batch_size=2, shuffle=True, drop_last=False,
                          use_native=False)
        assert fast.use_native and not slow.use_native
        _assert_same_batches(_batches(fast), _batches(slow))


@pytest.mark.parametrize("ext", ["png", "ppm", "jpg"])
def test_native_readers_match_numpy_and_pil(tmp_path, ext):
    """The native image and .flo readers and the .flo writer against PIL and
    numpy; malformed files raise as the numpy route does."""
    if not native.available():
        pytest.skip(f"native decoders not built: {native.build_error()}")
    rng = np.random.RandomState(7)
    img = _img(rng, 23, 31)
    Image.fromarray(img).save(tmp_path / f"a.{ext}")
    Image.fromarray(img[..., 0]).save(tmp_path / f"g.{ext}")
    for name in ("a", "g"):
        path = tmp_path / f"{name}.{ext}"
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(native.read_image(path), want)
    flow = _flo(rng, 19, 27)
    native.write_flo(tmp_path / "n.flo", flow)
    with open(tmp_path / "p.flo", "wb") as f:
        f.write(np.float32(202021.25).tobytes() + np.int32(27).tobytes()
                + np.int32(19).tobytes() + flow.tobytes())
    assert ((tmp_path / "n.flo").read_bytes()
            == (tmp_path / "p.flo").read_bytes())
    np.testing.assert_array_equal(native.read_flo(tmp_path / "p.flo"), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 32)
    with pytest.raises(ValueError, match="magic"):
        native.read_flo(tmp_path / "bad.flo")
    with pytest.raises(IOError):
        native.read_image(tmp_path / "missing.png")


def test_native_builds_into_the_build_root(tmp_path, monkeypatch):
    """With FLOWNET2_TORCH_BUILD_DIR set, the library is built there (under
    a name keyed by the source's hash, no temporary left behind) and
    nothing is written into the package; without a compiler, or switched
    off, the data path falls back to numpy and says why."""
    before = sorted(p for p in PACKAGE.rglob("*") if "__pycache__" not in
                    p.parts)
    monkeypatch.setenv(_cuda.BUILD_DIR_ENV, str(tmp_path / "root"))
    for attr, value in (("_TRIED", False), ("_LIB", None), ("_ERROR", None)):
        monkeypatch.setattr(native, attr, value)
    assert native.library_path().parent == tmp_path / "root"
    if native.available():
        assert [p.name for p in (tmp_path / "root").iterdir()] == [
            native.library_path().name]
        assert native.build_error() is None
        flow = _flo(np.random.RandomState(1), 5, 6)
        native.write_flo(tmp_path / "x.flo", flow)
        np.testing.assert_array_equal(flow_io.read_flo(tmp_path / "x.flo"),
                                      flow)
    after = sorted(p for p in PACKAGE.rglob("*") if "__pycache__" not in
                   p.parts)
    assert after == before
    assert not list(PACKAGE.rglob("*.so"))

    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv(_cuda.BUILD_DIR_ENV, str(tmp_path / "other"))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.warns(RuntimeWarning, match="build failed"):
        assert not native.available()
    assert "no-such-compiler" in native.build_error()
    flow = _flo(np.random.RandomState(2), 4, 3)
    flow_io.write_flo(tmp_path / "y.flo", flow)   # the numpy route
    np.testing.assert_array_equal(flow_io.read_flo(tmp_path / "y.flo"), flow)

    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    assert native.NO_NATIVE_ENV in native.build_error()


def test_device_prefetch_on_the_cpu(trees):
    """device_prefetch(device="cpu") yields the loader's batches as tensors,
    in order, with n_valid, and DeviceLoader does so once an epoch; a
    consumer that stops early leaves no thread behind; a loader's exception
    reaches the consumer."""
    ds = get_dataset("FlyingChairs", root=str(trees["FlyingChairs"]),
                     is_cropped=True, crop_size=(32, 48), replicates=2)
    loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=False,
                        seed=1)
    want = _batches(loader, epochs=(0,))
    loader.set_epoch(0)
    got = list(device_prefetch(loader, size=2, device="cpu"))
    assert all(isinstance(b, Batch) and isinstance(b.images, torch.Tensor)
               and b.images.device.type == "cpu" for b in got)
    _assert_same_batches([(b.images.numpy(), b.flow.numpy(), b.n_valid)
                          for b in got], want)

    on_device = DeviceLoader(loader, device="cpu")
    assert len(on_device) == len(loader) == 3
    on_device.set_epoch(1)
    assert loader._epoch == 1
    _assert_same_batches([(b.images.numpy(), b.flow.numpy(), b.n_valid)
                          for b in on_device], _batches(loader, epochs=(1,)))

    stream = device_prefetch(iter(loader), size=1, device="cpu")
    next(stream)
    stream.close()
    assert not any(t.name == "device_prefetch" and t.is_alive()
                   for t in threading.enumerate())

    def broken():
        yield want[0]
        raise OSError("unreadable frame")

    with pytest.raises(OSError, match="unreadable"):
        list(device_prefetch((Batch(*b) for b in broken()), device="cpu"))
    with pytest.raises(ValueError):
        next(device_prefetch(iter(()), size=0, device="cpu"))


def test_device_prefetch_wants_cuda_by_default(trees):
    """device=None means the CUDA device: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter(()), size=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLoader([])
