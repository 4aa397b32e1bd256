"""Dataset indices and crops: the port's copy of
flownet2_tpu/data/datasets.py (numpy and the stdlib only).

The reference's datasets, with explicit constructor parameters in place of
its mutable ``args``:

- MpiSintel{Clean,Final}: pairs listed from flow/*.flo names, scenes whose
  relative path holds 'test' skipped.
- FlyingChairs: consecutive *.ppm pairs and their *.flo.
- FlyingThings{Clean,Final}: left and right TRAIN directories and their
  into_future flows.
- ChairsSDHom{Train,Test}: t0/t1/flow directories, flow rows flipped
  vertically.
- ImagesFromFolder: consecutive frames, zero flow targets.
- StaticRandomCrop / StaticCenterCrop: the random crop's offset is drawn
  once per sample and applied to both frames and the flow; it is a pure
  function of (seed, epoch, index).
- The render size is snapped down to multiples of 64 when uncropped.

Samples come out as numpy arrays in the JAX package's layout: images
(2, H, W, 3) float32, flow (H, W, 2) float32 (the model takes the pair as
it is and moves it to NCHW inside).
"""

from __future__ import annotations

import glob
from os.path import isfile, join, splitext
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import frame_io


class StaticRandomCrop:
    """Crop offset drawn once, reused for every array passed in."""

    def __init__(self, image_size, crop_size, origin):
        self.th, self.tw = crop_size
        self.h1, self.w1 = origin

    def __call__(self, img):
        return img[self.h1:self.h1 + self.th, self.w1:self.w1 + self.tw]


class StaticCenterCrop:
    """Center crop."""

    def __init__(self, image_size, crop_size):
        self.th, self.tw = crop_size
        self.h, self.w = image_size

    def __call__(self, img):
        return img[(self.h - self.th) // 2:(self.h + self.th) // 2,
                   (self.w - self.tw) // 2:(self.w + self.tw) // 2]


def _snap64(size: Sequence[int]) -> List[int]:
    return [(size[0] // 64) * 64, (size[1] // 64) * 64]


class FlowDataset:
    """Base: an index of (img1, img2, flow) paths + crop policy."""

    def __init__(self, crop_size=(256, 256), inference_size=(-1, -1),
                 is_cropped: bool = False, replicates: int = 1,
                 seed: int = 0, flip_flow_vertical: bool = False):
        self.crop_size = list(crop_size)
        self.render_size = list(inference_size)
        self.is_cropped = is_cropped
        self.replicates = replicates
        self.flip_flow_vertical = flip_flow_vertical
        self.seed = seed
        self._epoch = 0
        self.image_list: List[Tuple[str, str]] = []
        self.flow_list: List[Optional[str]] = []

    def set_epoch(self, epoch: int) -> None:
        """Advance the crop stream: crops are a pure function of
        (seed, epoch, index), so the native batch path, the per-sample
        path and a resumed run all produce identical crops."""
        self._epoch = int(epoch)

    def _crop_origin(self, index: int, image_size, crop_size):
        th, tw = crop_size
        h, w = image_size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch, int(index)]))
        return (int(rng.integers(0, h - th + 1)),
                int(rng.integers(0, w - tw + 1)))

    def _finalize(self):
        assert len(self.image_list) == len(self.flow_list)
        self.size = len(self.image_list)
        if self.size == 0:
            raise FileNotFoundError(
                f"{type(self).__name__}: empty index — check the root path")
        self.frame_size = frame_io.read_gen(self.image_list[0][0]).shape
        if (self.render_size[0] < 0 or self.render_size[1] < 0
                or self.frame_size[0] % 64 or self.frame_size[1] % 64):
            self.render_size = _snap64(self.frame_size)

    def __len__(self):
        return self.size * self.replicates

    _NATIVE_EXTS = {".png", ".jpg", ".jpeg", ".ppm", ".pgm"}

    def batch_plan(self, indices):
        """Decode plan for native.batch_load (one C call per batch): paths +
        per-item crop origins in the same draw order as __getitem__.

        Returns None when the native loader can't serve this dataset
        (.bin/.raw frames); the loader then falls back to per-sample
        __getitem__ decoding.
        """
        ext = splitext(self.image_list[0][0])[1].lower()
        if ext not in self._NATIVE_EXTS:
            return None
        h, w = self.frame_size[:2]
        if self.is_cropped:
            th, tw = self.crop_size
        else:
            th, tw = self.render_size
        img_paths, img_off = [], []
        flo_paths, flo_off, flo_slots = [], [], []
        for slot, raw_index in enumerate(indices):
            index = int(raw_index) % self.size
            if self.is_cropped:
                # crop keyed on the *raw* index so replicate passes differ
                oy, ox = self._crop_origin(raw_index, (h, w), (th, tw))
            else:
                oy, ox = (h - th) // 2, (w - tw) // 2
            img_paths.extend(self.image_list[index])
            img_off.extend([(oy, ox), (oy, ox)])
            flow_path = self.flow_list[index]
            if flow_path is not None:
                flo_paths.append(flow_path)
                flo_off.append((oy, ox))
                flo_slots.append(slot)
        return {
            "img_paths": img_paths,
            "img_offsets": np.asarray(img_off, np.int32).reshape(-1, 2),
            "flo_paths": flo_paths,
            "flo_offsets": np.asarray(flo_off, np.int32).reshape(-1, 2),
            "flo_slots": flo_slots,
            "crop": (th, tw),
            "flip_flow_vertical": self.flip_flow_vertical,
        }

    def __getitem__(self, raw_index: int):
        index = raw_index % self.size
        img1 = frame_io.read_gen(self.image_list[index][0])
        img2 = frame_io.read_gen(self.image_list[index][1])
        flow_path = self.flow_list[index]
        if flow_path is None:
            flow = np.zeros(img1.shape[:2] + (2,), np.float32)
        else:
            flow = frame_io.read_gen(flow_path)
            if self.flip_flow_vertical:
                flow = flow[::-1, :, :]  # ChairsSDHom's flows are stored upside down

        image_size = img1.shape[:2]
        if self.is_cropped:
            cropper = StaticRandomCrop(
                image_size, self.crop_size,
                self._crop_origin(raw_index, image_size, self.crop_size))
        else:
            cropper = StaticCenterCrop(image_size, self.render_size)
        img1, img2, flow = cropper(img1), cropper(img2), cropper(flow)

        images = np.stack([img1, img2]).astype(np.float32)  # (2, H, W, 3)
        return images, np.ascontiguousarray(flow, np.float32)


class MpiSintel(FlowDataset):
    def __init__(self, root: str, dstype: str = "clean", **kw):
        super().__init__(**kw)
        flow_root = join(root, "flow")
        image_root = join(root, dstype)
        for file in sorted(glob.glob(join(flow_root, "*/*.flo"))):
            fbase = file[len(flow_root) + 1:]
            # skip the withheld-GT scenes; the *relative* path is tested,
            # so a root directory whose path holds "test" keeps its index
            if "test" in fbase:
                continue
            fprefix, fnum = fbase[:-8], int(fbase[-8:-4])
            img1 = join(image_root, fprefix + f"{fnum:04d}.png")
            img2 = join(image_root, fprefix + f"{fnum + 1:04d}.png")
            if not (isfile(img1) and isfile(img2) and isfile(file)):
                continue
            self.image_list.append((img1, img2))
            self.flow_list.append(file)
        self._finalize()


class MpiSintelClean(MpiSintel):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="clean", **kw)


class MpiSintelFinal(MpiSintel):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="final", **kw)


class FlyingChairs(FlowDataset):
    def __init__(self, root: str, **kw):
        super().__init__(**kw)
        images = sorted(glob.glob(join(root, "*.ppm")))
        flows = sorted(glob.glob(join(root, "*.flo")))
        assert len(images) // 2 == len(flows)
        for i, flow in enumerate(flows):
            self.image_list.append((images[2 * i], images[2 * i + 1]))
            self.flow_list.append(flow)
        self._finalize()


class FlyingThings(FlowDataset):
    def __init__(self, root: str, dstype: str = "frames_cleanpass", **kw):
        super().__init__(**kw)
        image_dirs = sorted(glob.glob(join(root, dstype, "TRAIN/*/*")))
        image_dirs = sorted([join(f, "left") for f in image_dirs]
                            + [join(f, "right") for f in image_dirs])
        flow_dirs = sorted(glob.glob(join(root, "optical_flow_flo_format/TRAIN/*/*")))
        flow_dirs = sorted([join(f, "into_future/left") for f in flow_dirs]
                           + [join(f, "into_future/right") for f in flow_dirs])
        assert len(image_dirs) == len(flow_dirs)
        for idir, fdir in zip(image_dirs, flow_dirs):
            images = sorted(glob.glob(join(idir, "*.png")))
            flows = sorted(glob.glob(join(fdir, "*.flo")))
            for i in range(len(flows)):
                self.image_list.append((images[i], images[i + 1]))
                self.flow_list.append(flows[i])
        self._finalize()


class FlyingThingsClean(FlyingThings):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="frames_cleanpass", **kw)


class FlyingThingsFinal(FlyingThings):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="frames_finalpass", **kw)


class ChairsSDHom(FlowDataset):
    def __init__(self, root: str, dstype: str = "train", **kw):
        kw.setdefault("flip_flow_vertical", True)
        super().__init__(**kw)
        image1 = sorted(glob.glob(join(root, dstype, "t0/*.png")))
        image2 = sorted(glob.glob(join(root, dstype, "t1/*.png")))
        flows = sorted(glob.glob(join(root, dstype, "flow/*.flo")))
        assert len(image1) == len(flows)
        for im1, im2, fl in zip(image1, image2, flows):
            self.image_list.append((im1, im2))
            self.flow_list.append(fl)
        self._finalize()


class ChairsSDHomTrain(ChairsSDHom):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="train", **kw)


class ChairsSDHomTest(ChairsSDHom):
    def __init__(self, root: str, **kw):
        super().__init__(root, dstype="test", **kw)


class ImagesFromFolder(FlowDataset):
    def __init__(self, root: str, iext: str = "png", **kw):
        super().__init__(**kw)
        images = sorted(glob.glob(join(root, "*." + iext)))
        for im1, im2 in zip(images[:-1], images[1:]):
            self.image_list.append((im1, im2))
            self.flow_list.append(None)  # zero targets
        self._finalize()


DATASETS = {
    "MpiSintelClean": MpiSintelClean,
    "MpiSintelFinal": MpiSintelFinal,
    "FlyingChairs": FlyingChairs,
    "FlyingThingsClean": FlyingThingsClean,
    "FlyingThingsFinal": FlyingThingsFinal,
    "ChairsSDHomTrain": ChairsSDHomTrain,
    "ChairsSDHomTest": ChairsSDHomTest,
    "ImagesFromFolder": ImagesFromFolder,
}


def get_dataset(name: str, **kwargs):
    try:
        cls = DATASETS[name]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; available: {sorted(DATASETS)}") from None
    return cls(**kwargs)
