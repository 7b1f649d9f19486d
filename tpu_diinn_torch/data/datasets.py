"""SR datasets: DIV2K / benchmark directory layouts, on-the-fly downsampling.

Counterpart of ``tpu_diinn/data/datasets.py`` on its numpy path:

- ``SRDatasetDownsample``: per item and scale, a random HR crop of
  ``round(patch_size * scale)`` antialias-bicubic-downsampled to
  ``patch_size`` (training), or the full image with ``lr = resize(hr,
  round(H / s))`` (``patch_size=0``, eval); augmentation is a shared random
  h/v flip and transpose. Random numbers come from the per-sample
  ``numpy.random.Generator`` the caller passes, drawn in the JAX numpy
  path's order (top, left, then the three flips), so both packages make
  the same samples byte for byte.
- ``SRDatasetPaired``: the classic EDSR-style loader of pre-generated
  ``LR_bicubic/X{s}/{stem}x{s}.png`` files with paired random crops at
  integer scales, and its optional ``.npy`` cache of decoded images
  (``binarize``), file for file as the JAX package keeps it.
- ``Subset`` and ``ConcatDataset``, the index views the trainer composes.
- ``SyntheticSRDataset``: deterministic random images for runs without
  DIV2K on disk.

``SRDatasetDownsample(use_native=True)``, the default as in the JAX
package, decodes, crops, downsamples and flips each training patch in the
native C++ loader (``native/loader.py``) when it built, outside the GIL,
drawing the same numbers in the same order; otherwise, and with
``use_native=False``, it takes the numpy path. Both make the same samples
(to float32 rounding of the [0, 1] scaling).
"""

from __future__ import annotations

import glob
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_diinn_torch.core.resize import resize_by_scale_size, resize_np
from tpu_diinn_torch.data.png import read_png
from tpu_diinn_torch.native import loader as native_loader

DATASET_DIR_STRUCTURE = {
    "DIV2K": {
        "train": {"hr_dir": "DIV2K_train_HR",
                  "lr_dir": "DIV2K_train_LR_bicubic"},
        "test": {"hr_dir": "DIV2K_test_HR",
                 "lr_dir": "DIV2K_test_LR_bicubic"},
    },
    "benchmark": {
        name: {"hr_dir": f"{name}/HR", "lr_dir": f"{name}/LR_bicubic"}
        for name in ("B100", "Set5", "Set14", "Urban100")
    },
}

Sample = Dict[float, Tuple[np.ndarray, np.ndarray, str]]


def _augment(imgs: List[np.ndarray], rng: np.random.Generator
             ) -> List[np.ndarray]:
    hflip, vflip, dflip = rng.random(3) < 0.5
    out = []
    for x in imgs:
        if hflip:
            x = x[::-1, :, :]
        if vflip:
            x = x[:, ::-1, :]
        if dflip:
            x = np.transpose(x, (1, 0, 2))
        out.append(np.ascontiguousarray(x))
    return out


def _get_patch(hr: np.ndarray, scale: float, patch_size: int,
               rng: Optional[np.random.Generator]
               ) -> Tuple[np.ndarray, np.ndarray]:
    if patch_size == 0:
        size = resize_by_scale_size(hr.shape[:2], scale)
        lr = resize_np(hr.astype(np.float32), size)
        return lr, hr.astype(np.float32)
    hps = int(round(patch_size * scale))
    top = int(rng.integers(0, hr.shape[0] - hps + 1))
    left = int(rng.integers(0, hr.shape[1] - hps + 1))
    crop = hr[top:top + hps, left:left + hps].astype(np.float32)
    lr = resize_np(crop, (patch_size, patch_size))
    return lr, crop


def _samples(hr_img: np.ndarray, scales, patch_size: int, augment: bool,
             rng: Optional[np.random.Generator], name: str) -> Sample:
    out: Sample = {}
    for scale in scales:
        lr, hr = _get_patch(hr_img, scale, patch_size, rng)
        if augment:
            lr, hr = _augment([lr, hr], rng)
        out[scale] = (lr / 255.0, hr / 255.0, name)
    return out


class SRDatasetDownsample:
    """On-the-fly LR generation from the HR images of one directory.
    ``use_native``: read and sample through the native loader where it is
    available (``native_loader.available()``, checked here, which builds
    it at first use); ``self.native`` says whether it is used."""

    def __init__(self, root: str = "./data/", name: str = "DIV2K",
                 split: str = "train", scales: Sequence[float] = (2,),
                 patch_size: int = 96, augment: bool = True,
                 use_native: bool = True):
        self.native = use_native and native_loader.available()
        self.scales = list(scales)
        self.patch_size = patch_size
        self.augment = augment
        layout = DATASET_DIR_STRUCTURE[name].get(split) \
            if name == "benchmark" else DATASET_DIR_STRUCTURE[name][split]
        if layout is None:
            layout = {"hr_dir": f"{split}/HR", "lr_dir": f"{split}/LR_bicubic"}
        hr_dir = Path(root) / name / layout["hr_dir"]
        self.names_hr = sorted(
            glob.glob(os.path.join(str(hr_dir), "*.png")))

    def __len__(self) -> int:
        return len(self.names_hr)

    def sample(self, idx: int,
               rng: Optional[np.random.Generator] = None) -> Sample:
        """{scale: (lr, hr, name)} in [0, 1]; ``rng`` is needed for
        patches and augmentation."""
        path = self.names_hr[idx]
        name = os.path.splitext(os.path.basename(path))[0]
        if not self.native:
            return _samples(read_png(path), self.scales, self.patch_size,
                            self.augment, rng, name)
        hr_img = native_loader.decode_image(path)
        if self.patch_size == 0:
            return _samples(hr_img, self.scales, 0, self.augment, rng, name)
        out: Sample = {}
        ps = self.patch_size
        for scale in self.scales:
            hps = int(round(ps * scale))
            top = int(rng.integers(0, hr_img.shape[0] - hps + 1))
            left = int(rng.integers(0, hr_img.shape[1] - hps + 1))
            flips = (rng.random(3) < 0.5) if self.augment else (False,) * 3
            lr, hr = native_loader.sample_patch(hr_img, top, left, hps, ps,
                                                *map(bool, flips))
            out[scale] = (lr, hr, name)
        return out


class Subset:
    """Index-remapped view of a dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def sample(self, idx, rng=None):
        return self.dataset.sample(self.indices[idx], rng)


class ConcatDataset:
    """Sequential concatenation of datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def sample(self, idx, rng=None):
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[k].sample(idx - int(self._offsets[k]), rng)


class SRDatasetPaired:
    """Pre-generated LR/HR pairs: ``scales`` are integers, and the LR image
    of ``<hr_dir>/<stem>.png`` at scale s is
    ``<lr_dir>/X{s}/{stem}x{s}.png``. Per scale, a ``patch_size`` LR crop
    at (top, left) and the HR crop at (top * s, left * s), then the shared
    flips; ``patch_size=0`` takes the whole LR image and the HR image cut
    to ``s`` times its size. A missing LR file raises
    ``FileNotFoundError`` when it is read.

    ``binarize=True`` keeps each decoded image as ``.npy`` under
    ``<root>/<name>/bin/``, named by its path relative to
    ``<root>/<name>`` with separators as ``__``, written to a temporary
    file of the writing process and thread and renamed into place the
    first time it is read; later reads load it and skip the PNG
    decode."""

    def __init__(self, root: str = "./data/", name: str = "DIV2K",
                 split: str = "train", file_ext: str = ".png",
                 scales: Sequence[int] = (2,), patch_size: int = 96,
                 augment: bool = True, binarize: bool = False):
        bad = [s for s in scales if not float(s).is_integer()]
        if bad:
            raise ValueError(f"SRDatasetPaired takes integer scales (its LR "
                             f"files are pre-generated), got {bad}")
        self.scales = [int(s) for s in scales]
        self.patch_size = patch_size
        self.augment = augment
        base = Path(root) / name
        struct = DATASET_DIR_STRUCTURE[name][split]
        self.hr_dir = base / struct["hr_dir"]
        self.lr_dir = base / struct["lr_dir"]
        self.file_ext = file_ext
        self.names_hr = sorted(
            glob.glob(os.path.join(str(self.hr_dir), "*" + file_ext)))
        self.bin_dir = (base / "bin") if binarize else None
        if self.bin_dir is not None:
            self.bin_dir.mkdir(parents=True, exist_ok=True)

    def _read(self, path: str) -> np.ndarray:
        if self.bin_dir is None:
            return read_png(path)
        rel = os.path.relpath(path, self.bin_dir.parent)
        cached = self.bin_dir / (rel.replace(os.sep, "__") + ".npy")
        if cached.exists():
            return np.load(cached)
        img = read_png(path)
        # a name of this process and thread: two sample workers may
        # decode one image at once
        tmp = cached.with_name(f"{cached.name}.{os.getpid()}."
                               f"{threading.get_ident()}.tmp.npy")
        np.save(tmp, img)
        os.replace(tmp, cached)
        return img

    def __len__(self) -> int:
        return len(self.names_hr)

    def _lr_path(self, hr_path: str, scale: int) -> str:
        stem = os.path.splitext(os.path.basename(hr_path))[0]
        return str(self.lr_dir / f"X{scale}" / f"{stem}x{scale}{self.file_ext}")

    def sample(self, idx: int,
               rng: Optional[np.random.Generator] = None) -> Sample:
        """{scale: (lr, hr, name)} in [0, 1], float32; ``rng`` is needed
        for patches and augmentation (drawn as top, left, then the three
        flips, per scale)."""
        path = self.names_hr[idx]
        name = os.path.splitext(os.path.basename(path))[0]
        hr_img = self._read(path).astype(np.float32)
        out: Sample = {}
        for scale in self.scales:
            lr_img = self._read(self._lr_path(path, scale)).astype(np.float32)
            if self.patch_size == 0:
                lh, lw = lr_img.shape[:2]
                hr_c = hr_img[: lh * scale, : lw * scale]
                lr_c = lr_img
            else:
                ps = self.patch_size
                top = int(rng.integers(0, lr_img.shape[0] - ps + 1))
                left = int(rng.integers(0, lr_img.shape[1] - ps + 1))
                lr_c = lr_img[top:top + ps, left:left + ps]
                hr_c = hr_img[top * scale:(top + ps) * scale,
                              left * scale:(left + ps) * scale]
            pair = [lr_c, hr_c]
            if self.augment:
                pair = _augment(pair, rng)
            out[scale] = (pair[0] / 255.0, pair[1] / 255.0, name)
        return out


class SyntheticSRDataset:
    """Deterministic random-image dataset (no files needed)."""

    def __init__(self, n_images: int = 16, image_size: int = 256,
                 scales: Sequence[float] = (2, 3, 4), patch_size: int = 48,
                 augment: bool = True, seed: int = 0):
        self.n = n_images
        self.image_size = image_size
        self.scales = list(scales)
        self.patch_size = patch_size
        self.augment = augment
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def _image(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.image_size
        # smooth-ish random image: low-res noise upsampled + fine noise
        base = rng.random((s // 8, s // 8, 3)).astype(np.float32)
        img = resize_np(base, (s, s))
        img = img + 0.1 * rng.standard_normal((s, s, 3)).astype(np.float32)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def sample(self, idx: int,
               rng: Optional[np.random.Generator] = None) -> Sample:
        return _samples(self._image(idx), self.scales, self.patch_size,
                        self.augment, rng, f"synthetic_{idx:04d}")
