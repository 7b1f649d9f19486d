"""The port's ``SRDatasetPaired`` (pre-generated LR/HR pairs and their
``.npy`` cache) against the JAX package's, on one tree of PNGs written by
the port's ``write_png`` from numpy seeds: for the same
``np.random.default_rng`` seed both must give bit-equal samples, with the
cache off, on its first read (which writes it) and on a cached read; the
cache files must have JAX's names and contents. Exact: both decode the
same bytes and draw the same numbers in the same order."""

import os
import shutil

import numpy as np
import pytest

from tpu_diinn.data import pipeline as jpipeline
from tpu_diinn.data.datasets import SRDatasetPaired as JPaired
from tpu_diinn_torch.data import pipeline
from tpu_diinn_torch.data.datasets import SRDatasetPaired
from tpu_diinn_torch.data.png import write_png

HR_SHAPES = [(40, 45), (41, 38), (44, 44)]   # LR at x4: 10x11, 10x9, 11x11
SCALES = (2, 3, 4)


def _write_tree(root):
    """DIV2K train HR images and their LR_bicubic/X{2,3,4} files (the LR
    content is any seeded image of the floor size: the loader only
    crops)."""
    base = root / "DIV2K"
    hr_dir = base / "DIV2K_train_HR"
    hr_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(HR_SHAPES):
        rng = np.random.default_rng(100 + i)
        stem = f"{i:04d}"
        write_png(str(hr_dir / f"{stem}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        for s in SCALES:
            lr_dir = base / "DIV2K_train_LR_bicubic" / f"X{s}"
            lr_dir.mkdir(parents=True, exist_ok=True)
            write_png(str(lr_dir / f"{stem}x{s}.png"),
                      rng.integers(0, 256, (h // s, w // s, 3),
                                   dtype=np.uint8))


@pytest.fixture
def trees(tmp_path):
    """Two copies of one tree: the port's cache and JAX's stay apart."""
    _write_tree(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    return tmp_path / "port", tmp_path / "jax"


def _samples(ds, seed):
    return [ds.sample(i, np.random.default_rng(seed + i))
            for i in range(len(ds))]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for s in w:
            assert g[s][2] == w[s][2]
            for a, b in zip(g[s][:2], w[s][:2]):
                assert a.dtype == b.dtype == np.float32
                assert a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("binarize", ["off", "first_read", "cached_read"])
@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("patch_size", [8, 0])
@pytest.mark.parametrize("scales", [(2,), SCALES])
def test_paired_samples_match_jax(trees, scales, patch_size, augment,
                                  binarize):
    port_root, jax_root = trees
    kw = dict(name="DIV2K", split="train", scales=scales,
              patch_size=patch_size, augment=augment,
              binarize=binarize != "off")
    port = SRDatasetPaired(root=str(port_root), **kw)
    jax_ds = JPaired(root=str(jax_root), **kw)
    assert len(port) == len(jax_ds) == len(HR_SHAPES)
    if binarize == "cached_read":
        _samples(port, 0), _samples(jax_ds, 0)     # write the caches
    got, want = _samples(port, 7), _samples(jax_ds, 7)
    _assert_equal(got, want)
    if binarize != "off":
        # the cache gives the samples of the PNGs
        plain = SRDatasetPaired(root=str(port_root), **{**kw,
                                                        "binarize": False})
        _assert_equal(got, _samples(plain, 7))
    for s in scales:
        lr, hr, name = got[0][s]
        if patch_size:
            assert lr.shape == (8, 8, 3) and hr.shape == (8 * s, 8 * s, 3)
        else:
            h, w = HR_SHAPES[0]
            assert lr.shape == (h // s, w // s, 3)
            assert hr.shape == ((h // s) * s, (w // s) * s, 3)


def test_paired_cache_files_equal_jax(trees):
    port_root, jax_root = trees
    kw = dict(scales=SCALES, patch_size=8, binarize=True)
    _samples(SRDatasetPaired(root=str(port_root), **kw), 0)
    _samples(JPaired(root=str(jax_root), **kw), 0)
    port_bin, jax_bin = port_root / "DIV2K" / "bin", jax_root / "DIV2K" / "bin"
    names = sorted(os.listdir(port_bin))
    assert names == sorted(os.listdir(jax_bin))
    assert len(names) == len(HR_SHAPES) * (1 + len(SCALES))
    assert "DIV2K_train_LR_bicubic__X3__0001x3.png.npy" in names
    assert not [n for n in names if ".tmp" in n]
    for n in names:
        a, b = np.load(port_bin / n), np.load(jax_bin / n)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("binarize", [False, True])
def test_paired_missing_lr_file_raises(trees, binarize):
    port_root, jax_root = trees
    for root in trees:
        os.remove(root / "DIV2K" / "DIV2K_train_LR_bicubic" / "X3"
                  / "0001x3.png")
    kw = dict(scales=SCALES, patch_size=8, binarize=binarize)
    port = SRDatasetPaired(root=str(port_root), **kw)
    jax_ds = JPaired(root=str(jax_root), **kw)
    port.sample(0, np.random.default_rng(0))
    for ds in (port, jax_ds):
        with pytest.raises(FileNotFoundError):
            ds.sample(1, np.random.default_rng(0))


def test_paired_non_integer_scale_raises(trees):
    port_root, jax_root = trees
    with pytest.raises(ValueError, match="integer scales"):
        SRDatasetPaired(root=str(port_root), scales=(2, 2.5))
    # JAX's has no LR_bicubic/X2.5 to read
    with pytest.raises(FileNotFoundError):
        JPaired(root=str(jax_root), scales=(2, 2.5), patch_size=8).sample(
            0, np.random.default_rng(0))


def test_paired_train_batches_match_jax(trees):
    """``train_batches`` takes the paired set as any other: the port's
    batches (samples made in this process) equal JAX's."""
    port_root, jax_root = trees
    kw = dict(scales=SCALES, patch_size=8, binarize=True)
    port = SRDatasetPaired(root=str(port_root), **kw)
    jax_ds = JPaired(root=str(jax_root), **kw)
    got = list(pipeline.train_batches(port, batch_size=2, epoch=1, seed=5,
                                      repeat=2, num_workers=0))
    want = list(jpipeline.train_batches(jax_ds, batch_size=2, epoch=1,
                                        seed=5, repeat=2, num_workers=1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w) == list(SCALES)
        for s in SCALES:
            for a, b in zip(g[s], w[s]):
                np.testing.assert_array_equal(a, np.asarray(b))
