"""The port's binding of its native C++ loader
(``tpu_diinn_torch/csrc/loader.cc``, a copy of the JAX package's
``native/loader.cc``) against the port's Python path and against
``tpu_diinn.native.loader``.

Tolerances are the JAX package's own (``tests/test_native_loader.py``):
decode exact, resize 1e-4, sample_patch 1e-6, dataset samples 1e-5,
against the Python path. Against the JAX binding (the same source built
into another library, with the same inputs) every function is exact.
Samples come from committed images under ``data/``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_diinn.data import datasets as jds
from tpu_diinn.native import loader as jnl
from tpu_diinn_torch.core.resize import resize_np
from tpu_diinn_torch.data import datasets as tds
from tpu_diinn_torch.data import pipeline as tpipe
from tpu_diinn_torch.data.png import read_png
from tpu_diinn_torch.native import loader as nl

REPO = Path(__file__).resolve().parents[1]
JPEG = REPO / "tpu_diinn_torch/testdata/set5_img0000_q90.jpg"
IMAGES = [REPO / "data/DIV2K/DIV2K_train_HR/0000.png",
          REPO / "data/benchmark/Set5/HR/img0002.png"]
DIV2K = dict(root=str(REPO / "data"), name="DIV2K", split="train",
             scales=[2, 3, 4], patch_size=48, augment=True)


@pytest.fixture(autouse=True)
def loader():
    """Skip (printing the build's error) where the loader did not build;
    decided here, not at import, so that every worker collects the same
    tests."""
    if not nl.available():
        print(f"native loader unavailable: {nl.build_error()}")
        pytest.skip(f"native loader unavailable: {nl.build_error()}")


def _flip(x, hf, vf, df):
    if hf:
        x = x[::-1]
    if vf:
        x = x[:, ::-1]
    if df:
        x = np.transpose(x, (1, 0, 2))
    return x


def test_builds_its_own_library():
    path = nl.library_path()
    assert path.exists()
    assert path.parent.parent == REPO / "build" / "tpu_diinn_torch"
    assert path.name != "libtpudiinn_loader.so"


def test_builds_from_the_ports_own_source():
    """The library is compiled from the port's copy of the source, not
    from the JAX package's file."""
    assert nl.SOURCE == REPO / "tpu_diinn_torch" / "csrc" / "loader.cc"
    assert nl.SOURCE.exists()
    assert REPO / "native" / "loader.cc" != nl.SOURCE


_CORRUPT_JPEG = r"""
import sys
from tpu_diinn_torch.native import loader as nl
path = sys.argv[1]
for fn in (nl.image_size, nl.decode_image):
    try:
        fn(path)
    except OSError:
        continue
    raise SystemExit(f"{fn.__name__} did not raise")
try:
    nl.sample_batch([path], [0], [0], 8, 4, [0], [0], [0], n_threads=1)
except OSError:
    print("raised")
"""


@pytest.mark.parametrize("body", [b"\x00" * 64, bytes(range(256)) * 4],
                         ids=["zeros", "ramp"])
def test_corrupt_jpeg_raises_and_the_process_goes_on(tmp_path, body):
    """A file with JPEG's magic bytes and a body libjpeg cannot decode
    raises in every entry point; the process that called them exits 0
    (libjpeg's default error handler would end it)."""
    path = tmp_path / "corrupt.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + body)
    out = subprocess.run([sys.executable, "-c", _CORRUPT_JPEG, str(path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "raised"


def test_committed_jpeg_decodes_as_before():
    """The committed JPEG decodes to the JAX binding's bytes (built from
    the unchanged ``native/loader.cc``) and to PIL's within libjpeg's
    version wiggle."""
    from PIL import Image
    got = nl.decode_image(str(JPEG))
    np.testing.assert_array_equal(got, jnl.decode_image(str(JPEG)))
    assert nl.image_size(str(JPEG)) == got.shape[:2] == (256, 256)
    want = np.asarray(Image.open(JPEG).convert("RGB"))
    assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 2.0


@pytest.mark.parametrize("path", IMAGES, ids=lambda p: p.name)
def test_decode_matches_python_path_and_jax(path):
    got = nl.decode_image(str(path))
    np.testing.assert_array_equal(got, read_png(str(path)))
    np.testing.assert_array_equal(got, jnl.decode_image(str(path)))
    assert nl.image_size(str(path)) == got.shape[:2]


def test_decode_jpeg_matches_jax_and_pil(tmp_path):
    from PIL import Image
    src = read_png(str(IMAGES[1]))[:40, :53]
    path = tmp_path / "t.jpg"
    Image.fromarray(src).save(path, quality=95)
    got = nl.decode_image(str(path))
    np.testing.assert_array_equal(got, jnl.decode_image(str(path)))
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.shape == want.shape == (40, 53, 3)
    # both decode one stream; the JAX test allows libjpeg version wiggle
    assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 2.0


def test_demo_reads_jpeg_through_the_loader(tmp_path):
    from PIL import Image
    from tpu_diinn_torch.cli import demo
    src = read_png(str(IMAGES[1]))
    jpg = tmp_path / "in.jpeg"
    Image.fromarray(src).save(jpg, quality=90)
    got = demo._load_image(str(jpg))
    np.testing.assert_array_equal(
        got, nl.decode_image(str(jpg)).astype(np.float32)[None] / 255.0)
    png = demo._load_image(str(IMAGES[1]))        # PNG: the Python reader
    np.testing.assert_array_equal(
        png, src.astype(np.float32)[None] / 255.0)


@pytest.mark.parametrize("in_size,out_size", [
    ((97, 151), (48, 48)), ((48, 48), (97, 151)), ((64, 64), (64, 64)),
])
def test_resize_matches_python_path_and_jax(in_size, out_size):
    img = np.random.default_rng(3).random((*in_size, 3)).astype(
        np.float32) * 255
    got = nl.resize_bicubic(img, out_size)
    np.testing.assert_allclose(got, resize_np(img, out_size), atol=1e-4)
    np.testing.assert_array_equal(got, jnl.resize_bicubic(img, out_size))


@pytest.mark.parametrize("flips", [(1, 0, 1), (0, 1, 0), (1, 1, 1)])
def test_sample_patch_matches_python_path_and_jax(flips):
    img8 = read_png(str(IMAGES[0]))
    lr, hr = nl.sample_patch(img8, 10, 20, 144, 48, *map(bool, flips))
    crop = img8[10:154, 20:164].astype(np.float32)
    np.testing.assert_allclose(
        lr, _flip(resize_np(crop, (48, 48)), *flips) / 255.0, atol=1e-6)
    np.testing.assert_allclose(hr, _flip(crop, *flips) / 255.0, atol=1e-6)
    jlr, jhr = jnl.sample_patch(img8, 10, 20, 144, 48, *map(bool, flips))
    np.testing.assert_array_equal(lr, jlr)
    np.testing.assert_array_equal(hr, jhr)


def test_sample_batch_threaded_on_committed_data():
    paths = [str(IMAGES[0])] * 4 + [str(IMAGES[1])] * 2
    args = ([0, 5, 100, 312, 17, 160], [0, 9, 200, 312, 3, 0], 96, 48,
            [0, 1, 0, 1, 1, 0], [1, 0, 0, 1, 0, 1], [0, 0, 1, 1, 0, 1])
    lrs, hrs = nl.sample_batch(paths, *args, n_threads=3)
    assert lrs.shape == (6, 48, 48, 3) and hrs.shape == (6, 96, 96, 3)
    assert np.isfinite(lrs).all() and np.isfinite(hrs).all()
    assert not np.allclose(lrs[0], lrs[1])
    tops, lefts, hps, ps, hf, vf, df = args
    for i, p in enumerate(paths):
        lr, hr = nl.sample_patch(read_png(p), tops[i], lefts[i], hps, ps,
                                 bool(hf[i]), bool(vf[i]), bool(df[i]))
        np.testing.assert_array_equal(lrs[i], lr)
        np.testing.assert_array_equal(hrs[i], hr)
    jlrs, jhrs = jnl.sample_batch(paths, *args, n_threads=3)
    np.testing.assert_array_equal(lrs, jlrs)
    np.testing.assert_array_equal(hrs, jhrs)


def test_sample_batch_reports_failures():
    with pytest.raises(IOError):
        nl.sample_batch([str(IMAGES[1])], [250], [0], 96, 48, [0], [0], [0])


def test_sample_patch_rejects_out_of_range():
    img8 = np.zeros((50, 50, 3), np.uint8)
    with pytest.raises(ValueError):
        nl.sample_patch(img8, 40, 40, 20, 10, False, False, False)


@pytest.mark.parametrize("idx", [0, 7, 151])
def test_dataset_native_matches_python_path_and_jax(idx):
    d_native = tds.SRDatasetDownsample(use_native=True, **DIV2K)
    d_python = tds.SRDatasetDownsample(use_native=False, **DIV2K)
    j_native = jds.SRDatasetDownsample(use_native=True, **DIV2K)
    assert d_native.native and not d_python.native
    assert j_native._native is not None
    s_n = d_native.sample(idx, np.random.default_rng(55 + idx))
    s_p = d_python.sample(idx, np.random.default_rng(55 + idx))
    s_j = j_native.sample(idx, np.random.default_rng(55 + idx))
    assert list(s_n) == list(s_p) == [2, 3, 4]
    for scale in s_n:
        for k in (0, 1):
            assert s_n[scale][k].dtype == np.float32
            np.testing.assert_allclose(s_n[scale][k], s_p[scale][k],
                                       atol=1e-5)
            np.testing.assert_array_equal(s_n[scale][k], s_j[scale][k])


def test_eval_samples_native_match_python_path():
    kw = dict(DIV2K, patch_size=0, augment=False, scales=[2, 3.5])
    s_n = tds.SRDatasetDownsample(use_native=True, **kw).sample(3)
    s_p = tds.SRDatasetDownsample(use_native=False, **kw).sample(3)
    for scale in s_n:
        np.testing.assert_array_equal(s_n[scale][0], s_p[scale][0])
        np.testing.assert_array_equal(s_n[scale][1], s_p[scale][1])


def test_train_batches_native_match_python_path():
    """The pipeline's batches (made in the calling process) from the two
    paths, first two batches of epoch 0."""
    args = dict(batch_size=4, epoch=0, seed=123, repeat=20, num_workers=0)
    a = tpipe.train_batches(tds.SRDatasetDownsample(use_native=True,
                                                    **DIV2K), **args)
    b = tpipe.train_batches(tds.SRDatasetDownsample(use_native=False,
                                                    **DIV2K), **args)
    for _ in range(2):
        x, y = next(a), next(b)
        for s in x:
            np.testing.assert_allclose(x[s][0], y[s][0], atol=1e-5)
            np.testing.assert_allclose(x[s][1], y[s][1], atol=1e-5)
    a.close()
    b.close()
