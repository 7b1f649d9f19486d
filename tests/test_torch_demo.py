"""Port parity for the demo CLI (``cli/demo.py``) and ``data/png.write_png``.

- ``sr``, ``updown`` and ``cycle`` through the JAX demo and the port's
  (``--device cpu``) on a tiny DIINN checkpoint (the compact ``.npz``
  export), one command under each of ``--streaming auto`` (with a budget
  it exceeds), ``on`` and ``off`` (the JAX demo compiles anew for every
  output shape, so the full matrix would cost a minute here for little
  more coverage): the same file names, the same printed lines (the
  ``[streaming decode: ...]`` line included), and PNGs that PIL decodes
  to images no pixel of which is more than 1 LSB apart, at most 0.1% of
  them differing: both quantize by truncation, so a prediction within
  fp32 rounding of a multiple of 1/255 may land on either side.
- ``--model_name bicubic`` (no weights) the same way.
- The checkpoint's embedded config wins over ``key=value`` overrides in
  both demos (the JAX demo's merge order, kept for parity).
- ``write_png`` read back by PIL equals the array; a file that is not a
  PNG raises with its name.

``oracle`` also made the committed JAX-CPU oracle of ``chip_smoke.py``
phase 8a (the flagship's streaming decodes of ``demo updown``):

    python -m tests.test_torch_demo --streaming-oracle \
        tpu_diinn_torch/testdata/demo_streaming_jax_cpu.json
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tpu_diinn.cli import demo as jdemo
from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.config.config import to_dict as jto_dict
from tpu_diinn_torch.cli import demo as tdemo
from tpu_diinn_torch.data.png import write_png
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.train.checkpoint import seeded_params
from tests.test_torch_train import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# a budget the tiny decodes exceed (--streaming auto streams) and bands of
# the 32-row minimum over outputs of 35-48 rows (bands that do not divide)
TINY_BUDGET = "1e-5"


def _write_tiny_ckpt(path):
    """A tiny DIINN (RDN-tiny, hidden 4 x 32) as a compact export: raw
    float32 ``seeded_params`` weights and the JAX package's config of it
    (both packages' loaders read it)."""
    overrides = ["model.encoder=rdn-tiny", "model.hidden_dims=[32,32,32,32]"]
    net = make_net("diinn", encoder_spec="rdn-tiny", hidden_dims=[32] * 4)
    meta = {"step": 0, "epoch": 0, "val_loss": 0.0,
            "config": jto_dict(jload_config(None, overrides))}
    np.savez(path, __meta__=np.str_(json.dumps(meta)),
             **seeded_params(net, 4))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    _write_tiny_ckpt(d / "tiny.npz")
    rng = np.random.default_rng(5)
    for name, hw in (("lr.png", (14, 17)), ("hr.png", (48, 40))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            d / name)
    return d


def _args(command, d, streaming):
    if command == "sr":
        args = ["sr", "--lr_path", str(d / "lr.png"), "--output_size", "35",
                "43"]
    elif command == "updown":
        args = ["updown", "--hr_path", str(d / "hr.png"), "--d_scale", "4",
                "--scales", "2.5", "4"]
    else:
        args = ["cycle", "--hr_path", str(d / "hr.png"), "--scales", "2",
                "3.5"]
    return args + ["--streaming", streaming, "--streaming_hbm_gb",
                   TINY_BUDGET]


def _run_both(args, d, tag, capsys, monkeypatch):
    """Both demos on ``args``; returns {package: (stdout lines, {file name:
    uint8 image})}, with each output directory's path replaced by
    ``<out>`` in the lines."""
    # the JAX CLI's persistent compile cache would write under $HOME
    monkeypatch.setenv("TPU_DIINN_COMPILE_CACHE", "0")
    out = {}
    for pkg, main, extra in (("jax", jdemo.main, []),
                             ("port", tdemo.main, ["--device", "cpu"])):
        out_dir = d / f"{tag}_{pkg}"
        capsys.readouterr()
        main(args + ["--out_dir", str(out_dir)] + extra)
        lines = capsys.readouterr().out.replace(str(out_dir), "<out>")
        images = {p.name: np.asarray(Image.open(p))
                  for p in sorted(out_dir.iterdir())}
        out[pkg] = (lines.splitlines(), images)
    return out


def _same_outputs(out):
    (jl, ji), (tl, ti) = out["jax"], out["port"]
    assert tl == jl
    assert list(ti) == list(ji) and ji
    for name, want in ji.items():
        got = ti[name]
        assert got.shape == want.shape and got.dtype == np.uint8, name
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (name, diff.max())
        assert np.count_nonzero(diff) <= 1e-3 * diff.size, name


@pytest.mark.parametrize("streaming,command", [
    ("auto", "sr"), ("on", "updown"), ("off", "cycle")],
    ids=["auto-sr", "on-updown", "off-cycle"])
def test_demo_matches_jax(files, command, streaming, capsys, monkeypatch):
    args = _args(command, files, streaming) + ["--ckpt_path",
                                               str(files / "tiny.npz")]
    out = _run_both(args, files, f"{command}_{streaming}", capsys,
                    monkeypatch)
    _same_outputs(out)
    streamed = any(ln.startswith("[streaming decode") for ln in out["jax"][0])
    assert streamed == (streaming != "off")


def test_demo_bicubic_matches_jax(files, capsys, monkeypatch):
    args = _args("updown", files, "auto") + ["--model_name", "bicubic"]
    out = _run_both(args, files, "bicubic", capsys, monkeypatch)
    _same_outputs(out)
    assert not any("streaming" in ln for ln in out["port"][0])


def test_checkpoint_config_wins_over_overrides(files):
    """As in the JAX demo, the checkpoint's config is merged after the
    overrides: ``model.eval_bsize`` and ``model.use_fused`` keep the
    checkpoint's values."""
    args = argparse.Namespace(model_name="default_model",
                              ckpt_path=str(files / "tiny.npz"))
    overrides = ["model.eval_bsize=7", "model.use_fused=false"]
    jtask, _ = jdemo._build(args, overrides)
    task = tdemo._build(args, overrides, "cpu")
    assert task.eval_bsize == jtask.eval_bsize == 30000
    assert task.net.decoder.use_fused is jtask.net.use_fused is None


def test_write_png_reads_back_through_pil(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (23, 31, 3),
                                            dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)


def test_demo_refuses_a_file_that_is_not_png(files, tmp_path):
    """Neither PNG nor JPEG (which the native loader reads:
    ``tests/test_torch_native_loader.py``): refused with the file's name."""
    path = tmp_path / "photo.bmp"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match="photo.bmp"):
        tdemo.main(["sr", "--lr_path", str(path), "--output_size", "16",
                    "16", "--ckpt_path", str(files / "tiny.npz"),
                    "--device", "cpu", "--out_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# The JAX-CPU oracle of chip_smoke.py phase 8a.
# ---------------------------------------------------------------------------

def oracle(path):
    """The JAX demo's ``updown`` decodes of Set5's img0000 at the smoke's
    arguments (``--d_scale 4 --scales 3.14 4 20 --streaming on
    --streaming_hbm_gb 0.6``, the flagship weights), each through the JAX
    package's ``predict_streaming`` at the band height its demo picks,
    summarized as ``chip_smoke.summarize`` does."""
    import chip_smoke as cs
    from tpu_diinn.core.resize import resize_by_scale_size, resize_np
    sys_args = cs.DEMO_UPDOWN
    p = argparse.ArgumentParser()
    p.add_argument("--hr_path")
    p.add_argument("--d_scale", type=float)
    p.add_argument("--scales", type=float, nargs="+")
    p.add_argument("--streaming")
    p.add_argument("--streaming_hbm_gb", type=float)
    p.add_argument("--ckpt_path")
    p.add_argument("--model_name", default="default_model")
    args, _ = p.parse_known_args(sys_args[1:])
    task, params = jdemo._build(args, [])
    hr = jdemo._load_image(args.hr_path)
    lr_size = resize_by_scale_size(hr.shape[1:3], args.d_scale)
    lr = resize_np(hr, lr_size)
    rec = {"made_by": "python -m tests.test_torch_demo --streaming-oracle "
                      "PATH", "args": sys_args, "outputs": {}}
    for s in args.scales:
        size = (int(round(lr_size[0] * s)), int(round(lr_size[1] * s)))
        pred = jdemo._predict(task, params, lr, size, args)
        rec["outputs"][f"x{s:g}"] = {"size": list(size),
                                     **cs.summarize(pred)}
    Path(path).write_text(json.dumps(rec, indent=1) + "\n")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] != ["--streaming-oracle"] or len(sys.argv) != 3:
        sys.exit("usage: python -m tests.test_torch_demo --streaming-oracle "
                 "PATH")
    oracle(sys.argv[2])
