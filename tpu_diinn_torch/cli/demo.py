"""Demo CLI covering the reference's demo0/demo1/demo2 behaviours:

    # demo2: SR an LR image to an explicit output size
    python -m tpu_diinn_torch.cli.demo sr --lr_path img.png \
        --output_size 512 512 --ckpt_path results/flagship_weights.npz

    # demo0: downscale an HR image by --d_scale, then SR at several scales
    python -m tpu_diinn_torch.cli.demo updown --hr_path img.png \
        --d_scale 4 --scales 2 4 8 --ckpt_path results/flagship_weights.npz

    # demo1: downscale at several scales, SR each back to the original size
    python -m tpu_diinn_torch.cli.demo cycle --hr_path img.png \
        --scales 2 3 4 --ckpt_path results/flagship_weights.npz

Counterpart of ``tpu_diinn/cli/demo.py``: the same arguments, file names,
printed lines and streaming decision, plus ``--device``. Predictions go
through ``SRTask.predict`` (normalized, clamped), or through
``train/streaming.predict_streaming`` when the estimated device footprint
of a whole-image decode exceeds ``--streaming_hbm_gb`` or ``--streaming
on`` is given (DIINN only). The output is quantized as the JAX demo's
save does, ``(clip(x, 0, 1) * 255)`` truncated to uint8, in the
prediction's dtype, and written by ``data/png.write_png``.

PNG images are read by ``data/png.read_png`` (8-bit RGB or RGBA), and
``.jpg``/``.jpeg`` files by the native loader's ``decode_image`` (libjpeg;
it raises where the loader did not build, with the build's error; a JPEG
that libjpeg cannot decode ends the process, ``native/loader.py``). The
JAX demo reads any format PIL does; any other file raises with its name. The checkpoint's embedded config is merged after the ``key=value``
overrides, so it wins over them, as in the JAX demo (ROADMAP keeps this
order for parity). ``--model_name bicubic`` runs the bicubic baseline
with no weights.

Runs on the card by default. ``--device cuda`` on a host without CUDA
raises; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from tpu_diinn_torch.cli.benchmarks import resolve_device
from tpu_diinn_torch.config.config import _merge, load_config
from tpu_diinn_torch.core.resize import resize_by_scale_size, resize_np
from tpu_diinn_torch.data.png import read_png, write_png
from tpu_diinn_torch.native import loader as native_loader
from tpu_diinn_torch.nn.diinn import DIINN
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import load_params, state_dict_from_jax


def _load_image(path: str) -> np.ndarray:
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        img = native_loader.decode_image(path)
    else:
        img = read_png(path)
    return img.astype(np.float32)[None] / 255.0


def _save_image(x, path: str) -> np.ndarray:
    """Quantize ``x`` (1, H, W, 3) in [0, 1], numpy or a tensor, in its own
    dtype, write it to ``path``, and return the uint8 image."""
    t = torch.as_tensor(x)[0]
    arr = (torch.clamp(t, 0, 1) * 255).to(torch.uint8).numpy()
    Path(os.path.dirname(path) or ".").mkdir(parents=True, exist_ok=True)
    write_png(path, arr)
    print("wrote", path)
    return arr


def _predict(task, lr: np.ndarray, size, args, device):
    """Full-image prediction, streamed in row bands when the estimated
    device footprint of a whole-image decode (LR content features + HR
    output + synthesis grid) exceeds ``--streaming_hbm_gb`` or with
    ``--streaming on``, for DIINN. Returns the prediction on the host: a
    float32 numpy array when streamed, else a CPU tensor in the net's
    dtype."""
    from tpu_diinn_torch.train.streaming import predict_streaming
    h_out, w_out = size
    budget = args.streaming_hbm_gb * 1e9
    if args.streaming != "off" and isinstance(task.net, DIINN):
        h, w = lr.shape[1:3]
        n_ch = sum(task.net.decoder.hidden_dims)
        est = (h * w * n_ch * 4.0            # LR content features (fp32)
               + h_out * w_out * 3 * 4.0 * 2)  # HR output + synthesis grid
        if args.streaming == "on" or est > budget:
            band = int(budget / 8 / max(w_out * (n_ch + 6 * 256) * 4, 1))
            band = max(32, min(h_out, band))
            print(f"[streaming decode: est {est/1e9:.2f} GB > budget "
                  f"{budget/1e9:.2f} GB, band_rows={band}]"
                  if args.streaming != "on" else
                  f"[streaming decode: band_rows={band}]")
            return predict_streaming(task.net, lr, size, band_rows=band)
    with torch.inference_mode():
        return task.predict(torch.from_numpy(lr).to(device),
                            tuple(size)).cpu()


def _build(args, overrides, device):
    """The task: the bicubic baseline, or the checkpoint's net with its
    weights (the checkpoint's config merged after the overrides)."""
    if args.model_name == "bicubic":
        cfg = load_config(None, ["model.arch=bicubic"] + overrides)
        return loop.build_task(cfg, device=device)
    flat, meta = load_params(args.ckpt_path)
    cfg = load_config(None, overrides)
    _merge(cfg, meta["config"])
    task = loop.build_task(cfg, device=device)
    task.net.load_state_dict(state_dict_from_jax(flat), strict=True)
    return task


def main(argv=None) -> dict:
    """Run the demo; returns {written path: the prediction it quantized}
    (a float32 numpy array or a CPU tensor, (1, H, W, 3))."""
    p = argparse.ArgumentParser()
    p.add_argument("command", choices=["sr", "updown", "cycle"])
    p.add_argument("--lr_path", type=str)
    p.add_argument("--hr_path", type=str)
    p.add_argument("--output_size", type=int, nargs=2)
    p.add_argument("--ckpt_path", type=str)
    p.add_argument("--model_name", type=str, default="default_model")
    p.add_argument("--d_scale", type=float, default=4)
    p.add_argument("--scales", type=float, nargs="+", default=[2, 4])
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--streaming", choices=["auto", "on", "off"],
                   default="auto",
                   help="out-of-core row-band decode: auto = when the "
                        "estimated device footprint exceeds "
                        "--streaming_hbm_gb")
    p.add_argument("--streaming_hbm_gb", type=float, default=4.0)
    p.add_argument("--device", type=str, default="cuda")
    args, overrides = p.parse_known_args(argv)
    device = resolve_device(args.device)
    task = _build(args, overrides, device)
    written = {}

    def save(pred, path):
        _save_image(pred, path)
        written[path] = pred

    if args.command == "sr":
        lr = _load_image(args.lr_path)
        sr = _predict(task, lr, tuple(args.output_size), args, device)
        stem = os.path.splitext(os.path.basename(args.lr_path))[0]
        out = args.out_dir or os.path.join(
            os.path.dirname(args.lr_path) or ".", args.model_name)
        save(sr, os.path.join(
            out, f"{args.model_name}_{stem}_{args.output_size[0]}x"
                 f"{args.output_size[1]}.png"))
    elif args.command == "updown":
        hr = _load_image(args.hr_path)
        lr_size = resize_by_scale_size(hr.shape[1:3], args.d_scale)
        lr = resize_np(hr, lr_size)
        stem = os.path.splitext(os.path.basename(args.hr_path))[0]
        out = args.out_dir or os.path.join(
            os.path.dirname(args.hr_path) or ".", args.model_name)
        for s in args.scales:
            size = (int(round(lr_size[0] * s)), int(round(lr_size[1] * s)))
            sr = _predict(task, lr, size, args, device)
            save(sr, os.path.join(out, f"{args.model_name}_{stem}_x{s:g}.png"))
    elif args.command == "cycle":
        hr = _load_image(args.hr_path)
        size = hr.shape[1:3]
        stem = os.path.splitext(os.path.basename(args.hr_path))[0]
        out = args.out_dir or os.path.join(
            os.path.dirname(args.hr_path) or ".", args.model_name)
        for s in args.scales:
            lr = resize_np(hr, resize_by_scale_size(size, s))
            sr = _predict(task, lr, tuple(size), args, device)
            save(sr, os.path.join(
                out, f"{args.model_name}_{stem}_cycle_x{s:g}.png"))
    return written


if __name__ == "__main__":
    main()
