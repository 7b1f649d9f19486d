"""Benchmark-set evaluation CLI:

    python -m tpu_diinn_torch.cli.benchmarks --ckpt_path results/flagship_weights.npz \
        [--scales 3.14 4 8] [--testsets B100 Set5 Set14 Urban100] \
        [--max_images N] [--eval_buckets QUANTUM] [--device cuda|cpu] \
        [key=value ...]
    python -m tpu_diinn_torch.cli.benchmarks --bicubic_test [...]

Counterpart of ``tpu_diinn/cli/benchmarks.py``: PSNR/SSIM/LR-PSNR per scale
on the benchmark sets, printed as one JSON object per set and, last, one
line of JSON with every set's metrics. The checkpoint's embedded config
picks the model (``model.arch``: DIINN, LIIF or MetaSR); ``key=value``
overrides win over it (e.g. ``model.use_fused=false`` runs the eager
decoder instead of the CUDA kernels). ``--bicubic_test`` evaluates the
bicubic baseline (the default config with ``model.arch=bicubic``, no
weights).

By default a model is evaluated on the bucketed static-shape route
(``train/bucketed.py``), as the JAX CLI does: each image is padded to a
bucket canvas (sides rounded up to ``--eval_buckets``, 64) and run by the
bucket's program, on the card one CUDA graph captured once and replayed
for every image of the bucket. ``--eval_buckets 0`` evaluates each image
at its exact shape; so do ``--bicubic_test`` and a model outside the
bucketed scope (DIINN mode 4), which the CLI says.

Runs on the card by default. ``--device cuda`` on a host without CUDA
raises; it does not fall back to the CPU. TF32 is turned off for cuBLAS
and cuDNN, so in fp32 (``model.dtype=float32``) the encoder's convs and
SSIM's gaussian convs run in full fp32. ``model.dtype=bfloat16`` is the
JAX package's bf16 mode: the encoder and the decoder compute in bf16 over
the fp32 weights (the decoder kernels' bf16 instances), the prediction is
bf16, and the metrics are taken in fp32 over it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tpu_diinn_torch.config.config import _set_dotted, load_config
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.bucketed import BucketedEval, BucketedUnsupported
from tpu_diinn_torch.train.checkpoint import (load_params_npz,
                                              state_dict_from_jax)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: CUDA is not available on "
                               f"this host (pass --device cpu to run on the "
                               f"CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="compact .npz weights export")
    p.add_argument("--bicubic_test", action="store_true",
                   help="evaluate the bicubic baseline (no weights)")
    p.add_argument("--root", type=str, default="./data/")
    p.add_argument("--scales", type=float, nargs="+", default=[3.14, 4, 8])
    p.add_argument("--testsets", type=str, nargs="+",
                   default=["B100", "Set5", "Set14", "Urban100"])
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--eval_buckets", type=int, default=64, metavar="QUANTUM",
                   help="bucket quantum for static-shape eval (0 = exact "
                        "per-shape eval)")
    p.add_argument("--device", type=str, default="cuda")
    args, overrides = p.parse_known_args(argv)
    if args.bicubic_test == (args.ckpt_path is not None):
        p.error("give one of --ckpt_path and --bicubic_test")
    device = resolve_device(args.device)

    if args.bicubic_test:
        cfg = load_config(None, ["model.arch=bicubic"] + overrides)
        task = loop.build_task(cfg, device=device)
    else:
        flat, meta = load_params_npz(args.ckpt_path)
        # checkpoint config first, THEN command-line overrides
        cfg = load_config(meta["config"])
        for ov in overrides:
            key, _, val = ov.lstrip("-").partition("=")
            _set_dotted(cfg, key, val)
        task = loop.build_task(cfg, device=device)
        task.net.load_state_dict(state_dict_from_jax(flat), strict=True)

    cfg.data.root = args.root
    cfg.data.test_scales = list(args.scales)
    cfg.data.testsets = [
        ("DIV2K", "train") if name == "DIV2K" else ("benchmark", name)
        for name in args.testsets]
    datasets = loop.make_test_datasets(cfg)

    evaluator = None
    if args.eval_buckets and not args.bicubic_test:
        try:
            evaluator = BucketedEval(task, quantum=args.eval_buckets)
        except BucketedUnsupported as e:
            print(f"[bucketed eval unavailable: {e}; exact-shape eval]")

    results = {}
    t0 = time.time()
    for name, dset in datasets.items():
        if len(dset) == 0:
            print(f"[skip] {name}: no images under {args.root}")
            continue
        res = loop.test_metrics(task, dset, max_images=args.max_images,
                                device=device, evaluator=evaluator)
        results[name] = res
        print(name, json.dumps(res, indent=2))
    if evaluator is not None:
        print(f"[bucketed eval: {evaluator.n_programs} programs, "
              f"{time.time() - t0:.1f}s total]")
    print(f"[eval: {time.time() - t0:.1f}s on {device}]")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
