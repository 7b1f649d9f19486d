"""Benchmark: decoded pixels/s per card, forward + backward + Adam, for the
flagship DIINN at x4.

    python -m tpu_diinn_torch.bench [--device cuda|cpu] [key=value ...]

Counterpart of the JAX package's ``bench.py``, doing the same work: the
flagship model (RDN-B encoder + mode-3 dual-MLP implicit decoder) in bf16
compute over fp32 parameters, training steps on batch 16 of random 48x48
LR patches decoded at x4 (192x192 out): 2 warm-up steps, then 30 timed
steps between two ``torch.cuda.synchronize`` calls. The secondary
reference configuration is the training default, batch 4 at joint scales
{2, 3, 4}: 2 warm-up steps, 20 timed.

Prints one JSON line: ``metric``, ``value``, ``unit``, ``batch``,
``steps_per_s``, ``model_tflops_per_s``, ``mfu_bf16`` (the model FLOPs of
``train/flops.py`` over the card's own bf16 peak), ``flops_split``,
``ref_config_ms_per_step``, ``ref_config_pix_s``, the ``dtype`` and the
card's ``device`` name with its power limit. It states no baseline: the
JAX bench's is a TPU number.

Runs on the card by default; ``--device cpu`` (and small ``key=value``
overrides, applied after the bench's own, e.g. ``data.batch_size=1
data.patch_size=8 model.encoder=rdn-tiny``) is for the tests only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.train import flops as F
from tpu_diinn_torch.train import loop


def card_name_and_power(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    device type and no limit on the CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True).stdout.strip()
        name, power = (x.strip() for x in out.split(",", 1))
    except (OSError, subprocess.CalledProcessError, ValueError):
        name, power = torch.cuda.get_device_name(device), None
    return {"name": name, "power_limit": power}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(cfg, batch: dict, device: torch.device, *, warmup: int,
               iters: int) -> float:
    """Seconds per training step (forward, backward, Adam) of ``cfg``'s net
    on ``batch`` (numpy {scale: (lr, hr)}), after ``warmup`` steps."""
    state = loop.init_state(cfg, 1000, device=device)
    step = loop.make_train_step(state)
    b = loop.to_device(batch, device)
    for _ in range(warmup):
        step(b)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        m = step(b)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    if not np.isfinite(float(m["loss"])):
        raise RuntimeError(f"non-finite loss {float(m['loss'])}")
    return dt


def _random_batch(rng, batch: int, patch: int, scales) -> dict:
    return {s: (rng.random((batch, patch, patch, 3)).astype(np.float32),
                rng.random((batch, round(patch * s), round(patch * s), 3)
                           ).astype(np.float32))
            for s in scales}


# The JAX bench's configuration: batch 16 of 48-px patches at x4, and the
# training default (batch 4 at joint scales {2, 3, 4}) as the reference.
MAIN = ["data.batch_size=16", "data.patch_size=48", "data.train_scales=[4]"]
REF = ["data.batch_size=4", "data.patch_size=48", "data.train_scales=[2,3,4]"]
WARMUP, ITERS, REF_ITERS = 2, 30, 20


def _timed(base: list, overrides: Sequence[str], rng, device, iters: int):
    """(cfg, seconds per step) of ``base`` then ``overrides`` on a random
    batch of the configuration's own size."""
    cfg = load_config(None, [*base, *overrides])
    d = cfg.data
    dt = time_steps(cfg, _random_batch(rng, d.batch_size, d.patch_size,
                                       d.train_scales),
                    device, warmup=WARMUP, iters=iters)
    return cfg, dt


def _pixels(cfg) -> int:
    d = cfg.data
    return d.batch_size * sum(round(d.patch_size * s) ** 2
                              for s in d.train_scales)


def run(device="cuda", overrides: Sequence[str] = ()) -> dict:
    """The bench's JSON record (see the module docstring). ``overrides``
    apply after the bench's own configuration."""
    device = torch.device(device)
    if device.type == "cuda":
        from tpu_diinn_torch.cli.benchmarks import resolve_device
        device = resolve_device(str(device))
    base = ["model.arch=diinn", "model.dtype=bfloat16"]
    rng = np.random.default_rng(0)
    cfg, step_t = _timed(base + MAIN, overrides, rng, device, ITERS)
    cfg_ref, dt_ref = _timed(base + REF, overrides, rng, device, REF_ITERS)

    m, d = cfg.model, cfg.data
    fl = F.train_step_flops(d.batch_size, d.patch_size, d.train_scales,
                            encoder=m.encoder,
                            hidden_dims=m.hidden_dims or (256,) * 4)
    mfu = (F.mfu(fl["total"], step_t, chip=F.sku(
        torch.cuda.get_device_name(device)), dtype="bfloat16")
        if device.type == "cuda" else None)
    return {
        "metric": "decoded_pixels_per_s_per_chip_fwd_bwd_x4",
        "value": _pixels(cfg) / step_t,
        "unit": "pixels/s",
        "batch": d.batch_size,
        "steps_per_s": 1.0 / step_t,
        "model_tflops_per_s": fl["total"] / step_t / 1e12,
        "mfu_bf16": mfu,
        "flops_split": {k: v / fl["total"] for k, v in fl.items()
                        if k != "total"},
        "ref_config_ms_per_step": dt_ref * 1e3,
        "ref_config_pix_s": _pixels(cfg_ref) / dt_ref,
        "dtype": m.dtype,
        "device": card_name_and_power(device),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="tpu_diinn_torch bench")
    p.add_argument("--device", type=str, default="cuda")
    args, overrides = p.parse_known_args(argv)
    out = run(args.device, overrides)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
