"""Phase 5a of ``chip_smoke.py`` read out for a tree, on one card.

    python3 tpu_diinn_torch/tools/train_parity.py [--tree TREE]

Runs phase 5a's three flagship training steps (``results/
flagship_weights.npz``, the first three batches of epoch 0 on
``data/DIV2K``) twice from the same weights: through the fused decoder
kernels, and through the eager decoder (cuBLAS products, autograd), and
prints each step's loss and grad norm relative to the committed JAX-CPU
oracle, with no bound applied. For the first batch it also holds each
scale's decoder forward (the kernel, and the plain version in fp32 on the
card) against the same chain in float64: the largest error, the mean
error, and how many signs of the L1 residual pred - hr (the loss's
subgradient) differ from float64's. One JSON line, with the card's name
and power limit. TREE (default: this checkout) holds the
``tpu_diinn_torch/`` to run, e.g. ``git archive <commit> tpu_diinn_torch
| tar -x -C build/tree``; data, weights and the oracle come from the
current directory, the root of a checkout. Needs a CUDA card and
``nvcc``; ``--steps 0`` reads only the forward, on the CPU (the plain
versions in place of the kernels).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ORACLE = "tpu_diinn_torch/testdata/flagship_train_jax_cpu.json"
WEIGHTS = "results/flagship_weights.npz"


def _chain64(zt, syn, p, sin_coeffs):
    """The decoder chain of ``kernels.decoder_fused._chain_ref`` in
    float64, with the polynomial sine evaluated in float64."""
    def sin(x):
        y = x - torch.round(x / (2 * math.pi)) * (2 * math.pi)
        acc = torch.full_like(y, sin_coeffs[-1])
        for c in sin_coeffs[-2::-1]:
            acc = acc * y * y + c
        return y * acc

    h = p["w0"].shape[1]
    q = torch.relu(zt[:, :h]) * sin(syn @ p["w0"] + p["b0"])
    for i in range(1, p["wcat"].shape[0] + 1):
        both = q @ p["wcat"][i - 1]
        q = (torch.relu(both[:, :h] + zt[:, i * h:(i + 1) * h])
             * sin(both[:, h:] + p["bcat"][i - 1, h:]))
    return q @ p["wl"] + p["bl"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path("."))
    ap.add_argument("--steps", type=int, default=3,
                    help="training steps per route (0: the forward only)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.core import grids
    from tpu_diinn_torch.core.fastmath import _SIN_COEFFS
    from tpu_diinn_torch.data import pipeline
    from tpu_diinn_torch.kernels import decoder_fused as K
    from tpu_diinn_torch.train import loop
    from tpu_diinn_torch.train.checkpoint import load_params_npz
    from tpu_diinn_torch.train.task import normalize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if args.steps else torch.device("cpu")
    cfg = load_config(None, [])
    train_ds, _ = loop.make_datasets(cfg, use_native=False)
    it = pipeline.train_batches(
        train_ds, batch_size=cfg.data.batch_size, epoch=0, seed=cfg.seed,
        repeat=cfg.data.trainsets_repeat, num_workers=cfg.data.num_workers)
    with open(ORACLE) as f:
        want = json.load(f)["steps"]
    want = want[:max(args.steps, 1)]
    batches = [next(it) for _ in range(len(want))]
    it.close()
    flat, _ = load_params_npz(WEIGHTS)
    spe = len(train_ds) * cfg.data.trainsets_repeat // cfg.data.batch_size
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if args.steps else "cpu"
    out = {"tree": str(args.tree), "card": smi}

    for route in ("fused", "eager") if args.steps else ():
        state = loop.init_state(cfg, spe, device=dev, params=flat)
        state.task.net.decoder.use_fused = route == "fused"
        step = loop.make_train_step(state)
        rel = []
        for batch, w in zip(batches, want):
            m = {k: float(v) for k, v in
                 step(loop.to_device(batch, dev)).items()}
            rel.append({k: abs(m[k] - w[k]) / abs(w[k])
                        for k in ("loss", "grad_norm")})
        out[f"{route}_relative_to_jax"] = rel
        del state, step

    state = loop.init_state(cfg, spe, device=dev, params=flat)
    net = state.task.net
    items = list(loop.to_device(batches[0], dev).items())
    forward = {}
    with torch.no_grad():
        feats = state.task._shared_lr_features(items)
        p = net.decoder._fused_params()
        p64 = {k: v.double() for k, v in p.items()}
        for i, (scale, (lr, hr)) in enumerate(items):
            b, h_in, w_in = lr.shape[:3]
            s = hr.shape[1] // h_in
            z = net.decoder.lr_features_stacked(feats[i * b:(i + 1) * b])
            syn = grids.syn_input_grid((h_in, w_in), hr.shape[1:3],
                                       device=dev)
            r = torch.arange(h_in * s, device=dev) // s
            c = torch.arange(w_in * s, device=dev) // s
            zt = z[:, r][:, :, c].reshape(-1, z.shape[-1]).double()
            syn64 = syn.double().expand(b, *syn.shape).reshape(-1, 3)
            ref = _chain64(zt, syn64, p64, _SIN_COEFFS).reshape(
                b, h_in * s, w_in * s, 3)
            target = normalize(hr)
            sign64 = torch.sign(ref - target.double())
            row = {}
            for name, pred in (
                    ("kernel", K.decode_int_fwd(z, syn, s, s, p)),
                    ("plain_fp32", K.decode_int_fwd_ref(z, syn, s, s, p))):
                err = (pred.double() - ref).abs()
                row[name] = {
                    "max_abs_err": err.max().item(),
                    "mean_abs_err": err.mean().item(),
                    "residual_signs_unlike_float64": int(
                        (torch.sign(pred - target) != sign64).sum())}
            forward[f"x{s}"] = row
    out["forward_vs_float64_batch1"] = forward
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
