"""Decode-latency comparison across model families (the reference's
``runtime_test.py``):

    python -m tpu_diinn_torch.cli.runtime_bench [--scales 2 3 4 6 8] \
        [--archs bicubic metasr liif diinn] [--iters 50] [--input 48] \
        [--encoder rdn] [--device cuda|cpu]

Counterpart of ``tpu_diinn/cli/runtime_bench.py``: the single-image
forward latency of each family on a 1 x 48 x 48 x 3 input at each scale,
printed one line per (family, scale) and last as one JSON object
``{"<arch>_x<scale>": ms}``. Each family's weights are drawn by
``checkpoint.seeded_params`` (the JAX package's ``PRNGKey(1)`` init has no
counterpart here; weights do not set the time), the input from numpy's
seed 0. Each (family, scale) is timed by ``profiling.synced_time``: 2
warm-up calls, then ``--iters`` calls between two synchronisations of the
card.

Runs on the card by default. ``--device cuda`` on a host without CUDA
raises; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tpu_diinn_torch.cli.benchmarks import resolve_device
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.train.checkpoint import (seeded_params,
                                              state_dict_from_jax)
from tpu_diinn_torch.train.profiling import synced_time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--scales", type=float, nargs="+", default=[2, 3, 4, 6, 8])
    p.add_argument("--archs", type=str, nargs="+",
                   default=["bicubic", "metasr", "liif", "diinn"])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--input", type=int, default=48)
    p.add_argument("--encoder", type=str, default="rdn")
    p.add_argument("--device", type=str, default="cuda")
    args, _ = p.parse_known_args(argv)
    device = resolve_device(args.device)

    n = args.input
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, n, n, 3)).astype(np.float32)).to(device)
    results = {}
    for arch in args.archs:
        net = make_net(arch, encoder_spec=args.encoder)
        net.load_state_dict(state_dict_from_jax(seeded_params(net, 1)),
                            strict=True)
        net.to(device)
        for s in args.scales:
            size = (int(n * s), int(n * s))
            with torch.inference_mode():
                ms = synced_time(net, x, size, iters=args.iters) * 1e3
            results[f"{arch}_x{s:g}"] = round(ms, 3)
            print(f"{arch:8s} x{s:<4g} {size[0]}x{size[1]}: {ms:8.3f} ms",
                  flush=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
