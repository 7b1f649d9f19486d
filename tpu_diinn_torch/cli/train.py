"""Training CLI:

    python -m tpu_diinn_torch.cli.train [--max-steps N] [--device cuda|cpu]
        [-c config.json] [key=value ...]

Counterpart of ``tpu_diinn/cli/train.py``. The defaults are the flagship
configuration (``config/config.py``: RDN-B, DIINN mode 3, hidden 4 x 256,
fp32, batch 4, 48-px LR patches at scales {2, 3, 4}, Adam 1e-4); ``-c``
takes a JSON file of the same nested layout, and ``a.b=c`` overrides win
over both (e.g. ``data.synthetic=true``, ``data.train_scales=[2,2.5]``).

Runs on the card by default. ``--device cuda`` on a host without CUDA
raises; it does not fall back to the CPU. TF32 is turned off for cuBLAS
and cuDNN, so the encoder trains in full fp32 as the JAX package does.
"""

from __future__ import annotations

import argparse
import json

from tpu_diinn_torch.cli.benchmarks import resolve_device
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.train import loop


def main(argv=None) -> loop.TrainState:
    parser = argparse.ArgumentParser(description="tpu_diinn_torch trainer")
    parser.add_argument("-c", "--config", default=None,
                        help="JSON config file (nested dict)")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args, overrides = parser.parse_known_args(argv)
    device = resolve_device(args.device)
    tree = None
    if args.config:
        with open(args.config) as f:
            tree = json.load(f)
    cfg = load_config(tree, overrides)
    return loop.train(cfg, max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
