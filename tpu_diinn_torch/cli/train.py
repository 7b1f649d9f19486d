"""Training CLI:

    python -m tpu_diinn_torch.cli.train [--max-steps N] [--device cuda|cpu]
        [-c config.json] [key=value ...]

Counterpart of ``tpu_diinn/cli/train.py``. The defaults are the flagship
configuration (``config/config.py``: RDN-B, DIINN mode 3, hidden 4 x 256,
fp32, batch 4, 48-px LR patches at scales {2, 3, 4}, Adam 1e-4); ``-c``
takes a JSON file of the same nested layout, and ``a.b=c`` overrides win
over both (e.g. ``data.synthetic=true``, ``data.train_scales=[2,2.5]``).

Several ranks, one device each, under torchrun:

    torchrun --nproc_per_node=N -m tpu_diinn_torch.cli.train \
        trainer.mesh_data=D trainer.mesh_space=S [key=value ...]

joins the process group from torchrun's environment before anything is
built (NCCL on the card, gloo with ``--device cpu``), and each rank takes
``cuda:LOCAL_RANK``. ``D x S`` must be N (``mesh_data=-1``, the default,
is N // S): the batch is split over D, and each scale's HR grid over S
in column stripes (``train/loop.py``).

Runs on the card by default. ``--device cuda`` on a host without CUDA
raises; it does not fall back to the CPU. TF32 is turned off for cuBLAS
and cuDNN, so in fp32 the encoder trains in full fp32 as the JAX package
does. ``model.dtype=bfloat16`` is the JAX package's bf16 mode: every conv
and dense layer computes in bf16 over fp32 parameters, the decoder runs
its bf16 kernel instances, the loss is fp32 over the bf16 prediction, and
the gradients and Adam's state stay fp32.
"""

from __future__ import annotations

import argparse
import json

from tpu_diinn_torch.cli.benchmarks import resolve_device
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.parallel.mesh import local_device, maybe_init_distributed
from tpu_diinn_torch.train import loop


def main(argv=None) -> loop.TrainState:
    parser = argparse.ArgumentParser(description="tpu_diinn_torch trainer")
    parser.add_argument("-c", "--config", default=None,
                        help="JSON config file (nested dict)")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args, overrides = parser.parse_known_args(argv)
    device = resolve_device(args.device)
    if maybe_init_distributed(device.type):
        device = local_device(device.type)
    tree = None
    if args.config:
        with open(args.config) as f:
            tree = json.load(f)
    cfg = load_config(tree, overrides)
    return loop.train(cfg, max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
