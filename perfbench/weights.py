"""Seeded weights, made on the device in one call.

Every parameter of ``reference.diinn.param_spec`` is drawn from the
torch default initialisation U(-1/sqrt(fan_in), 1/sqrt(fan_in)): one
``torch.rand`` of all the parameters' elements from a generator on the
device seeded with ``--seed``, cut into the parameters and scaled. The
same tensors go to the program (``load_state_dict``) and the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.diinn import param_spec


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = param_spec(config)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan_in in spec:
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = ((u[at:at + n] * 2 - 1) * bound).view(shape)
        at += n
    return out
