"""Model/encoder registry (counterpart of ``tpu_diinn/nn/registry.py``).

Contract: ``net(x_lr, size, bsize) -> sr`` with NHWC tensors. Names the JAX
package knows but the port does not have yet raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpu_diinn_torch.nn.rdn import RDN

ENCODERS = {
    # spec: (class, kwargs)
    "rdn": (RDN, dict(growth0=64, config="B")),
    "rdn-tiny": (RDN, dict(growth0=16, config="tiny")),
}

_NOT_YET = {
    "edsr-baseline": "ROADMAP A8 (other model families)",
    "edsr-baseline-tiny": "ROADMAP A8 (other model families)",
    "liif": "ROADMAP A8 (other model families)",
    "metasr": "ROADMAP A8 (other model families)",
    "bicubic": "ROADMAP A7 (nn/bicubic.py)",
}


def make_encoder(spec: str, *,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    if spec in _NOT_YET:
        raise NotImplementedError(f"encoder {spec!r}: {_NOT_YET[spec]}")
    cls, kwargs = ENCODERS[spec]
    return cls(generator=generator, **kwargs)


def make_net(arch: str, *, mode: int = 3, init_q: bool = False,
             encoder_spec: str = "rdn",
             hidden_dims: Optional[Sequence[int]] = None,
             use_fused: Optional[bool] = None,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    from tpu_diinn_torch.nn.diinn import DIINN
    if arch == "diinn":
        kw = dict(mode=mode, init_q=init_q, encoder_spec=encoder_spec,
                  use_fused=use_fused, generator=generator)
        if hidden_dims is not None:
            kw["hidden_dims"] = tuple(hidden_dims)
        return DIINN(**kw)
    if arch in _NOT_YET:
        raise NotImplementedError(f"arch {arch!r}: {_NOT_YET[arch]}")
    raise ValueError(f"unknown arch: {arch!r}")
