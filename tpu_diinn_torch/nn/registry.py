"""Model/encoder registry (counterpart of ``tpu_diinn/nn/registry.py``).

Contract: ``net(x_lr, size, bsize) -> sr`` with NHWC tensors, for every
architecture: ``diinn``, ``liif``, ``metasr`` and ``bicubic``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpu_diinn_torch.nn.edsr import EDSRBaseline
from tpu_diinn_torch.nn.rdn import RDN

ENCODERS = {
    # spec: (class, kwargs)
    "rdn": (RDN, dict(growth0=64, config="B")),
    "rdn-tiny": (RDN, dict(growth0=16, config="tiny")),
    "edsr-baseline": (EDSRBaseline, dict(n_resblocks=16, n_feats=64)),
    "edsr-baseline-tiny": (EDSRBaseline, dict(n_resblocks=2, n_feats=16)),
}


def make_encoder(spec: str, *,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 halo=None) -> nn.Module:
    """Encoder ``spec`` with its convs computing in ``dtype``; ``halo``:
    the mesh axis its input rows are sharded over (``nn/layers.Conv``)."""
    cls, kwargs = ENCODERS[spec]
    return cls(generator=generator, dtype=dtype, halo=halo, **kwargs)


def encoder_out_dim(spec: str) -> int:
    """Channels of the feature grid that encoder ``spec`` returns."""
    cls, kwargs = ENCODERS[spec]
    return kwargs["growth0"] if cls is RDN else kwargs["n_feats"]


def make_net(arch: str, *, mode: int = 3, init_q: bool = False,
             encoder_spec: str = "rdn",
             hidden_dims: Optional[Sequence[int]] = None,
             use_fused: Optional[bool] = None,
             generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32) -> nn.Module:
    """Model ``arch``; ``dtype`` is its compute dtype (float32, or
    bfloat16: bf16 compute over float32 parameters). ``mode``, ``init_q``
    and ``use_fused`` are DIINN's; ``hidden_dims`` is DIINN's decoder and
    LIIF's imnet; the bicubic baseline takes none of them."""
    from tpu_diinn_torch.nn.bicubic import BicubicNet
    from tpu_diinn_torch.nn.diinn import DIINN
    from tpu_diinn_torch.nn.liif import LIIF
    from tpu_diinn_torch.nn.metasr import MetaSR
    kw = dict(encoder_spec=encoder_spec, generator=generator, dtype=dtype)
    if arch == "diinn":
        if hidden_dims is not None:
            kw["hidden_dims"] = tuple(hidden_dims)
        return DIINN(mode=mode, init_q=init_q, use_fused=use_fused, **kw)
    if arch == "liif":
        if hidden_dims is not None:
            kw["hidden"] = tuple(hidden_dims)
        return LIIF(**kw)
    if arch == "metasr":
        return MetaSR(feat_dim=encoder_out_dim(encoder_spec), **kw)
    if arch == "bicubic":
        return BicubicNet()
    raise ValueError(f"unknown arch: {arch!r}")
