"""Residual Dense Network encoder.

Counterpart of ``tpu_diinn/nn/rdn.py``: two shallow convs, D residual dense
blocks of C concat-growing 3x3 convs plus a 1x1 local fusion, a global
fusion over the concatenated block outputs, and a residual to the first
shallow feature. Returns the (B, H, W, G0) feature grid at input resolution
(the DIINN use; the optional PixelShuffle head is not ported). NHWC in and
out; NCHW inside for ``conv2d``. ``dtype`` is every conv's compute dtype
(``nn/layers.py``): with bfloat16 the features come out bf16. ``halo``
(the JAX ``halo_axis``) reaches every conv: the encoder then runs on a
slab of rows sharded over that mesh axis (``parallel/sharding.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpu_diinn_torch.nn.layers import Conv

RDN_CONFIGS = {
    # name: (D blocks, C convs/block, G growth)
    "A": (20, 6, 32),
    "B": (16, 8, 64),
    "tiny": (2, 2, 16),
}


class RDB(nn.Module):
    """Residual dense block on NCHW tensors."""

    def __init__(self, growth0: int, growth: int, n_convs: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, halo=None):
        super().__init__()
        self.n_convs = n_convs
        for c in range(n_convs):
            self.add_module(f"conv{c}", Conv(growth0 + c * growth, growth, 3,
                                             generator=generator,
                                             dtype=dtype, halo=halo))
        self.lff = Conv(growth0 + n_convs * growth, growth0, 1,
                        generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for c in range(self.n_convs):
            out = torch.relu(getattr(self, f"conv{c}")(y))
            y = torch.cat([y, out], dim=1)
        return x + self.lff(y)


class RDN(nn.Module):
    def __init__(self, growth0: int = 64, config: str = "B",
                 n_colors: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, halo=None):
        super().__init__()
        d, c, g = RDN_CONFIGS[config]
        self.growth0 = growth0
        self.n_blocks = d
        kw = dict(generator=generator, dtype=dtype, halo=halo)
        self.sfe1 = Conv(n_colors, growth0, 3, **kw)
        self.sfe2 = Conv(growth0, growth0, 3, **kw)
        for i in range(d):
            self.add_module(f"rdb{i}", RDB(growth0, g, c, **kw))
        self.gff1 = Conv(d * growth0, growth0, 1, **kw)
        self.gff2 = Conv(growth0, growth0, 3, **kw)

    @property
    def out_dim(self) -> int:
        return self.growth0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, n_colors) -> (B, H, W, G0)."""
        x = x.permute(0, 3, 1, 2)
        f1 = self.sfe1(x)
        y = self.sfe2(f1)
        block_outs = []
        for i in range(self.n_blocks):
            y = getattr(self, f"rdb{i}")(y)
            block_outs.append(y)
        y = self.gff1(torch.cat(block_outs, dim=1))
        y = self.gff2(y) + f1
        return y.permute(0, 2, 3, 1)


def make_rdn(*, growth0: int = 64, config: str = "B",
             generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, halo=None) -> RDN:
    """The feature extractor shared by the models: G0=64, config 'B'."""
    return RDN(growth0=growth0, config=config, generator=generator,
               dtype=dtype, halo=halo)
