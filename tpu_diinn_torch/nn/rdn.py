"""Residual Dense Network encoder.

Counterpart of ``tpu_diinn/nn/rdn.py``: two shallow convs, D residual dense
blocks of C concat-growing 3x3 convs plus a 1x1 local fusion, a global
fusion over the concatenated block outputs, and a residual to the first
shallow feature. With ``upsampling=None`` (the DIINN, LIIF and MetaSR
use) it returns the (B, H, W, G0) feature grid at input resolution; with
``upsampling`` 2, 3 or 4 the PixelShuffle head makes it the stand-alone
super-resolver, (B, H*r, W*r, n_colors): ``up0`` -> shuffle r -> ``up1``
at x2 and x3, ``up0`` -> shuffle 2 -> ``up1`` -> shuffle 2 -> ``up2`` at
x4 (``F.pixel_shuffle`` on NCHW, the channel order of ``nn/layers.
pixel_shuffle``). ``RDNSmall`` is the reduced net of the tests (G0 16,
config "tiny"). NHWC in and out; NCHW inside for ``conv2d``. ``dtype`` is every conv's compute dtype
(``nn/layers.py``): with bfloat16 the features come out bf16. ``halo``
(the JAX ``halo_axis``) reaches every conv: the encoder then runs on a
slab of rows sharded over that mesh axis (``parallel/sharding.py``).

fp32 inference without a head (a CUDA input, autograd off, no halo, no
valid-extent masking: ``kernels/encoder_conv.engaged``) takes
``forward_slabs``: every conv is ``kernels/encoder_conv``'s implicit-GEMM
kernel on NHWC channel slabs. A block keeps one (B, H, W, G0 + C G) slab:
conv c reads its channel prefix [0, G0 + c G) and writes the next G
channels, and the local fusion writes the block's output over the slab's
first G0 channels (its input, the residual) and into the (B, H, W, D G0)
slab that the global fusion reads, so nothing is concatenated; the
residuals are the kernel's epilogue. Everything else keeps the NCHW path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_diinn_torch.kernels import encoder_conv as ec
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

    def forward_slab(self, s: torch.Tensor, out2: torch.Tensor) -> None:
        """The block on slab ``s`` (B, H, W, G0 + C G) whose first G0
        channels hold its input: the convs fill the rest, the local
        fusion's output replaces the input and goes to ``out2`` too."""
        for c in range(self.n_convs):
            conv = getattr(self, f"conv{c}")
            cin = conv.conv.in_channels
            ec.module_conv(conv, s[..., :cin],
                           s[..., cin:cin + conv.conv.out_channels],
                           relu=True)
        g0 = self.lff.conv.out_channels
        ec.module_conv(self.lff, s, s[..., :g0], residual=s[..., :g0],
                       out2=out2)


class RDN(nn.Module):
    def __init__(self, growth0: int = 64, config: str = "B",
                 n_colors: int = 3, upsampling: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, halo=None):
        super().__init__()
        d, c, g = RDN_CONFIGS[config]
        self.growth0 = growth0
        self.n_colors = n_colors
        self.n_blocks = d
        kw = dict(generator=generator, dtype=dtype, halo=halo)
        self.sfe1 = Conv(n_colors, growth0, 3, **kw)
        self.sfe2 = Conv(growth0, growth0, 3, **kw)
        for i in range(d):
            self.add_module(f"rdb{i}", RDB(growth0, g, c, **kw))
        self.gff1 = Conv(d * growth0, growth0, 1, **kw)
        self.gff2 = Conv(growth0, growth0, 3, **kw)
        self.upsampling = upsampling
        # the head's convs and the pixel-shuffle factor after each but the
        # last (as the JAX head, they take no halo)
        head = dict(generator=generator, dtype=dtype)
        if not upsampling:
            self.shuffles = []
        elif upsampling in (2, 3):
            r = upsampling
            self.shuffles = [r]
            self.up0 = Conv(growth0, g * r * r, 3, **head)
            self.up1 = Conv(g, n_colors, 3, **head)
        elif upsampling == 4:
            self.shuffles = [2, 2]
            self.up0 = Conv(growth0, g * 4, 3, **head)
            self.up1 = Conv(g, g * 4, 3, **head)
            self.up2 = Conv(g, n_colors, 3, **head)
        else:
            raise ValueError("upsampling scale must be 2, 3 or 4")

    @property
    def out_dim(self) -> int:
        return self.n_colors if self.upsampling else self.growth0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, n_colors) -> (B, H, W, G0), or with the head
        (B, H*r, W*r, n_colors)."""
        if not self.upsampling and ec.engaged(x, self.sfe1.dtype,
                                              self.sfe1.halo):
            return self.forward_slabs(x)
        x = x.permute(0, 3, 1, 2)
        f1 = self.sfe1(x)
        y = self.sfe2(f1)
        block_outs = []
        for i in range(self.n_blocks):
            y = getattr(self, f"rdb{i}")(y)
            block_outs.append(y)
        y = self.gff1(torch.cat(block_outs, dim=1))
        y = self.gff2(y) + f1
        for i, r in enumerate(self.shuffles):
            y = F.pixel_shuffle(getattr(self, f"up{i}")(y), r)
        if self.shuffles:
            y = getattr(self, f"up{len(self.shuffles)}")(y)
        return y.permute(0, 2, 3, 1)

    def forward_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """The headless forward on NHWC channel slabs (module docstring):
        (B, H, W, n_colors) -> a contiguous (B, H, W, G0)."""
        g0 = self.growth0
        f1 = ec.new_slab(x, g0)
        ec.module_conv(self.sfe1, x, f1)
        rdb0 = self.rdb0
        s = ec.new_slab(x, rdb0.lff.conv.in_channels)
        ec.module_conv(self.sfe2, f1, s[..., :g0])
        blocks = ec.new_slab(x, self.n_blocks * g0)
        for i in range(self.n_blocks):
            getattr(self, f"rdb{i}").forward_slab(
                s, blocks[..., i * g0:(i + 1) * g0])
        y = ec.new_slab(x, g0)
        ec.module_conv(self.gff1, blocks, y)
        out = ec.new_slab(x, g0)
        ec.module_conv(self.gff2, y, out, residual=f1)
        return out


class RDNSmall(RDN):
    """Reduced RDN for tests: the same wiring at G0 16, config "tiny"."""

    def __init__(self, growth0: int = 16, config: str = "tiny", **kwargs):
        super().__init__(growth0=growth0, config=config, **kwargs)


def make_rdn(*, growth0: int = 64, config: str = "B",
             generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, halo=None) -> RDN:
    """The feature extractor shared by the models: G0=64, config 'B'."""
    return RDN(growth0=growth0, config=config, generator=generator,
               dtype=dtype, halo=halo)
