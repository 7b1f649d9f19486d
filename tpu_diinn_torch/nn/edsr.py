"""EDSR encoder and the full EDSR super-resolver.

Counterpart of ``tpu_diinn/nn/edsr.py``. ``EDSRBaseline`` is the headless
EDSR (conv head, residual body with a global residual) that returns the
(B, H, W, n_feats) feature grid: the encoder of the "tiny DIINN" baseline
configuration. ``EDSR`` adds the mean shifts and the PixelShuffle tail, at
a fixed integer scale. NHWC in and out; NCHW inside for ``conv2d``.
``EDSRBaseline(halo=...)`` passes the mesh axis to every conv, as the
JAX ``halo_axis`` (``nn/layers.py``). In fp32 inference (a CUDA input,
autograd off, no halo, no valid-extent masking:
``kernels/encoder_conv.engaged``) ``EDSRBaseline`` runs every conv as
``kernels/encoder_conv``'s implicit-GEMM kernel on NHWC slabs, the
residuals in its epilogue (``forward_slabs``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpu_diinn_torch.kernels import encoder_conv as ec
from tpu_diinn_torch.nn.layers import Conv, MeanShift, ResBlock, Upsampler


def _residual_body(mod: nn.Module, n_resblocks: int, n_feats: int,
                   kw: dict) -> None:
    """``head``, ``res0..res{n-1}`` and ``body_tail`` (the flax names)."""
    mod.n_resblocks = n_resblocks
    mod.head = Conv(3, n_feats, 3, **kw)
    for i in range(n_resblocks):
        mod.add_module(f"res{i}", ResBlock(n_feats, 3, **kw))
    mod.body_tail = Conv(n_feats, n_feats, 3, **kw)


def _run_body(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    y = mod.head(x)
    r = y
    for i in range(mod.n_resblocks):
        r = getattr(mod, f"res{i}")(r)
    return y + mod.body_tail(r)


class EDSRBaseline(nn.Module):
    """Headless EDSR: (B, H, W, 3) -> (B, H, W, n_feats)."""

    def __init__(self, n_resblocks: int = 16, n_feats: int = 64,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, halo=None):
        super().__init__()
        self.n_feats = n_feats
        _residual_body(self, n_resblocks, n_feats,
                       dict(generator=generator, dtype=dtype, halo=halo))

    @property
    def out_dim(self) -> int:
        return self.n_feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if ec.engaged(x, self.head.dtype, self.head.halo):
            return self.forward_slabs(x)
        return _run_body(self, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """The body on NHWC slabs: (B, H, W, 3) -> a contiguous (B, H, W,
        n_feats). Each resblock's second conv adds its input and writes
        over it."""
        y = ec.new_slab(x, self.n_feats)
        ec.module_conv(self.head, x, y)
        t = ec.new_slab(x, self.n_feats)
        r = ec.new_slab(x, self.n_feats)
        src = y
        for i in range(self.n_resblocks):
            blk = getattr(self, f"res{i}")
            ec.module_conv(blk.conv0, src, t, relu=True)
            ec.module_conv(blk.conv1, t, r, residual=src)
            src = r
        out = ec.new_slab(x, self.n_feats)
        ec.module_conv(self.body_tail, src, out, residual=y)
        return out


class EDSR(nn.Module):
    """Full EDSR at a fixed integer ``scale``: (B, H, W, 3) ->
    (B, H*scale, W*scale, 3)."""

    def __init__(self, n_resblocks: int = 16, n_feats: int = 64,
                 scale: int = 4, rgb_range: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.sub_mean = MeanShift(rgb_range, sign=-1)
        _residual_body(self, n_resblocks, n_feats, kw)
        self.upsampler = Upsampler(scale, n_feats, **kw)
        self.tail = Conv(n_feats, 3, 3, **kw)
        self.add_mean = MeanShift(rgb_range, sign=1)

    def forward(self, x: torch.Tensor, size=None) -> torch.Tensor:
        y = _run_body(self, self.sub_mean(x.permute(0, 3, 1, 2)))
        y = self.add_mean(self.tail(self.upsampler(y)))
        return y.permute(0, 2, 3, 1)
