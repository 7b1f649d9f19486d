"""Shared NN building blocks.

Counterpart of ``tpu_diinn/nn/layers.py``: a same-padded ``Conv`` and a
per-pixel ``Dense``, both with the torch-default init (kaiming_uniform with
a=sqrt(5), i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias),
and ``pixel_shuffle``. Each wraps its torch layer as a child named ``conv``
/ ``dense``, so that state-dict keys mirror the JAX parameter paths
(``sfe1/conv/kernel`` -> ``sfe1.conv.weight``).

``Conv`` works on NCHW tensors: the models convert NHWC -> NCHW once at
their boundary. ``Dense`` works on the last axis (NHWC). The TPU-only
column-pair packed conv is not ported.

Compute dtype (``dtype``), as flax's ``promote_dtype`` has it: the
parameters stay float32, and ``forward`` casts the input, the weight and
the bias to ``dtype``, computes the product in it and adds the bias in it
(two roundings: the product's, then the add's). In float32, the default,
the bias stays fused into the product. Mixed precision is
spelled out per layer, not left to ``torch.autocast``, whose op lists are
not flax's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _torch_default_init_(weight: torch.Tensor, bias: Optional[torch.Tensor],
                         fan_in: int,
                         generator: Optional[torch.Generator]) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
        if bias is not None:
            bias.uniform_(-bound, bound, generator=generator)


class Conv(nn.Module):
    """Same-padded stride-1 2-D conv on NCHW tensors."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=use_bias)
        self.dtype = dtype
        _torch_default_init_(self.conv.weight, self.conv.bias,
                             kernel_size * kernel_size * in_channels,
                             generator)

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        """The conv of ``x``; ``padding`` overrides the same padding (0 for
        an input padded by the caller)."""
        c = self.conv
        pad = c.padding if padding is None else padding
        if self.dtype == torch.float32:
            return F.conv2d(x, c.weight, c.bias, padding=pad)
        y = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), padding=pad)
        return y if c.bias is None else y + c.bias.to(self.dtype)[:, None,
                                                                  None]


class Dense(nn.Module):
    """Per-pixel linear layer over the last axis."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        self.dtype = dtype
        _torch_default_init_(self.dense.weight, self.dense.bias,
                             in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return self.dense(x)
        d = self.dense
        return (F.linear(x.to(self.dtype), d.weight.to(self.dtype))
                + d.bias.to(self.dtype))


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space on NHWC: (B, H, W, C*r^2) -> (B, H*r, W*r, C), with
    torch ``nn.PixelShuffle``'s (C, r, r) channel order."""
    b, h, w, c = x.shape
    r = factor
    c_out = c // (r * r)
    x = x.reshape(b, h, w, c_out, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c_out)
