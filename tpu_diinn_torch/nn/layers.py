"""Shared NN building blocks.

Counterpart of ``tpu_diinn/nn/layers.py``: a same-padded ``Conv`` and a
per-pixel ``Dense``, both with the torch-default init (kaiming_uniform with
a=sqrt(5), i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias),
``pixel_shuffle``, EDSR's ``MeanShift``, ``ResBlock`` and ``Upsampler``,
and ``unfold3x3`` (``tpu_diinn/nn/diinn.py``). ``Conv`` and ``Dense`` wrap
their torch layer as a child named ``conv`` / ``dense``, so that state-dict
keys mirror the JAX parameter paths
(``sfe1/conv/kernel`` -> ``sfe1.conv.weight``).

``Conv`` works on NCHW tensors: the models convert NHWC -> NCHW once at
their boundary. ``Conv(halo=axis)`` is the JAX ``halo_axis``: with the
input's rows sharded over a mesh axis (``parallel/sharding.
sharded_encoder_apply``), a k x k conv first takes (k - 1) // 2 rows from
each neighbouring rank (zeros at the image's border) and convolves VALID
along H, SAME along W, so each rank's slab comes out as the unsharded
conv's rows. ``Dense`` works on the last axis (NHWC). The TPU-only
column-pair packed conv is not ported. Under ``nn/masking.valid_extent``
(bucketed eval) ``Conv`` zeroes its output, after the bias, beyond the
image's true extent, and so does ``MeanShift``; a halo conv under an
active mask raises.

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

from tpu_diinn_torch.nn.masking import apply_valid_mask, masking_active
from tpu_diinn_torch.parallel.sharding import halo_exchange


def _torch_default_init_(weight: torch.Tensor, bias: Optional[torch.Tensor],
                         fan_in: int,
                         generator: Optional[torch.Generator]) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
        if bias is not None:
            bias.uniform_(-bound, bound, generator=generator)


class Conv(nn.Module):
    """Same-padded stride-1 2-D conv on NCHW tensors; ``halo``: the mesh
    axis (``parallel.mesh.Axis``) its input's rows are sharded over."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, halo=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=use_bias)
        self.dtype = dtype
        self.halo = halo
        _torch_default_init_(self.conv.weight, self.conv.bias,
                             kernel_size * kernel_size * in_channels,
                             generator)

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        """The conv of ``x``; ``padding`` overrides the same padding (0 for
        an input padded by the caller)."""
        c = self.conv
        pad = c.padding if padding is None else padding
        if self.halo is not None and padding is None and c.padding[0] > 0:
            if masking_active():
                raise RuntimeError("valid-extent masking is not supported "
                                   "in a halo-sharded conv")
            k = c.padding[0]
            x = halo_exchange(x, k, self.halo, dim=2)
            pad = (0, k)
        if self.dtype == torch.float32:
            return apply_valid_mask(F.conv2d(x, c.weight, c.bias,
                                             padding=pad))
        y = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), padding=pad)
        if c.bias is not None:
            y = y + c.bias.to(self.dtype)[:, None, None]
        return apply_valid_mask(y)


class Dense(nn.Module):
    """Per-pixel linear layer over the last axis."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = nn.Linear(in_features, features, bias=use_bias)
        self.dtype = dtype
        _torch_default_init_(self.dense.weight, self.dense.bias,
                             in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return self.dense(x)
        d = self.dense
        y = F.linear(x.to(self.dtype), d.weight.to(self.dtype))
        return y if d.bias is None else y + d.bias.to(self.dtype)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space on NHWC: (B, H, W, C*r^2) -> (B, H*r, W*r, C), with
    torch ``nn.PixelShuffle``'s (C, r, r) channel order."""
    b, h, w, c = x.shape
    r = factor
    c_out = c // (r * r)
    x = x.reshape(b, h, w, c_out, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c_out)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C*9) zero-padded 3x3 neighbourhoods, in
    torch ``F.unfold(x, 3, padding=1)``'s channel order c*9 + kh*3 + kw."""
    b, h, w, c = x.shape
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [p[:, kh:kh + h, kw:kw + w, :] for kh in range(3)
            for kw in range(3)]
    return torch.stack(taps, dim=-1).reshape(b, h, w, c * 9)


# DIV2K RGB mean used by EDSR's MeanShift
DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)


class MeanShift(nn.Module):
    """Frozen shift by the DIV2K RGB mean on NCHW tensors; ``sign=-1``
    subtracts. The JAX module's std is 1 wherever the repo builds it, so
    the port has no std. No parameters (the flax module has none): the mean
    is a non-persistent buffer, so it moves with the module, stays out of
    the state dict, and a captured CUDA graph reads it without a host
    upload. Under ``valid_extent`` the output is zeroed beyond the true
    extent, so that the next conv sees zeros there (bucketed eval)."""

    def __init__(self, rgb_range: float = 1.0, sign: int = -1):
        super().__init__()
        self.rgb_range = rgb_range
        self.sign = sign
        self.register_buffer("mean", torch.tensor(DIV2K_RGB_MEAN,
                                                  dtype=torch.float64),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = self.mean.to(x.dtype)[:, None, None]
        return apply_valid_mask(x + self.sign * self.rgb_range * mean)


class ResBlock(nn.Module):
    """conv-relu-conv residual block on NCHW tensors (EDSR-baseline's
    res_scale of 1, the only one the repo builds)."""

    def __init__(self, n_feats: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, halo=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, halo=halo)
        self.conv0 = Conv(n_feats, n_feats, kernel_size, **kw)
        self.conv1 = Conv(n_feats, n_feats, kernel_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.conv0(x)))
        return x + y


class Upsampler(nn.Module):
    """PixelShuffle x2^n / x3 upsampling tail on NCHW tensors (torch's
    ``pixel_shuffle`` has the (C, r, r) channel order of the JAX one)."""

    def __init__(self, scale: int, n_feats: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        if scale & (scale - 1) == 0:          # a power of two
            self.steps = [2] * int(math.log2(scale))
        elif scale == 3:
            self.steps = [3]
        else:
            raise NotImplementedError(f"Upsampler scale {scale}")
        for i, r in enumerate(self.steps):
            self.add_module(f"conv{i}", Conv(n_feats, r * r * n_feats, 3,
                                             **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, r in enumerate(self.steps):
            x = F.pixel_shuffle(getattr(self, f"conv{i}")(x), r)
        return x
