"""Evaluation metrics: PSNR (three protocols), SSIM, LR-PSNR.

Counterpart of ``tpu_diinn/train/metrics.py`` (NHWC tensors):

- ``psnr``: torchmetrics-style, RGB, MSE over the whole batch;
- ``calc_psnr``: the shave protocols ('benchmark': luma, shave int(scale);
  'div2k': RGB, shave int(scale)+6);
- ``ssim``: 11x11 gaussian window (sigma 1.5), k1=0.01, k2=0.03, reflect
  padding, mean over the full-size map;
- ``lr_psnr``: PSNR between antialiased-bicubic downsamples of SR and HR.

The depthwise gaussian convs must run in full fp32: with TF32 the
variance f(x^2) - mu^2 cancels badly. The CLI turns TF32 off for cuDNN
and cuBLAS. A bf16 prediction (the bf16 mode) is widened to fp32 before
every metric; LR-PSNR's resize returns the prediction's dtype, as JAX's
``resize`` does, so its downsample is rounded to bf16 first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpu_diinn_torch.core.resize import resize, resize_by_scale_size

GRAY_COEFFS = (65.738 / 256.0, 129.057 / 256.0, 25.064 / 256.0)


def psnr(sr: torch.Tensor, hr: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((sr.float() - hr.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def calc_psnr(sr: torch.Tensor, hr: torch.Tensor, dataset: str | None = None,
              scale: float = 1, rgb_range: float = 1) -> torch.Tensor:
    diff = (sr.float() - hr.float()) / rgb_range
    if dataset is not None:
        if dataset == "benchmark":
            shave = int(scale)
            if diff.shape[-1] > 1:
                conv = torch.tensor(GRAY_COEFFS, dtype=diff.dtype,
                                    device=diff.device)
                diff = torch.sum(diff * conv, dim=-1, keepdim=True)
        elif dataset == "div2k":
            shave = int(scale) + 6
        else:
            raise NotImplementedError(dataset)
        if shave > 0:
            diff = diff[..., shave:-shave, shave:-shave, :]
    mse = torch.mean(diff ** 2)
    return -10.0 * torch.log10(mse)


@functools.lru_cache(maxsize=16)
def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x: torch.Tensor, size: int, sigma: float
                     ) -> torch.Tensor:
    """Separable valid-mode gaussian over H, W of an NCHW tensor."""
    k = torch.from_numpy(_gaussian_kernel1d(size, sigma)).to(x.device)
    c = x.shape[1]
    kh = k.view(1, 1, size, 1).expand(c, 1, size, 1)
    kw = k.view(1, 1, 1, size).expand(c, 1, 1, size)
    x = F.conv2d(x, kh, groups=c)
    return F.conv2d(x, kw, groups=c)


def ssim(sr: torch.Tensor, hr: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM, torchmetrics convention (reflect pad, gaussian window)."""
    pad = (kernel_size - 1) // 2
    x = F.pad(sr.float().permute(0, 3, 1, 2), (pad, pad, pad, pad),
              mode="reflect")
    y = F.pad(hr.float().permute(0, 3, 1, 2), (pad, pad, pad, pad),
              mode="reflect")
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    def f(t):
        return _gaussian_filter(t, kernel_size, sigma)

    mu_x, mu_y = f(x), f(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = f(x * x) - mu_x2
    sig_y = f(y * y) - mu_y2
    sig_xy = f(x * y) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return torch.mean(num / den)


def lr_psnr(sr: torch.Tensor, hr: torch.Tensor, scale: float,
            data_range: float = 1.0) -> torch.Tensor:
    """Cycle-consistency PSNR at the LR size."""
    size = resize_by_scale_size((hr.shape[-3], hr.shape[-2]), scale)
    return psnr(resize(sr, size), resize(hr, size), data_range)
