"""Evaluation metrics: PSNR (three protocols), SSIM, LR-PSNR.

Counterpart of ``tpu_diinn/train/metrics.py`` (NHWC tensors):

- ``psnr``: torchmetrics-style, RGB, MSE over the whole batch;
- ``calc_psnr``: the shave protocols ('benchmark': luma, shave int(scale);
  'div2k': RGB, shave int(scale)+6);
- ``ssim``: 11x11 gaussian window (sigma 1.5), k1=0.01, k2=0.03, reflect
  padding, mean over the full-size map;
- ``lr_psnr``: PSNR between antialiased-bicubic downsamples of SR and HR;
- ``psnr_masked``, ``ssim_masked``, ``lr_psnr_masked``: the same metrics
  of an image in the top-left (h_v, w_v) corner of a padded canvas, the
  true extents 0-d int32 tensors (bucketed eval, ``train/bucketed.py``).
  Each reproduces its exact-shape counterpart per pixel; only the fp32
  summation order of the means differs. They upload nothing from the host
  (the gaussian window is cached per device), so a CUDA graph can capture
  them.

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
def _gaussian_kernel1d(size: int, sigma: float, device: torch.device
                       ) -> torch.Tensor:
    """The normalised 1-D gaussian window on ``device``, uploaded once
    (a graph capture may not upload)."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    with torch.inference_mode(False):
        return torch.from_numpy((g / g.sum()).astype(np.float32)).to(device)


def _gaussian_filter(x: torch.Tensor, size: int, sigma: float
                     ) -> torch.Tensor:
    """Separable valid-mode gaussian over H, W of an NCHW tensor."""
    k = _gaussian_kernel1d(size, sigma, x.device)
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
    return torch.mean(_ssim_map(x, y, kernel_size, sigma, c1, c2))


def _ssim_map(x: torch.Tensor, y: torch.Tensor, kernel_size: int,
              sigma: float, c1: float, c2: float) -> torch.Tensor:
    """The per-window SSIM of padded NCHW ``x`` and ``y``."""
    def f(t):
        return _gaussian_filter(t, kernel_size, sigma)

    mu_x, mu_y = f(x), f(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = f(x * x) - mu_x2
    sig_y = f(y * y) - mu_y2
    sig_xy = f(x * y) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return num / den


def lr_psnr(sr: torch.Tensor, hr: torch.Tensor, scale: float,
            data_range: float = 1.0) -> torch.Tensor:
    """Cycle-consistency PSNR at the LR size."""
    size = resize_by_scale_size((hr.shape[-3], hr.shape[-2]), scale)
    return psnr(resize(sr, size), resize(hr, size), data_range)


# ---------------------------------------------------------------------------
# Masked variants (bucketed eval): the image fills the top-left (h_v, w_v)
# corner of a padded NHWC canvas; h_v and w_v are 0-d int32 tensors.
# ---------------------------------------------------------------------------

def _extent_mask(h: int, w: int, h_v: torch.Tensor, w_v: torch.Tensor
                 ) -> torch.Tensor:
    ih = torch.arange(h, dtype=torch.int32, device=h_v.device)[:, None]
    iw = torch.arange(w, dtype=torch.int32, device=w_v.device)[None, :]
    return (ih < h_v) & (iw < w_v)


def psnr_masked(sr: torch.Tensor, hr: torch.Tensor, h_v: torch.Tensor,
                w_v: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Whole-batch RGB PSNR over the valid (h_v, w_v) region of padded
    canvases (masked counterpart of :func:`psnr`)."""
    b, h, w, c = sr.shape
    m = _extent_mask(h, w, h_v, w_v)[None, :, :, None]
    d = (sr.float() - hr.float()) * m
    n = (b * c) * (h_v * w_v)
    mse = torch.sum(d * d) / n
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _reflect_indices(n_pad: int, n_v: torch.Tensor, pad: int
                     ) -> torch.Tensor:
    """Gather indices that reflect-pad by ``pad`` at the true edge ``n_v``
    of a canvas of length ``n_pad``; entries whose windows lie outside the
    valid region are clamped in bounds (the mean masks them out)."""
    i = torch.arange(-pad, n_pad + pad, dtype=torch.int32,
                     device=n_v.device)
    j = torch.abs(i)
    j = torch.where(j >= n_v, 2 * n_v - 2 - j, j)
    return torch.clamp(j, 0, n_pad - 1)


def ssim_masked(sr: torch.Tensor, hr: torch.Tensor, h_v: torch.Tensor,
                w_v: torch.Tensor, data_range: float = 1.0,
                kernel_size: int = 11, sigma: float = 1.5,
                k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Masked counterpart of :func:`ssim`: the reflect padding happens at
    the true edge (a gather), the SSIM map covers the padded canvas, and
    the mean runs over the valid window centres only."""
    pad = (kernel_size - 1) // 2
    h, w = sr.shape[1:3]
    ri = _reflect_indices(h, h_v, pad)
    ci = _reflect_indices(w, w_v, pad)

    def gather(t):
        t = t.float().index_select(1, ri).index_select(2, ci)
        return t.permute(0, 3, 1, 2)

    smap = _ssim_map(gather(sr), gather(hr), kernel_size, sigma,
                     (k1 * data_range) ** 2, (k2 * data_range) ** 2)
    b, c, hm, wm = smap.shape
    m = _extent_mask(hm, wm, h_v, w_v)[None, None]
    return torch.sum(smap * m) / ((b * c) * (h_v * w_v))


def lr_psnr_masked(sr: torch.Tensor, hr: torch.Tensor, wh: torch.Tensor,
                   ww: torch.Tensor, hl_v: torch.Tensor, wl_v: torch.Tensor,
                   data_range: float = 1.0) -> torch.Tensor:
    """Masked counterpart of :func:`lr_psnr`: ``wh`` (h_lr_pad, H_pad) and
    ``ww`` (w_lr_pad, W_pad) are the antialiased-bicubic resize matrices of
    the true sizes, zero-embedded in the bucket's (the caller builds them);
    (hl_v, wl_v) is the true LR extent. The downsample stays fp32 (the
    exact metric rounds a bf16 prediction's to bf16, as JAX's masked
    metric does not)."""
    def down(t):
        t = torch.einsum("oh,bhwc->bowc", wh, t.float())
        return torch.einsum("ow,bhwc->bhoc", ww, t)

    return psnr_masked(down(sr), down(hr), hl_v, wl_v, data_range)
