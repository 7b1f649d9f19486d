"""Antialiased bicubic resize as separable weight matrices.

Counterpart of ``tpu_diinn/core/resize.py``: a 1-D resize n_in -> n_out is
a fixed linear map, built on the host as a dense (n_out, n_in) float64
matrix and applied over the H and W axes of an (..., H, W, C) array.

- ``kernel='torch'``: PyTorch/PIL antialiased bicubic (a=-0.5), the
  reference pipeline's resize (``F.interpolate(..., antialias=True)``).
- ``kernel='matlab'``: MATLAB ``imresize`` semantics.

``resize_np`` serves the data pipeline; ``resize`` applies the same
matrices to tensors with ``torch.matmul`` (LR-PSNR).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_CUBIC_A = -0.5  # PIL/MATLAB convention; torch non-AA bicubic uses -0.75.


def _cubic(x: np.ndarray, a: float = _CUBIC_A) -> np.ndarray:
    x = np.abs(x.astype(np.float64))
    x2 = x * x
    x3 = x2 * x
    inner = (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0
    outer = a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a
    return np.where(x <= 1.0, inner, np.where(x < 2.0, outer, 0.0))


@functools.lru_cache(maxsize=4096)
def resize_matrix(n_in: int, n_out: int, kernel: str = "torch",
                  antialias: bool = True) -> np.ndarray:
    """Dense (n_out, n_in) float64 resize weight matrix for one axis."""
    if kernel == "torch":
        return _torch_aa_matrix(n_in, n_out, antialias)
    if kernel == "matlab":
        return _matlab_matrix(n_in, n_out, antialias)
    raise ValueError(f"unknown resize kernel: {kernel!r}")


def _torch_aa_matrix(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    scale = n_in / n_out
    if antialias and scale >= 1.0:
        support = 2.0 * scale
        invscale = 1.0 / scale
    else:
        support = 2.0
        invscale = 1.0
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        center = scale * (i + 0.5)
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        j = np.arange(lo, hi, dtype=np.float64)
        w = _cubic((j - center + 0.5) * invscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        mat[i, lo:hi] = w
    return mat


def _matlab_matrix(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    scale = n_out / n_in
    kernel_width = 4.0
    if antialias and scale < 1.0:
        kernel_width = kernel_width / scale
        kern = lambda x: scale * _cubic(scale * x)
    else:
        kern = _cubic
    # 1-based output coordinates mapped into input space.
    x = np.arange(1, n_out + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    p = int(np.ceil(kernel_width)) + 2
    ind = left[:, None] + np.arange(p)[None, :] - 1  # 0-based tap indices
    w = kern(u[:, None] - ind - 1.0)
    w = w / w.sum(axis=1, keepdims=True)
    # Mirror out-of-range indices: 0,1,...,n-1,n-1,...,1,0 cycle.
    aux = np.concatenate([np.arange(n_in), np.arange(n_in - 1, -1, -1)])
    ind = aux[np.mod(ind.astype(np.int64), aux.size)]
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        np.add.at(mat[i], ind[i], w[i])
    return mat


def resize(x: torch.Tensor, size: tuple[int, int], *, kernel: str = "torch",
           antialias: bool = True) -> torch.Tensor:
    """Bicubic-resize an (..., H, W, C) tensor to ``size`` with two fp32
    matmuls (H axis, then W axis), on ``x``'s device; the result in x's
    dtype (a bf16 image's resize is rounded to bf16, as JAX's)."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = int(size[0]), int(size[1])
    wh = torch.as_tensor(resize_matrix(h_in, h_out, kernel, antialias),
                         dtype=torch.float32, device=x.device)
    ww = torch.as_tensor(resize_matrix(w_in, w_out, kernel, antialias),
                         dtype=torch.float32, device=x.device)
    y = torch.einsum("oh,...hwc->...owc", wh, x.to(torch.float32))
    return torch.einsum("ow,...hwc->...hoc", ww, y).to(x.dtype)


def resize_np(x: np.ndarray, size: tuple[int, int], *, kernel: str = "torch",
              antialias: bool = True) -> np.ndarray:
    """Host-side (numpy) resize of an (..., H, W, C) array: same weight
    matrices, float32 accumulation."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = int(size[0]), int(size[1])
    wh = resize_matrix(h_in, h_out, kernel, antialias).astype(np.float32)
    ww = resize_matrix(w_in, w_out, kernel, antialias).astype(np.float32)
    y = np.einsum("oh,...hwc->...owc", wh, x.astype(np.float32))
    return np.einsum("ow,...hwc->...hoc", ww, y)


def resize_by_scale_size(size: tuple[int, int], scale: float
                         ) -> tuple[int, int]:
    """Output size convention of the reference pipeline:
    ``round(H / scale)`` per axis."""
    return (int(round(size[0] / scale)), int(round(size[1] / scale)))
