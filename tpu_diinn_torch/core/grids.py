"""Coordinate-grid and index math for implicit-image decoding.

Counterpart of ``tpu_diinn/core/grids.py`` with the same scalar conventions:

- pixel-center coordinates in [-1, 1]: ``coord[i] = -1 + 1/N + (2/N) * i``;
- PyTorch ``nearest-exact`` index map:
  ``src = clamp(floor((i + 0.5) * N_in / N_out), 0, N_in - 1)``;
- relative coordinates scaled by the input grid extent.

The JAX package also expresses the nearest-exact upsample as one-hot
matmuls (an MXU device of the TPU); the port gathers by index with
``nearest_exact_indices`` instead.

``dtype`` (bfloat16 in the bf16 mode) is the arithmetic's type, as the
JAX functions compute in theirs: every scalar and every intermediate is
rounded to it, op by op.
"""

from __future__ import annotations

import numpy as np
import torch


def _scalar(v: float, dtype, device) -> torch.Tensor:
    """A Python scalar as a 0-d tensor of ``dtype`` (rounded to it, as JAX
    rounds a weakly typed scalar to the array's type)."""
    return torch.tensor(v, dtype=torch.float64, device=device).to(dtype)


def pixel_center_coords(n: int, *, v0: float = -1.0, v1: float = 1.0,
                        dtype=torch.float32, device=None) -> torch.Tensor:
    """1-D pixel-center coordinates of ``n`` cells over [v0, v1], computed
    in ``dtype``: (v0 + r) + (2 r) * i, r = (v1 - v0) / (2n)."""
    r = (v1 - v0) / (2 * n)
    i = torch.arange(n, dtype=torch.float32, device=device).to(dtype)
    return (_scalar(v0 + r, dtype, device)
            + _scalar(2 * r, dtype, device) * i)


def coord_grid(size: tuple[int, int], *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """(H, W, 2) grid of pixel-center (y, x) coordinates in [-1, 1]."""
    h, w = size
    ys = pixel_center_coords(h, dtype=dtype, device=device)
    xs = pixel_center_coords(w, dtype=dtype, device=device)
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


def nearest_exact_indices(n_in: int, n_out: int) -> np.ndarray:
    """PyTorch ``nearest-exact`` source indices for a 1-D resize n_in -> n_out,
    ``idx[i] = min(n_in - 1, floor((i + 0.5) * n_in / n_out))``, as a numpy
    int32 array (the map depends only on static shapes)."""
    i = np.arange(n_out, dtype=np.float64)
    idx = np.floor((i + 0.5) * (n_in / n_out))
    return np.clip(idx, 0, n_in - 1).astype(np.int32)


def rel_coord_axes(in_size: tuple[int, int], out_size: tuple[int, int],
                   *, dtype=torch.float32, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two 1-D factors (H_out,) and (W_out,) of ``rel_coord_grid``:
    each output row's (column's) pixel-center coordinate minus that of its
    nearest-exact LR row (column), scaled by H_in (W_in)."""
    h_in, w_in = in_size
    h_out, w_out = out_size
    kw = dict(dtype=dtype, device=device)
    ys_out = pixel_center_coords(h_out, **kw)
    xs_out = pixel_center_coords(w_out, **kw)
    ys_in = pixel_center_coords(h_in, **kw)
    xs_in = pixel_center_coords(w_in, **kw)
    ridx = torch.from_numpy(nearest_exact_indices(h_in, h_out)).to(
        ys_in.device, torch.long)
    cidx = torch.from_numpy(nearest_exact_indices(w_in, w_out)).to(
        xs_in.device, torch.long)
    ry = (ys_out - ys_in[ridx]) * _scalar(h_in, dtype, ys_in.device)
    rx = (xs_out - xs_in[cidx]) * _scalar(w_in, dtype, xs_in.device)
    return ry, rx


def _outer(ry: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """(len(ry), len(rx), 2) grid of the pairs (ry[i], rx[j])."""
    shape = (ry.shape[0], rx.shape[0])
    return torch.stack([ry[:, None].expand(shape), rx[None, :].expand(shape)],
                       dim=-1)


def rel_coord_grid(in_size: tuple[int, int], out_size: tuple[int, int],
                   *, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H_out, W_out, 2) relative-coordinate encoding of the DIINN decoder:
    each query's own pixel-center coordinate minus that of its
    nearest-exact LR cell, y scaled by H_in and x by W_in."""
    return _outer(*rel_coord_axes(in_size, out_size, dtype=dtype,
                                  device=device))


def area_ratio(in_size: tuple[int, int], out_size: tuple[int, int]) -> float:
    """Scalar scale-conditioning channel (H_in*W_in)/(H_out*W_out)."""
    return (in_size[0] * in_size[1]) / (out_size[0] * out_size[1])


def syn_from_axes(ry: torch.Tensor, rx: torch.Tensor,
                  ratio: float) -> torch.Tensor:
    """(len(ry), len(rx), 3) synthesis input [rel_y, rel_x, ratio] from
    ``rel_coord_axes``' vectors, in their dtype. Sliced vectors give the
    matching window of ``syn_input_grid``, bit for bit."""
    rel = _outer(ry, rx)
    r = _scalar(ratio, ry.dtype, ry.device).expand(rel.shape[:2] + (1,))
    return torch.cat([rel, r], dim=-1)


def syn_input_grid(in_size: tuple[int, int], out_size: tuple[int, int],
                   *, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H_out, W_out, 3) synthesis input [rel_y, rel_x, area_ratio] in
    ``dtype``; batch-independent, callers broadcast."""
    ry, rx = rel_coord_axes(in_size, out_size, dtype=dtype, device=device)
    return syn_from_axes(ry, rx, area_ratio(in_size, out_size))


def cell_grid(out_size: tuple[int, int], *, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """(2,) cell size (2/H_out, 2/W_out) used by LIIF and MetaSR."""
    return torch.tensor([2.0 / out_size[0], 2.0 / out_size[1]],
                        dtype=dtype, device=device)


def nearest_grid_sample_indices(n_in: int, coords: np.ndarray) -> np.ndarray:
    """torch ``grid_sample(mode='nearest', align_corners=False)`` index map
    over float64 numpy ``coords`` in [-1, 1]: un-normalize to
    ``(c + 1) * n_in/2 - 0.5``, round half up as ``floor(x + 0.5)``, clamp.
    Kept in float64 numpy: in float32 the ties of integer scales round to
    the other side and shift whole rows or columns."""
    x = (coords + 1.0) * (n_in / 2.0) - 0.5
    idx = np.floor(x + 0.5)
    return np.clip(idx, 0, n_in - 1).astype(np.int32)
