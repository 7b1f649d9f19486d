"""Valid-extent masking: run shape-padded images through conv stacks with
boundary semantics identical to the true-shape run.

Counterpart of ``tpu_diinn/nn/masking.py``. Bucketed eval
(``train/bucketed.py``) pads every image of a bucket to one static canvas,
so that one captured CUDA graph serves every image of it. Plain zero
padding would change the numbers: a same-padded conv on the canvas puts
nonzero activations (bias, relu) in the pad region, and the next conv
reads them back into the image at its true border. Masking every conv
output to zero beyond the true extent makes each conv's input zero there,
which is what same zero padding at the true edge gives, so every
activation inside the extent equals the unpadded run's.

Usage (the extents are 0-d int32 tensors on the device, read when a
captured graph replays, never Python ints baked into it):

    with valid_extent((h_pad, w_pad), h_true, w_true):
        feat = encoder(x_padded)

``layers.Conv`` and ``layers.MeanShift`` call :func:`apply_valid_mask` on
their NCHW outputs; outside a scope it returns its input. A resolution
change inside the stack (PixelShuffle) scales the extent by the static
shape ratio. Each scope builds the mask of a (H, W, dtype, device) once,
from ``torch.arange(n) < extent``, and reuses it: RDN-B masks about 150
conv outputs an image.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class _Extent:
    base_hw: Tuple[int, int]
    h_valid: torch.Tensor
    w_valid: torch.Tensor
    masks: Dict[tuple, torch.Tensor]


_EXTENT: contextvars.ContextVar[Optional[_Extent]] = contextvars.ContextVar(
    "tpu_diinn_torch_valid_extent", default=None)


def _check_extent(v, what: str) -> None:
    if not (isinstance(v, torch.Tensor) and v.dim() == 0
            and v.dtype == torch.int32):
        raise TypeError(f"{what} must be a 0-d int32 tensor, got {v!r}")


@contextlib.contextmanager
def valid_extent(base_hw: Tuple[int, int], h_valid: torch.Tensor,
                 w_valid: torch.Tensor):
    """Scope under which conv outputs are zeroed outside (h_valid,
    w_valid); ``base_hw`` is the static (H, W) of the canvas the extents
    refer to (the padded input)."""
    _check_extent(h_valid, "h_valid")
    _check_extent(w_valid, "w_valid")
    tok = _EXTENT.set(_Extent(tuple(base_hw), h_valid, w_valid, {}))
    try:
        yield
    finally:
        _EXTENT.reset(tok)


def _scaled(v: torch.Tensor, n_cur: int, n_base: int) -> torch.Tensor:
    """The valid extent at resolution ``n_cur`` when the base canvas is
    ``n_base``: conv stacks rescale only by integer factors."""
    if n_cur == n_base:
        return v
    if n_cur > n_base:
        if n_cur % n_base:
            raise ValueError(f"resolution {n_cur} is not a multiple of "
                             f"{n_base}")
        return v * (n_cur // n_base)
    if n_base % n_cur:
        raise ValueError(f"resolution {n_base} is not a multiple of {n_cur}")
    return v // (n_base // n_cur)


def apply_valid_mask(y: torch.Tensor) -> torch.Tensor:
    """Zero ``y`` (..., H, W) outside the current valid extent; ``y``
    itself when no :func:`valid_extent` scope is active."""
    ctx = _EXTENT.get()
    if ctx is None:
        return y
    h, w = y.shape[-2], y.shape[-1]
    key = (h, w, y.dtype, y.device)
    mask = ctx.masks.get(key)
    if mask is None:
        hv = _scaled(ctx.h_valid, h, ctx.base_hw[0])
        wv = _scaled(ctx.w_valid, w, ctx.base_hw[1])
        ih = torch.arange(h, dtype=torch.int32, device=y.device)
        iw = torch.arange(w, dtype=torch.int32, device=y.device)
        mask = ((ih < hv)[:, None] & (iw < wv)[None, :]).to(y.dtype)
        ctx.masks[key] = mask
    return y * mask


def masking_active() -> bool:
    return _EXTENT.get() is not None
