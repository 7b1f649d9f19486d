"""Query-grid and spatial sharding over the mesh's ranks.

Counterpart of ``tpu_diinn/parallel/sharding.py``. The decode of every
model family is independent per HR query, so:

- **Query sharding**: each rank of the 'space' axis decodes one column
  stripe of the HR grid from the (replicated) LR features. Stripes are
  ``ceil(W_out / space)`` columns wide, clamped: the last stripe's columns
  past ``W_out`` repeat the last column, and are cut after the gather
  (the JAX package's ``decode_stripe`` layout, which it uses where W_out
  does not divide; it lets GSPMD split the grid where it does, with the
  same values). On the fused DIINN route a stripe is one
  ``decode_window_fwd`` over the stripe's column index vector (and
  ``decode_window_bwd`` in training).
- **Batch sharding**: the batch over 'data'.
- **Halo exchange**: the halo-sharded encoder splits the LR rows over
  'space'; each k x k conv first receives its (k - 1) // 2 edge rows from
  both neighbours (zeros at the image's border) and convolves VALID along
  H, SAME along W (``nn/layers.Conv(halo=...)``), which gives the
  unsharded SAME stack's values at every pixel.

The functions take the ``Mesh`` of ``parallel/mesh.py`` and are called by
every rank of it. They run without autograd (inference); the training
step shards its queries through ``SRTask.stripe_loss``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from tpu_diinn_torch.parallel.mesh import (Axis, Mesh, all_gather_cat,
                                           exchange)


def stripe_width(w_out: int, n: int) -> int:
    """The width of each of ``n`` clamped column stripes of ``w_out``
    columns."""
    return -(-w_out // n)


def stripe_columns(w_out: int, start: int, width: int) -> np.ndarray:
    """HR column indices of the ``width``-wide stripe at ``start``,
    clamped to ``w_out - 1`` (the overhang repeats the last column)."""
    return np.minimum(np.arange(start, start + width), w_out - 1)


def stripe_fns(net) -> Tuple[Callable, Callable]:
    """(encode(x), decode_stripe(feat, size, start, width)) of a model
    family: DIINN's encoder and decoder, LIIF's and MetaSR's own."""
    from tpu_diinn_torch.nn.diinn import DIINN
    from tpu_diinn_torch.nn.liif import LIIF
    from tpu_diinn_torch.nn.metasr import MetaSR
    if isinstance(net, DIINN):
        return net.encoder, net.decoder.decode_stripe
    if isinstance(net, (LIIF, MetaSR)):
        return net.encode, net.decode_stripe
    raise NotImplementedError(
        f"stripe decode not implemented for {type(net).__name__}")


@torch.no_grad()
def halo_exchange(x: torch.Tensor, halo: int, axis: Axis,
                  dim: int = 2) -> torch.Tensor:
    """This rank's slab of a tensor sharded along ``dim`` over ``axis``,
    extended by ``halo`` rows from each neighbour: [above, x, below], with
    zeros beyond the first and the last rank (SAME padding at the global
    border). Two point-to-point transfers of (halo x rest) slabs. The
    result keeps ``x``'s memory format (the models' NHWC-permuted
    channels-last), so that the convs take the unsharded stack's
    algorithms and sum in its order."""
    i, n = axis.index, axis.size
    fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    top = x.narrow(dim, 0, halo).contiguous()
    bottom = x.narrow(dim, x.shape[dim] - halo, halo).contiguous()
    above = torch.zeros_like(top)
    below = torch.zeros_like(bottom)
    sends, recvs = [], []
    if i > 0:                       # our top rows go up, theirs come down
        sends.append((top, axis.ranks[i - 1]))
        recvs.append((above, axis.ranks[i - 1]))
    if i < n - 1:
        sends.append((bottom, axis.ranks[i + 1]))
        recvs.append((below, axis.ranks[i + 1]))
    exchange(sends, recvs, axis.group)
    return torch.cat([above, x, below], dim=dim).contiguous(
        memory_format=fmt)


@torch.no_grad()
def sharded_encoder_apply(encoder, x: torch.Tensor, mesh: Mesh,
                          axis_name: str = "space") -> torch.Tensor:
    """Run ``encoder`` (built with ``halo=mesh.axis(axis_name)``) with the
    rows of the NHWC input ``x`` (the whole input, on every rank) split
    over ``axis_name``: this rank encodes its slab, exchanging each conv's
    halo with its neighbours, and the slabs' features are gathered. Every
    rank returns the whole (B, H, W, C) feature grid."""
    axis = mesh.axis(axis_name)
    n = axis.size
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} rows do not split over {n} ranks")
    rows = x.shape[1] // n
    # contiguous, as a whole input is: the models' NCHW view of it is then
    # channels-last, as the unsharded stack's
    slab = x[:, axis.index * rows:(axis.index + 1) * rows].contiguous()
    return all_gather_cat(encoder(slab), axis, dim=1)


@torch.no_grad()
def decode_sharded(net, x: torch.Tensor, size: Tuple[int, int],
                   mesh: Mesh) -> torch.Tensor:
    """Query-sharded inference of ``net`` on the whole batch ``x`` (NHWC,
    the same on every rank; the net's raw input, as ``net(x, size)``):
    the batch over 'data', the output columns over 'space' in clamped
    stripes. Every rank returns the whole (B, H_out, W_out, 3) output.
    Any width works; the batch must divide over 'data'."""
    d, s = mesh.data, mesh.space
    b = x.shape[0]
    if b % d.size:
        raise ValueError(f"batch {b} does not split over data={d.size}")
    shard = b // d.size
    x = x[d.index * shard:(d.index + 1) * shard]
    encode, decode_stripe = stripe_fns(net)
    w_out = size[1]
    width = stripe_width(w_out, s.size)
    out = decode_stripe(encode(x), size, s.index * width, width)
    out = all_gather_cat(out, s, dim=2)[:, :, :w_out]
    return all_gather_cat(out.contiguous(), d, dim=0)
