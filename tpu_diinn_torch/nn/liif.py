"""LIIF: the local implicit image function baseline.

Counterpart of ``tpu_diinn/nn/liif.py``: a four-corner local ensemble of
nearest feature lookups, 3x3 feature unfolding, cell decoding and an MLP
image function, blended with the diagonal area swap.

The imnet's first layer over the 576 unfolded channels is a 3x3 conv over
the feature grid (``imnet_feat``), run once at LR and gathered per corner;
its relative-coordinate part (``imnet_rel``, with layer 0's bias) and cell
part (``imnet_cell``, no bias) are small per-query dense layers. The
per-query products stay ``torch.matmul`` (the JAX package runs them as XLA
dense ops, outside any Pallas kernel).

The corner index maps are float64 numpy functions of the two sizes, cast
to float32 only at the end: in float32 the ties of integer scales round to
the other side and shift whole rows or columns. NHWC at every method.

In fp32 inference on the card (``kernels/encoder_conv.engaged``: a CUDA
float32 input, autograd off, no valid-extent masking) ``imnet_feat`` is
one launch of the encoder's implicit-GEMM conv, with a zero bias (layer
0's bias stays in ``imnet_rel``); training, bf16, the bucketed eval
(``decode_traced``) and the CPU keep ``nn/layers.Conv``.

In fp32 inference on the card (``kernels/liif_decoder.engaged``: a CUDA
float32 ``z``, autograd off, a float32 imnet of four hidden layers of 256
and three outputs) ``_blend`` decodes a chunk in one launch of
``csrc/liif_decoder.cu`` (the gathers, the four corners' MLPs in 3xTF32
and the area blend); training, bf16, other widths and the CPU keep the
torch ops below. Either way each chunk is written into its columns (or a
band into its rows) of one output.

Spans (``train/profiling.py::span``): ``encoder`` around the encoder in
``forward``; ``decoder`` around a decode, in it ``lr_conv`` (the
``imnet_feat`` conv), ``decoder.prepare`` (the float64 index maps, the
cell and their uploads) and ``decoder.window`` (one column chunk). Each
chunk adds one to ``chunks`` and 4 x its queries to ``corner_queries``,
and one to ``fused_chunks`` where the kernel decoded it
(``reset_counters`` sets all three to 0).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import encoder_conv as ec
from tpu_diinn_torch.kernels import liif_decoder as ld
from tpu_diinn_torch.nn.layers import Conv, Dense
from tpu_diinn_torch.parallel.sharding import stripe_columns
from tpu_diinn_torch.train.profiling import span

_EPS_SHIFT = 1e-6
_CLAMP = 1.0 - 1e-6

chunks = 0
corner_queries = 0
fused_chunks = 0


def reset_counters() -> None:
    global chunks, corner_queries, fused_chunks
    chunks = corner_queries = fused_chunks = 0


def _new_output(z: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The (B, h, w, 3) output of a decode of ``z``, to be written chunk by
    chunk."""
    return z.new_empty((z.shape[0], h, w, 3))


def _corner_axis_indices(n_in: int, n_out: int,
                         v: int) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-lookup indices and rel-coords (scaled by ``n_in``) of one
    axis for corner offset ``v``: the query coordinate shifted by
    ``v / n_in + 1e-6``, clamped to +-(1 - 1e-6)."""
    coords = -1.0 + 1.0 / n_out + (2.0 / n_out) * np.arange(n_out)
    r = 1.0 / n_in
    shifted = coords + (v * r + _EPS_SHIFT)
    shifted = np.clip(shifted, -_CLAMP, _CLAMP)
    idx = grids.nearest_grid_sample_indices(n_in, shifted)
    in_coords = -1.0 + 1.0 / n_in + (2.0 / n_in) * np.arange(n_in)
    rel = (coords - in_coords[idx]) * n_in
    return idx, rel.astype(np.float32)


# the four corner offsets, in the order the blend sums them
_CORNERS = ((-1, -1), (-1, 1), (1, -1), (1, 1))


class LIIF(nn.Module):
    """LIIF with the reference's settings fixed: local ensemble, 3x3 feature
    unfolding and cell decoding all on (the JAX module's options default to
    these, and every configuration and checkpoint of the repo uses them)."""

    def __init__(self, encoder_spec: str = "rdn",
                 hidden: Sequence[int] = (256, 256, 256, 256),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        from tpu_diinn_torch.nn.registry import make_encoder
        self.n_hidden = len(hidden)
        self.hidden = tuple(hidden)
        kw = dict(generator=generator, dtype=dtype)
        self.encoder = make_encoder(encoder_spec, **kw)
        c = self.encoder.out_dim
        self.imnet_feat = Conv(c, hidden[0], 3, use_bias=False, **kw)
        # the slab conv's bias operand: imnet_feat has none
        self.register_buffer("_imnet_feat_zero_bias",
                             torch.zeros(hidden[0]), persistent=False)
        self.imnet_rel = Dense(2, hidden[0], **kw)
        self.imnet_cell = Dense(2, hidden[0], use_bias=False, **kw)
        dims = [*hidden, 3]
        for i in range(1, len(dims)):
            self.add_module(f"imnet_fc{i}", Dense(dims[i - 1], dims[i], **kw))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, feat: torch.Tensor, size: Tuple[int, int],
               bsize: Optional[int] = None) -> torch.Tensor:
        """Implicit decode of an LR feature grid to ``size``, in serial
        column chunks of ``bsize // H_out`` queries when ``bsize`` is
        set, each written into its columns of one output."""
        h_out, w_out = size
        with span("decoder"):
            z = self.feat_conv(feat)
            maps, cell = self._lookups(feat, size)
            chunk = w_out if bsize is None else max(1, bsize // h_out)
            out = _new_output(z, h_out, w_out)
            for lo in range(0, w_out, chunk):
                with span("decoder.window"):
                    self._blend(z, [(iy, ry, ix[lo:lo + chunk],
                                     rx[lo:lo + chunk])
                                    for iy, ry, ix, rx in maps], cell,
                                out[:, :, lo:lo + chunk])
            return out

    def decode_stripe(self, feat: torch.Tensor, size: Tuple[int, int],
                      col_start: int, stripe_w: int) -> torch.Tensor:
        """Decode the ``stripe_w``-wide column stripe at ``col_start``,
        clamped (columns past W_out repeat the last one): the unit of
        query sharding (``parallel/sharding.py``)."""
        z = self.feat_conv(feat)
        maps, cell = self._lookups(feat, size)
        cols = torch.from_numpy(stripe_columns(size[1], col_start,
                                               stripe_w)).to(feat.device)
        return self._blend(z, [(iy, ry, ix[cols], rx[cols])
                               for iy, ry, ix, rx in maps], cell,
                           _new_output(z, size[0], stripe_w))

    def decode_traced(self, feat: torch.Tensor, per_corner: List[tuple],
                      cell: torch.Tensor, out_hw: Tuple[int, int],
                      bsize: int) -> torch.Tensor:
        """Decode with per-corner (row index, row rel, column index, column
        rel) vectors and the (2,) ``cell`` given as device tensors, the
        unit of bucketed eval (``train/bucketed.py``): the work depends
        only on the padded ``out_hw``. Row bands of ``bsize // W_out``
        rows, each written into its rows of one output."""
        h_out, w_out = out_hw
        z = self.imnet_feat(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self._fused(z):
            z = z.contiguous()
        band = max(1, bsize // max(w_out, 1))
        out = _new_output(z, h_out, w_out)
        for lo in range(0, h_out, band):
            self._blend(z, [(iy[lo:lo + band], ry[lo:lo + band], ix, rx)
                            for iy, ry, ix, rx in per_corner], cell,
                        out[:, lo:lo + band])
        return out

    def feat_conv(self, feat: torch.Tensor) -> torch.Tensor:
        """The first layer's feature conv z of NHWC ``feat``, NHWC: on the
        slab conv where ``encoder_conv.engaged``, else ``imnet_feat``."""
        with span("lr_conv"):
            if ec.engaged(feat, self.imnet_feat.dtype):
                w, b, slabs = ec.operands(
                    self.imnet_feat, [self.imnet_feat.conv.weight],
                    [self._imnet_feat_zero_bias])
                z = ec.new_slab(feat, w.shape[0])
                ec.conv(feat, w, b, z, slabs=slabs)
                return z
            return self.imnet_feat(feat.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)

    def _lookups(self, feat: torch.Tensor, size: Tuple[int, int]):
        """(per corner (row index, row rel, column index, column rel) on
        the device, the cell)."""
        _, h_in, w_in, _ = feat.shape
        h_out, w_out = size
        dev = feat.device
        with span("decoder.prepare"):
            cell = torch.from_numpy(np.asarray(
                [2.0 * h_in / h_out, 2.0 * w_in / w_out], np.float32)).to(dev)
            maps = []
            for vy, vx in _CORNERS:
                iy, ry = _corner_axis_indices(h_in, h_out, vy)
                ix, rx = _corner_axis_indices(w_in, w_out, vx)
                maps.append(tuple(torch.from_numpy(a).to(dev)
                                  for a in (iy.astype(np.int64), ry,
                                            ix.astype(np.int64), rx)))
            return maps, cell

    def _fused(self, z: torch.Tensor) -> bool:
        """Whether ``_blend`` decodes ``z`` on the kernel."""
        head = getattr(self, f"imnet_fc{self.n_hidden}").dense
        return ld.engaged(z, self.imnet_rel.dtype, self.hidden,
                          head.out_features)

    def _blend(self, z: torch.Tensor, per_corner: List[tuple],
               cell: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """Corner predictions and the area-weighted blend over per-corner
        (row index, row rel, column index, column rel) vectors, written
        into ``out`` (B, h, w, 3), which it returns: one launch of the
        kernel where ``_fused``, else the torch ops."""
        global chunks, corner_queries, fused_chunks
        b = z.shape[0]
        chunks += 1
        corner_queries += 4 * b * len(per_corner[0][0]) * len(
            per_corner[0][2])
        if self._fused(z):
            fused_chunks += 1
            small, slabs = ld.operands(self)
            return ld.decode_chunk(z.contiguous(), per_corner, cell, small,
                                   slabs, out)
        preds, areas = [], []
        for iy, ry, ix, rx in per_corner:
            q = z.index_select(1, iy).index_select(2, ix)
            h_c, w_c = q.shape[1], q.shape[2]
            rel = torch.stack([ry[:, None].expand(h_c, w_c),
                               rx[None, :].expand(h_c, w_c)], dim=-1)
            rel = rel[None].expand(b, h_c, w_c, 2).to(q.dtype)
            y = torch.relu(q + self.imnet_rel(rel) + self.imnet_cell(
                cell.expand(b, h_c, w_c, 2).to(q.dtype)))
            for i in range(1, self.n_hidden):
                y = torch.relu(getattr(self, f"imnet_fc{i}")(y))
            preds.append(getattr(self, f"imnet_fc{self.n_hidden}")(y))
            areas.append(torch.abs(rel[..., 0] * rel[..., 1]) + 1e-9)
        areas = areas[::-1]           # the diagonal area swap
        tot = sum(areas)
        return out.copy_(sum(p * (a / tot)[..., None]
                             for p, a in zip(preds, areas)))

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        with span("encoder"):
            feat = self.encoder(x)
        return self.decode(feat, size, bsize)
