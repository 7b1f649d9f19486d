"""MetaSR: the meta-upscale baseline.

Counterpart of ``tpu_diinn/nn/metasr.py``: a hypernetwork MLP(3 -> 256 ->
C*9*3) predicts, per HR query, a (C*9, 3) projection of the query's
nearest 3x3 unfolded feature neighbourhood. The per-query weights rule out
an LR factorization, so the C*9 channels are gathered at HR, once per
column chunk, and the per-query product is one batched
``einsum('...c,...co->...o')`` (an XLA einsum in the JAX package, outside
any Pallas kernel).

The index maps are float64 numpy functions of the two sizes, cast to
float32 only at the end (see ``nn/liif.py``). NHWC at every method.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_diinn_torch.core import grids
from tpu_diinn_torch.nn.layers import Dense, unfold3x3
from tpu_diinn_torch.parallel.sharding import stripe_columns


def _axis_lookup(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Indices and scaled rel-coords of one axis: query coordinates
    shifted by -cell/2, then +1e-6 and clamped for the nearest lookup; the
    looked-up feature coordinate carries a -1/n_in offset;
    rel = (shifted query - shifted feature) * n_in / 2."""
    coords = -1.0 + 1.0 / n_out + (2.0 / n_out) * np.arange(n_out)
    cell = 2.0 / n_out
    q = coords - cell / 2.0
    q_clamped = np.clip(q + 1e-6, -1.0 + 1e-6, 1.0 - 1e-6)
    idx = grids.nearest_grid_sample_indices(n_in, q_clamped)
    in_coords = -1.0 + 1.0 / n_in + (2.0 / n_in) * np.arange(n_in)
    feat_c = in_coords[idx] - 1.0 / n_in
    rel = (q - feat_c) * (n_in / 2.0)
    return idx, rel.astype(np.float32)


class MetaSR(nn.Module):
    def __init__(self, encoder_spec: str = "rdn", feat_dim: int = 64,
                 hyper_hidden: int = 256,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        from tpu_diinn_torch.nn.registry import make_encoder
        kw = dict(generator=generator, dtype=dtype)
        self.feat_dim = feat_dim
        self.encoder = make_encoder(encoder_spec, **kw)
        self.hyper_fc0 = Dense(3, hyper_hidden, **kw)
        self.hyper_fc1 = Dense(hyper_hidden, feat_dim * 9 * 3, **kw)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, feat: torch.Tensor, size: Tuple[int, int],
               bsize: Optional[int] = None) -> torch.Tensor:
        """Decode to ``size``, in serial column chunks of
        ``bsize // H_out`` queries when ``bsize`` is set."""
        h_out, w_out = size
        unfolded, iy, ry, ix, rx, r_rev = self._lookups(feat, size)
        chunk = w_out if bsize is None else max(1, bsize // h_out)
        outs = [self._pred(unfolded, iy, ry, ix[lo:lo + chunk],
                           rx[lo:lo + chunk], r_rev)
                for lo in range(0, w_out, chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)

    def decode_stripe(self, feat: torch.Tensor, size: Tuple[int, int],
                      col_start: int, stripe_w: int) -> torch.Tensor:
        """Decode the ``stripe_w``-wide column stripe at ``col_start``,
        clamped (columns past W_out repeat the last one): the unit of
        query sharding (``parallel/sharding.py``)."""
        unfolded, iy, ry, ix, rx, r_rev = self._lookups(feat, size)
        cols = torch.from_numpy(stripe_columns(size[1], col_start,
                                               stripe_w)).to(feat.device)
        return self._pred(unfolded, iy, ry, ix[cols], rx[cols], r_rev)

    def _lookups(self, feat: torch.Tensor, size: Tuple[int, int]):
        """(the unfolded features, the row and column index and rel-coord
        vectors on the device, r_rev)."""
        b, h_in, w_in, c = feat.shape
        if c != self.feat_dim:
            raise ValueError(f"features have {c} channels, the hypernet "
                             f"{self.feat_dim}")
        h_out, w_out = size
        dev = feat.device
        unfolded = unfold3x3(feat)
        iy, ry = _axis_lookup(h_in, h_out)
        ix, rx = _axis_lookup(w_in, w_out)
        iy, ry, ix, rx = (torch.from_numpy(a).to(dev) for a in (
            iy.astype(np.int64), ry, ix.astype(np.int64), rx))
        # r_rev = cell_h * H_in / 2, a float32 scalar
        r_rev = torch.full((), float(np.float32((2.0 / h_out) * h_in / 2.0)),
                           dtype=torch.float32, device=dev)
        return unfolded, iy, ry, ix, rx, r_rev

    def decode_traced(self, feat: torch.Tensor, iy, ry, ix, rx,
                      r_rev: torch.Tensor, out_hw: Tuple[int, int],
                      bsize: int) -> torch.Tensor:
        """Decode with the per-axis index and rel-coord vectors and the 0-d
        ``r_rev`` given as device tensors, the unit of bucketed eval
        (``train/bucketed.py``). Row bands of ``bsize // W_out`` rows."""
        h_out, w_out = out_hw
        unfolded = unfold3x3(feat)
        band = max(1, bsize // max(w_out, 1))
        outs = [self._pred(unfolded, iy[lo:lo + band], ry[lo:lo + band], ix,
                           rx, r_rev)
                for lo in range(0, h_out, band)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def _pred(self, unfolded: torch.Tensor, iy, ry, ix, rx,
              r_rev: torch.Tensor) -> torch.Tensor:
        """The hypernet's projection over the window of rows ``iy`` and
        columns ``ix`` (index and rel-coord vectors; ``r_rev`` a 0-d
        float32 tensor, read on the device)."""
        b = unfolded.shape[0]
        h_c, w_c = iy.shape[0], ix.shape[0]
        q_feat = unfolded.index_select(1, iy).index_select(2, ix)
        inp = torch.stack([ry[:, None].expand(h_c, w_c),
                           rx[None, :].expand(h_c, w_c),
                           r_rev.expand(h_c, w_c)], dim=-1)
        inp = inp[None].expand(b, h_c, w_c, 3).to(q_feat.dtype)
        w = self.hyper_fc1(torch.relu(self.hyper_fc0(inp)))
        w = w.reshape(b, h_c, w_c, self.feat_dim * 9, 3)
        return torch.einsum("...c,...co->...o", q_feat, w)

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        return self.decode(self.encoder(x), size, bsize)
