"""DIINN: dual-interactive implicit decoder over an RDN feature grid.

Counterpart of ``tpu_diinn/nn/diinn.py`` (``ImplicitDecoder`` and
``DIINN``, without ``init_q``). The decoder is the factorized form: every
content layer's 1x1 conv over ``unfold(x, 3)`` is a 3x3 conv over ``x`` at
LR resolution, gathered to HR by nearest-exact indices, so per query the
chain is

    k = relu(z0);  q = k * sin(q0(syn))
    k = K_i(...) ;  q = k * sin(q_i(q))                     i = 1..L-1
    out = last_dense(q)            (mode 4: 3x3 reflect-padded conv)

with K_i = relu(kq_i(k)) (mode 1), relu(kq_i(k) + z_i) (mode 2) or
relu(kq_i(q) + z_i) (modes 3, 4).

Routing mirrors the JAX ``__call__`` and is decided once per ``forward``.
``_fused_ok`` (configuration only) picks the fused decoder
(``kernels/decoder_fused.decode``: the CUDA forward and backward kernels
for a CUDA tensor, their plain versions on the CPU) or the eager
``hr_step``. Without ``bsize``, and for integer ratios (s <= 16)
on the fused decoder, the whole grid decodes at once; any other ``bsize``
decode runs serial column chunks of ``bsize // H_out`` columns (the
reference ``batched_step``; mode 4's window-local output conv depends on
these chunk borders).

NHWC at every public method; NCHW inside for ``conv2d``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_diinn_torch.core import grids
from tpu_diinn_torch.core.fastmath import fast_sin
from tpu_diinn_torch.kernels import decoder_fused as kern
from tpu_diinn_torch.nn.layers import Conv, Dense


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ImplicitDecoder(nn.Module):
    def __init__(self, in_channels: int = 64,
                 hidden_dims: Sequence[int] = (256, 256, 256, 256),
                 mode: int = 3, init_q: bool = False, out_channels: int = 3,
                 exact_sin: bool = False, use_fused: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if init_q:
            raise NotImplementedError("init_q is not ported yet (ROADMAP)")
        if mode not in (1, 2, 3, 4):
            raise ValueError(f"DIINN mode must be 1-4, got {mode}")
        h = list(hidden_dims)
        self.hidden_dims = tuple(h)
        self.mode = mode
        self.exact_sin = exact_sin
        self.use_fused = use_fused
        g = generator
        self.k0_conv = Conv(in_channels, h[0], 3, generator=g)
        for i in range(1, len(h)):
            self.add_module(f"kq{i}", Dense(h[i - 1], h[i], generator=g))
            if mode != 1:
                self.add_module(f"kx{i}", Conv(in_channels, h[i], 3,
                                               use_bias=False, generator=g))
        self.add_module("q0", Dense(3, h[0], generator=g))
        for i in range(1, len(h)):
            self.add_module(f"q{i}", Dense(h[i - 1], h[i], generator=g))
        if mode == 4:
            self.last_conv = Conv(h[-1], out_channels, 3, generator=g)
        else:
            self.last_dense = Dense(h[-1], out_channels, generator=g)

    @property
    def n_layers(self) -> int:
        return len(self.hidden_dims)

    def _sin(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(x) if self.exact_sin else fast_sin(x)

    # -- fused decoder gate ------------------------------------------------
    def _fused_ok(self, feat: torch.Tensor) -> bool:
        """Whether the fused decoder (CUDA kernels / their plain versions)
        takes this decode. Configuration only, no size gate:

        - mode 3 with the polynomial sine and uniform hidden widths (the
          chain the kernels compute);
        - hidden in ``KERNEL_HIDDEN`` (32, 64, 256): each lane of a
          warp owns hidden/32 columns, a register tile sized at compile
          time;
        - fp32 features (the kernels are fp32 only).
        """
        if self.use_fused is False:
            return False
        return (self.mode == 3 and not self.exact_sin
                and len(set(self.hidden_dims)) == 1
                and self.hidden_dims[0] in kern.KERNEL_HIDDEN
                and feat.dtype == torch.float32)

    def _fused_params(self) -> dict:
        return kern.pack_params(dict(self.named_parameters()), self.n_layers)

    # -- LR-side precomputation -------------------------------------------
    def lr_features(self, feat: torch.Tensor
                    ) -> Tuple[Optional[torch.Tensor], ...]:
        """All content-branch 3x3 convs at LR resolution, each NHWC."""
        x = _nchw(feat)
        zs = [_nhwc(self.k0_conv(x))]
        for i in range(1, self.n_layers):
            kx = getattr(self, f"kx{i}", None)
            zs.append(_nhwc(kx(x)) if kx is not None else None)
        return tuple(zs)

    def lr_features_stacked(self, feat: torch.Tensor) -> torch.Tensor:
        """The channel-stacked content features as ONE 3x3 conv with the
        kq biases folded in: k = relu(q@Wkq + (z_i + bkq_i)). Mode 3 only.
        Returns a contiguous (B, H, W, L*hidden) tensor."""
        ws = [self.k0_conv.conv.weight]
        bs = [self.k0_conv.conv.bias]
        for i in range(1, self.n_layers):
            ws.append(getattr(self, f"kx{i}").conv.weight)
            bs.append(getattr(self, f"kq{i}").dense.bias)
        y = F.conv2d(_nchw(feat), torch.cat(ws, dim=0), torch.cat(bs),
                     padding=1)
        return _nhwc(y).contiguous()

    # -- HR-side per-query network ----------------------------------------
    def hr_step(self, zs_hr: Tuple[Optional[torch.Tensor], ...],
                syn: torch.Tensor) -> torch.Tensor:
        """Decode from gathered LR features ``zs_hr`` (each (B, h, w, C))
        and the synthesis input ``syn`` (B, h, w, 3)."""
        k = torch.relu(zs_hr[0])
        q = k * self._sin(self.q0(syn))
        for i in range(1, self.n_layers):
            kq = getattr(self, f"kq{i}")
            zi = zs_hr[i]
            if self.mode == 1:
                k = torch.relu(kq(k))
            elif self.mode == 2:
                k = torch.relu(kq(k) + zi)
            else:  # modes 3, 4
                k = torch.relu(kq(q) + zi)
            q = k * self._sin(getattr(self, f"q{i}")(q))
        if self.mode == 4:
            qp = F.pad(_nchw(q), (1, 1, 1, 1), mode="reflect")
            conv = self.last_conv.conv
            return _nhwc(F.conv2d(qp, conv.weight, conv.bias))
        return self.last_dense(q)

    def forward(self, feat: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        _, h_in, w_in, _ = feat.shape
        h_out, w_out = size
        rows = grids.nearest_exact_indices(h_in, h_out)
        cols = grids.nearest_exact_indices(w_in, w_out)
        syn = grids.syn_input_grid((h_in, w_in), (h_out, w_out),
                                   device=feat.device)
        if self._fused_ok(feat):
            z = self.lr_features_stacked(feat)
            params = self._fused_params()
            s_h, rem_h = divmod(h_out, h_in)
            s_w, rem_w = divmod(w_out, w_in)
            if (rem_h == 0 and rem_w == 0
                    and 1 <= s_h <= kern.MAX_INT_RATIO
                    and 1 <= s_w <= kern.MAX_INT_RATIO):
                return kern.decode(z, syn, params, ratio=(s_h, s_w))
            # index vectors uploaded once; each chunk reads a view of them
            rows_v = kern.index_vector(rows, h_in, feat.device)
            cols_v = kern.index_vector(cols, w_in, feat.device)

            def decode(lo, hi):
                return kern.decode(z, syn[:, lo:hi].contiguous(), params,
                                   rows=rows_v, cols=cols_v[lo:hi])
        else:
            zs = self.lr_features(feat)

            def decode(lo, hi):
                return self.decode_window(zs, syn[:, lo:hi], rows,
                                          cols[lo:hi])
        # serial column chunks of bsize // H_out queries (reference
        # batched_step); the LR features are computed once for all chunks
        chunk = w_out if bsize is None else max(1, bsize // h_out)
        return torch.cat([decode(lo, min(lo + chunk, w_out))
                          for lo in range(0, w_out, chunk)], dim=2)

    def decode_window(self, zs: Tuple[Optional[torch.Tensor], ...],
                      syn: torch.Tensor, rows: np.ndarray, cols: np.ndarray
                      ) -> torch.Tensor:
        """Eager decode of the HR window whose queries read LR rows
        ``rows`` and LR columns ``cols`` of the per-layer features ``zs``
        (``lr_features``), with its synthesis grid ``syn`` (h, w, 3).
        Mode 4's 3x3 output conv is window-local (reflect padding at the
        window's borders), as in the reference's chunked decode."""
        dev = zs[0].device
        r = torch.as_tensor(rows, dtype=torch.long, device=dev)
        c = torch.as_tensor(cols, dtype=torch.long, device=dev)
        gath = tuple(None if z is None else z[:, r][:, :, c] for z in zs)
        synb = syn[None].expand(zs[0].shape[0], *syn.shape)
        return self.hr_step(gath, synb)


class DIINN(nn.Module):
    """Encoder + implicit decoder: ``net(x_lr, size, bsize=None) ->
    (B, H_out, W_out, 3)``, NHWC."""

    def __init__(self, mode: int = 3, init_q: bool = False,
                 encoder_spec: str = "rdn",
                 hidden_dims: Sequence[int] = (256, 256, 256, 256),
                 exact_sin: bool = False, use_fused: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from tpu_diinn_torch.nn.registry import make_encoder
        self.encoder = make_encoder(encoder_spec, generator=generator)
        self.decoder = ImplicitDecoder(
            in_channels=self.encoder.out_dim, hidden_dims=hidden_dims,
            mode=mode, init_q=init_q, exact_sin=exact_sin,
            use_fused=use_fused, generator=generator)

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        return self.decoder(self.encoder(x), size, bsize)
