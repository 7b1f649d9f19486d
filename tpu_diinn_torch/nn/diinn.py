"""DIINN: dual-interactive implicit decoder over an RDN feature grid.

Counterpart of ``tpu_diinn/nn/diinn.py`` (``ImplicitDecoder`` and
``DIINN``). The decoder is the factorized form: every
content layer's 1x1 conv over ``unfold(x, 3)`` is a 3x3 conv over ``x`` at
LR resolution, gathered to HR by nearest-exact indices, so per query the
chain is

    k = relu(z0);  q = k * sin(q0(syn))
    k = K_i(...) ;  q = k * sin(q_i(q))                     i = 1..L-1
    out = last_dense(q)            (mode 4: 3x3 reflect-padded conv)

with K_i = relu(kq_i(k)) (mode 1), relu(kq_i(k) + z_i) (mode 2) or
relu(kq_i(q) + z_i) (modes 3, 4).

``init_q`` modulates the unfolded features per query before layer 0,
which breaks the LR factorization: the C*9 unfolded channels are gathered
at HR (once per decode window) and the chain is

    s = sin(first(syn));  x = s * u;  k = relu(k0_dense(x));
    q = k * sin(q0(s))
    K_i = relu(kq_i(k or q) + kx_i(x))          (kx_i: Dense, no bias)

always on the eager route (the fused kernels compute the chain without
it, as the JAX package's Pallas kernels do).

Routing mirrors the JAX ``__call__`` and is decided once per ``forward``.
``_fused_ok`` (configuration only) picks the fused decoder
(``kernels/decoder_fused.decode``: the CUDA forward and backward kernels
for a CUDA tensor, their plain versions on the CPU) or the eager
``hr_step``. Integer ratios (s <= 16) on the fused decoder decode the
whole grid at once; otherwise ``windows`` decodes one window over the
grid without ``bsize``, or serial column chunks of ``bsize // H_out``
columns (the reference ``batched_step``; mode 4's window-local output
conv depends on these chunk borders). ``windows`` is also the unit of the
streaming decode (``train/streaming.py``) and of ``decode_stripe``, the
clamped column stripe of query sharding (``parallel/sharding.py``).

NHWC at every public method; NCHW inside for ``conv2d``.

``dtype`` is the compute dtype of every conv and dense layer (flax's
``dtype``; the parameters stay float32): with bfloat16 the stacked LR conv
and its folded biases run in bf16, the synthesis grid is built in bf16,
the fused decoder runs its bf16 kernels (weights cast to bf16, biases
fp32) and its fp32 output is cast to bf16; the eager ``hr_step`` runs its
layers in bf16.
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
from tpu_diinn_torch.kernels import encoder_conv as ec
from tpu_diinn_torch.nn.layers import Conv, Dense, unfold3x3
from tpu_diinn_torch.parallel.sharding import stripe_columns
from tpu_diinn_torch.train.profiling import span


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ImplicitDecoder(nn.Module):
    def __init__(self, in_channels: int = 64,
                 hidden_dims: Sequence[int] = (256, 256, 256, 256),
                 mode: int = 3, init_q: bool = False, out_channels: int = 3,
                 exact_sin: bool = False, use_fused: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in (1, 2, 3, 4):
            raise ValueError(f"DIINN mode must be 1-4, got {mode}")
        h = list(hidden_dims)
        c9 = in_channels * 9
        self.hidden_dims = tuple(h)
        self.mode = mode
        self.init_q = init_q
        self.exact_sin = exact_sin
        self.use_fused = use_fused
        self.dtype = dtype
        kw = dict(generator=generator, dtype=dtype)
        if init_q:
            self.first = Dense(3, c9, **kw)
            self.k0_dense = Dense(c9, h[0], **kw)
        else:
            self.k0_conv = Conv(in_channels, h[0], 3, **kw)
        for i in range(1, len(h)):
            self.add_module(f"kq{i}", Dense(h[i - 1], h[i], **kw))
            if mode != 1:
                self.add_module(f"kx{i}", Dense(c9, h[i], use_bias=False,
                                                **kw) if init_q else
                                Conv(in_channels, h[i], 3, use_bias=False,
                                     **kw))
        self.add_module("q0", Dense(c9 if init_q else 3, h[0], **kw))
        for i in range(1, len(h)):
            self.add_module(f"q{i}", Dense(h[i - 1], h[i], **kw))
        if mode == 4:
            self.last_conv = Conv(h[-1], out_channels, 3, **kw)
        else:
            self.last_dense = Dense(h[-1], out_channels, **kw)

    @property
    def n_layers(self) -> int:
        return len(self.hidden_dims)

    def _sin(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(x) if self.exact_sin else fast_sin(x)

    # -- fused decoder gate ------------------------------------------------
    def _fused_ok(self, feat: torch.Tensor) -> bool:
        """Whether the fused decoder (CUDA kernels / their plain versions)
        takes this decode. Configuration only, no size gate:

        - mode 3 without ``init_q``, with the polynomial sine and uniform
          hidden widths (the chain the kernels compute);
        - hidden in ``KERNEL_HIDDEN`` (32, 64, 256): one kernel instance
          each, its tiling sized at compile time;
        - features in the compute dtype, float32 or bfloat16 (the kernels'
          two precisions).
        """
        return self._fused_config_ok() and feat.dtype == self.dtype

    def _fused_config_ok(self) -> bool:
        """``_fused_ok``'s configuration part (the compute dtype in place
        of the features')."""
        if self.use_fused is False:
            return False
        return (self.mode == 3 and not self.init_q and not self.exact_sin
                and len(set(self.hidden_dims)) == 1
                and self.hidden_dims[0] in kern.KERNEL_HIDDEN
                and self.dtype in kern.DTYPES)

    def _fused_params(self) -> dict:
        """The kernels' packed weights in float32 (``decode`` casts them to
        z's dtype inside its autograd node, so that their gradients stay
        float32)."""
        return kern.pack_params(dict(self.named_parameters()), self.n_layers)

    # -- LR-side precomputation -------------------------------------------
    def lr_features(self, feat: torch.Tensor
                    ) -> Tuple[Optional[torch.Tensor], ...]:
        """All content-branch 3x3 convs at LR resolution, each NHWC; with
        ``init_q``, the unfolded features alone."""
        with span("lr_conv"):
            if self.init_q:
                return (unfold3x3(feat),)
            x = _nchw(feat)
            zs = [_nhwc(self.k0_conv(x))]
            for i in range(1, self.n_layers):
                kx = getattr(self, f"kx{i}", None)
                zs.append(_nhwc(kx(x)) if kx is not None else None)
            return tuple(zs)

    def lr_features_stacked(self, feat: torch.Tensor) -> torch.Tensor:
        """The channel-stacked content features as ONE 3x3 conv with the
        kq biases folded in: k = relu(q@Wkq + (z_i + bkq_i)). Mode 3 only.
        Returns a contiguous (B, H, W, L*hidden) tensor in the compute
        dtype (bf16: the conv and the bias add each round to bf16, as the
        JAX package's). In fp32 inference on the card
        (``kernels/encoder_conv.engaged``) it is one launch of the encoder's
        implicit-GEMM conv, the stacked weights and biases kept on the
        decoder."""
        with span("lr_conv"):
            ws = [self.k0_conv.conv.weight]
            bs = [self.k0_conv.conv.bias]
            for i in range(1, self.n_layers):
                ws.append(getattr(self, f"kx{i}").conv.weight)
                bs.append(getattr(self, f"kq{i}").dense.bias)
            if ec.engaged(feat, self.dtype):
                w, b, slabs = ec.operands(self, ws, bs)
                z = ec.new_slab(feat, w.shape[0])
                ec.conv(feat, w, b, z, slabs=slabs)
                return z
            if self.dtype == torch.float32:
                y = F.conv2d(_nchw(feat), torch.cat(ws, dim=0),
                             torch.cat(bs), padding=1)
            else:
                dt = self.dtype
                y = (F.conv2d(_nchw(feat).to(dt),
                              torch.cat(ws, dim=0).to(dt), padding=1)
                     + torch.cat(bs).to(dt)[:, None, None])
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
        return self._head(q)

    def hr_step_init_q(self, u_hr: torch.Tensor,
                       syn: torch.Tensor) -> torch.Tensor:
        """The ``init_q`` chain over gathered unfolded features ``u_hr``
        (B, h, w, C*9) and the synthesis input ``syn`` (B, h, w, 3)."""
        s = self._sin(self.first(syn))
        x = s * u_hr
        k = torch.relu(self.k0_dense(x))
        q = k * self._sin(self.q0(s))
        for i in range(1, self.n_layers):
            kq = getattr(self, f"kq{i}")
            if self.mode == 1:
                k = torch.relu(kq(k))
            elif self.mode == 2:
                k = torch.relu(kq(k) + getattr(self, f"kx{i}")(x))
            else:  # modes 3, 4
                k = torch.relu(kq(q) + getattr(self, f"kx{i}")(x))
            q = k * self._sin(getattr(self, f"q{i}")(q))
        return self._head(q)

    def _head(self, q: torch.Tensor) -> torch.Tensor:
        """The output layer: a dense layer, or in mode 4 a 3x3 conv over
        the reflect-padded window."""
        if self.mode == 4:
            qp = F.pad(_nchw(q), (1, 1, 1, 1), mode="reflect")
            return _nhwc(self.last_conv(qp, padding=0))
        return self.last_dense(q)

    def forward(self, feat: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        with span("decoder"):
            _, h_in, w_in, _ = feat.shape
            h_out, w_out = size
            s_h, rem_h = divmod(h_out, h_in)
            s_w, rem_w = divmod(w_out, w_in)
            if (self._fused_ok(feat) and rem_h == 0 and rem_w == 0
                    and 1 <= s_h <= kern.MAX_INT_RATIO
                    and 1 <= s_w <= kern.MAX_INT_RATIO):
                z = self.lr_features_stacked(feat)
                with span("decoder.prepare"):
                    # built in the features' dtype, as the JAX decoder
                    # builds it; the kernels' syn is fp32
                    syn = grids.syn_input_grid((h_in, w_in), (h_out, w_out),
                                               dtype=feat.dtype,
                                               device=feat.device).float()
                    params = self._fused_params()
                return kern.decode(z, syn, params,
                                   ratio=(s_h, s_w)).to(z.dtype)
            # serial column chunks of bsize // H_out queries (reference
            # batched_step); the LR features are computed once for all
            # chunks
            window = self.windows(feat, size)
            chunk = w_out if bsize is None else max(1, bsize // h_out)
            return torch.cat([window(0, h_out,
                                     slice(lo, min(lo + chunk, w_out)))
                              for lo in range(0, w_out, chunk)], dim=2)

    def windows(self, feat: torch.Tensor, size: Tuple[int, int]):
        """``window(row_lo, row_hi, cols)``: the decode of rows [row_lo,
        row_hi) at HR columns ``cols`` (a slice, or a non-decreasing
        integer array such as a clamped stripe's) of the ``size`` grid, the
        unit of chunked, streaming and query-sharded decodes. The LR
        features (the stacked conv on the fused route), the index vectors
        and the relative-coordinate vectors are computed once, here; each
        window selects from them and builds only its own synthesis grid,
        bit-equal to the full grid's. The fused route takes the window
        kernel at every ratio (as the JAX package's ``decode_window``);
        mode 4's output conv is window-local."""
        _, h_in, w_in, _ = feat.shape
        h_out, w_out = size
        rows = grids.nearest_exact_indices(h_in, h_out)
        cols_lr = grids.nearest_exact_indices(w_in, w_out)
        # built in the features' dtype, as the JAX decoder builds it
        ry, rx = grids.rel_coord_axes((h_in, w_in), size, dtype=feat.dtype,
                                      device=feat.device)
        ratio = grids.area_ratio((h_in, w_in), size)

        def pick(v, cols):
            """``v``'s entries at HR columns ``cols``: a view for a slice,
            a gathered copy for an index array."""
            if isinstance(cols, slice):
                return v[cols]
            return v[torch.as_tensor(np.asarray(cols), dtype=torch.long,
                                     device=v.device)]

        def syn(r0, r1, cols):
            return grids.syn_from_axes(ry[r0:r1], pick(rx, cols), ratio)
        if self._fused_ok(feat):
            z = self.lr_features_stacked(feat)
            with span("decoder.prepare"):
                params = self._fused_params()
                # index vectors uploaded once; each window reads views
                rows_v = kern.index_vector(rows, h_in, feat.device)
                cols_v = kern.index_vector(cols_lr, w_in, feat.device)

            def decode(r0, r1, cols):
                with span("decoder.prepare"):
                    grid = syn(r0, r1, cols).float()
                    cols_w = pick(cols_v, cols)
                return kern.decode(z, grid, params, rows=rows_v[r0:r1],
                                   cols=cols_w).to(z.dtype)
        else:
            zs = self.lr_features(feat)

            def decode(r0, r1, cols):
                return self.decode_window(zs, syn(r0, r1, cols),
                                          rows[r0:r1], cols_lr[cols])

        def window(r0, r1, cols):
            with span("decoder.window"):
                return decode(r0, r1, cols)
        return window

    def decode_stripe(self, feat: torch.Tensor, size: Tuple[int, int],
                      col_start: int, stripe_w: int) -> torch.Tensor:
        """Decode the ``stripe_w``-wide column stripe at ``col_start``,
        clamped: columns past W_out repeat the last column (the unit of
        query sharding, ``parallel/sharding.py``; the JAX
        ``decode_stripe``). On the fused route one ``decode_window_fwd``
        over the stripe's column index vector."""
        return self.windows(feat, size)(
            0, size[0], stripe_columns(size[1], col_start, stripe_w))

    def decode_traced(self, feat: torch.Tensor, syn: torch.Tensor,
                      rows: torch.Tensor, cols: torch.Tensor,
                      bsize: int) -> torch.Tensor:
        """Decode with gather indices and synthesis grid given as device
        tensors, the unit of bucketed eval (``train/bucketed.py``; the JAX
        ``decode_traced``): ``syn`` (H_out, W_out, 3) float32, ``rows``
        (H_out,) and ``cols`` (W_out,) int32, non-decreasing. Nothing here
        depends on their values, so one captured CUDA graph serves every
        image padded to the same shapes. Row bands of ``bsize // W_out``
        rows; on the fused route one ``decode_window_fwd`` a band, else
        the eager ``hr_step`` (``hr_step_init_q``) over gathered features.
        Modes 1-3: mode 4's output conv depends on the band borders."""
        if self.mode == 4:
            raise ValueError("decode_traced does not support mode 4")
        b = feat.shape[0]
        h_out, w_out = syn.shape[0], syn.shape[1]
        band = max(1, bsize // max(w_out, 1))
        if self._fused_ok(feat):
            z = self.lr_features_stacked(feat)
            params = self._fused_params()

            def decode_band(lo, hi):
                return kern.decode(z, syn[lo:hi], params, rows=rows[lo:hi],
                                   cols=cols).to(z.dtype)
        else:
            zs = self.lr_features(feat)

            def decode_band(lo, hi):
                gath = tuple(None if z is None else
                             z.index_select(1, rows[lo:hi])
                             .index_select(2, cols) for z in zs)
                synb = syn[None, lo:hi].expand(b, hi - lo, w_out, 3)
                if self.init_q:
                    return self.hr_step_init_q(gath[0], synb)
                return self.hr_step(gath, synb)
        outs = [decode_band(lo, min(lo + band, h_out))
                for lo in range(0, h_out, band)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

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
        if self.init_q:
            return self.hr_step_init_q(gath[0], synb)
        return self.hr_step(gath, synb)


class DIINN(nn.Module):
    """Encoder + implicit decoder: ``net(x_lr, size, bsize=None) ->
    (B, H_out, W_out, 3)``, NHWC."""

    def __init__(self, mode: int = 3, init_q: bool = False,
                 encoder_spec: str = "rdn",
                 hidden_dims: Sequence[int] = (256, 256, 256, 256),
                 exact_sin: bool = False, use_fused: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        from tpu_diinn_torch.nn.registry import make_encoder
        self.encoder = make_encoder(encoder_spec, generator=generator,
                                    dtype=dtype)
        self.decoder = ImplicitDecoder(
            in_channels=self.encoder.out_dim, hidden_dims=hidden_dims,
            mode=mode, init_q=init_q, exact_sin=exact_sin,
            use_fused=use_fused, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        with span("encoder"):
            feat = self.encoder(x)
        return self.decoder(feat, size, bsize)
