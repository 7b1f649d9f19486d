"""Analytic FLOP accounting and MFU for the flagship training step.

Counterpart of ``tpu_diinn/train/flops.py``, with the same counts: exact
MAC-based model FLOPs (2 x MACs) of the RDN-B encoder (D = 16 RDBs x C = 8
convs, G = G0 = 64) and the mode-3 dual-MLP implicit decoder in its
factorized form (LR 3x3 convs + HR dense chain, ``nn/diinn.py``). Gathers,
bias adds, activations and the optimizer are not counted: the tensor-core
roofline does not credit them.

``PEAK_FLOPS`` holds the card's dense rates from NVIDIA's H100 data sheet
(at the full power limit, 700 W for the SXM part, 350 W for PCIe), by SKU
and by the precision the products run in; ``sku`` names the SKU from
``torch.cuda.get_device_name``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

# dense matmul FLOP/s by (SKU, precision)
PEAK_FLOPS = {
    ("H100 SXM", "bfloat16"): 989e12,
    ("H100 SXM", "tf32"): 495e12,
    ("H100 SXM", "float32"): 67e12,
    ("H100 PCIe", "bfloat16"): 756e12,
    ("H100 PCIe", "tf32"): 378e12,
    ("H100 PCIe", "float32"): 51.2e12,
}


def sku(device_name: str) -> str:
    """The ``PEAK_FLOPS`` SKU of a card, from its CUDA device name (e.g.
    ``NVIDIA H100 80GB HBM3`` is the SXM part)."""
    if "H100" not in device_name:
        raise ValueError(f"no peak rates for {device_name!r}")
    return "H100 PCIe" if "PCIe" in device_name else "H100 SXM"


def conv_macs_per_px(kh: int, kw: int, cin: int, cout: int) -> int:
    return kh * kw * cin * cout


def rdn_macs_per_px(d: int = 16, c: int = 8, g: int = 64, g0: int = 64,
                    in_ch: int = 3) -> int:
    """RDN feature extractor (no upsampling) MACs per LR pixel."""
    total = conv_macs_per_px(3, 3, in_ch, g0)          # SFENet1
    total += conv_macs_per_px(3, 3, g0, g)             # SFENet2
    rdb = sum(conv_macs_per_px(3, 3, g0 + i * g, g) for i in range(c))
    rdb += conv_macs_per_px(1, 1, g0 + c * g, g0)      # local fusion
    total += d * rdb
    total += conv_macs_per_px(1, 1, d * g0, g0)        # GFF 1x1
    total += conv_macs_per_px(3, 3, g0, g0)            # GFF 3x3
    return total


def edsr_baseline_macs_per_px(n_resblocks: int = 16, n_feats: int = 64,
                              in_ch: int = 3) -> int:
    """EDSR-baseline headless encoder MACs per LR pixel."""
    total = conv_macs_per_px(3, 3, in_ch, n_feats)
    total += n_resblocks * 2 * conv_macs_per_px(3, 3, n_feats, n_feats)
    total += conv_macs_per_px(3, 3, n_feats, n_feats)
    return total


def decoder_lr_macs_per_px(feat_ch: int = 64,
                           hidden_dims: Sequence[int] = (256,) * 4) -> int:
    """Factorized content-branch 3x3 convs at LR resolution (k0 + kx_i)."""
    return sum(conv_macs_per_px(3, 3, feat_ch, h) for h in hidden_dims)


def decoder_hr_macs_per_query(hidden_dims: Sequence[int] = (256,) * 4,
                              out_ch: int = 3) -> int:
    """Dense chain per HR query: q0 (3 -> h0), per layer kq + q (h x h),
    last (h -> 3)."""
    h = list(hidden_dims)
    total = 3 * h[0]
    for i in range(1, len(h)):
        total += 2 * h[i - 1] * h[i]
    total += h[-1] * out_ch
    return total


def train_step_flops(batch: int, patch: int, scales: Iterable[float],
                     encoder: str = "rdn",
                     hidden_dims: Sequence[int] = (256,) * 4,
                     bwd_mult: float = 3.0) -> Dict[str, float]:
    """Model FLOPs of one multi-scale training step (forward + backward):
    {'encoder', 'decoder_lr', 'decoder_hr', 'total'}. ``bwd_mult = 3`` is
    the dense forward + backward factor (the input and the weight
    gradients each cost one forward)."""
    enc_px = rdn_macs_per_px() if encoder.startswith("rdn") else \
        edsr_baseline_macs_per_px()
    enc = dec_lr = dec_hr = 0.0
    for s in scales:
        lr_px = batch * patch * patch
        hr_px = batch * round(patch * s) * round(patch * s)
        enc += 2 * enc_px * lr_px
        dec_lr += 2 * decoder_lr_macs_per_px(64, hidden_dims) * lr_px
        dec_hr += 2 * decoder_hr_macs_per_query(hidden_dims) * hr_px
    out = {"encoder": enc * bwd_mult, "decoder_lr": dec_lr * bwd_mult,
           "decoder_hr": dec_hr * bwd_mult}
    out["total"] = sum(out.values())
    return out


def mfu(flops_per_step: float, step_time_s: float, chip: str = "H100 SXM",
        dtype: str = "bfloat16") -> float:
    """Model FLOP/s over the peak of ``chip`` (a ``PEAK_FLOPS`` SKU) in
    ``dtype``."""
    return flops_per_step / step_time_s / PEAK_FLOPS[(chip, dtype)]
