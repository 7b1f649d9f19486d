"""The benchmark's frozen yardstick: model FLOPs, decoder work, and peaks.

Model FLOPs are 2 x MACs of the model as published, whatever implements
it: the encoder's convs (RDN-B or EDSR-baseline, no upsampling head),
the decoder's content convs at LR (one 3x3 conv of the features per
layer) and its dense chain per HR query. Gathers, bias adds, activations,
the loss and the optimizer are not counted. A training step counts the
forward three times (the forward, and the input and weight gradients
each costing one forward). These functions are a copy of the program's
``train/flops.py`` as it stood when the benchmark was defined
(``tests/test_counts.py`` holds them equal at the cells' shapes); the copy
is the yardstick, so that no change to the program can move it.

Peaks are NVIDIA's H100 data sheet's dense rates at the full power limit
(700 W SXM, 350 W PCIe), and the HBM bandwidth (SXM 3.35 TB/s, PCIe
2.0 TB/s). A computation is held to the peak of the fastest product its
precision allows: bfloat16 to the bf16 rate, float32 to the TF32 rate
(the fastest product of float32 inputs, so no implementation of a float32
model can read over 100%; the float32 rate outside the tensor cores is
below what the port's 3xTF32 decoder reaches).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

PEAK_FLOPS = {
    ("H100 SXM", "bfloat16"): 989e12,
    ("H100 SXM", "tf32"): 495e12,
    ("H100 SXM", "float32"): 67e12,
    ("H100 PCIe", "bfloat16"): 756e12,
    ("H100 PCIe", "tf32"): 378e12,
    ("H100 PCIe", "float32"): 51.2e12,
}
PEAK_BYTES_PER_S = {"H100 SXM": 3.35e12, "H100 PCIe": 2.0e12}
# the compute dtype -> the PEAK_FLOPS precision its products are held to
PRODUCT_PEAK = {"bfloat16": "bfloat16", "float32": "tf32"}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def sku(device_name: str) -> str:
    """The peaks' SKU of a card from its CUDA device name (``NVIDIA H100
    80GB HBM3`` is the SXM part)."""
    if "H100" not in device_name:
        raise ValueError(f"no peak rates for {device_name!r}")
    return "H100 PCIe" if "PCIe" in device_name else "H100 SXM"


def peak_flops(device_name: str, dtype: str) -> float:
    return PEAK_FLOPS[(sku(device_name), PRODUCT_PEAK[dtype])]


def peak_bytes_per_s(device_name: str) -> float:
    return PEAK_BYTES_PER_S[sku(device_name)]


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
    """The decoder's content convs at LR resolution (k0 + kx_i)."""
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


# -- per configuration file ------------------------------------------------

def encoder_macs_per_px(config: dict) -> int:
    e = config["encoder"]
    if e["kind"] == "rdn":
        return rdn_macs_per_px(e["blocks"], e["convs"], e["growth"],
                               e["growth0"], e["in_channels"])
    return edsr_baseline_macs_per_px(e["resblocks"], e["features"],
                                     e["in_channels"])


def _feat_ch(config: dict) -> int:
    e = config["encoder"]
    return e["growth0"] if e["kind"] == "rdn" else e["features"]


def forward_flops(config: dict, lr_px: int, hr_px: int) -> Dict[str, float]:
    """Model FLOPs of one forward over ``lr_px`` LR pixels decoded to
    ``hr_px`` HR queries: {'encoder', 'decoder_lr', 'decoder_hr'}."""
    h = config["decoder"]["hidden_dims"]
    return {"encoder": 2.0 * encoder_macs_per_px(config) * lr_px,
            "decoder_lr": 2.0 * decoder_lr_macs_per_px(_feat_ch(config), h)
            * lr_px,
            "decoder_hr": 2.0 * decoder_hr_macs_per_query(
                h, config["decoder"]["out_channels"]) * hr_px}


def train_step_flops(config: dict, batch: int, patch: int,
                     scales: Iterable[float]) -> float:
    """Model FLOPs of one multi-scale training step (forward + backward,
    3 x the forward): the encoder once per scale's patches, as published
    (the program's shared pass over the stacked scales is the same
    work)."""
    total = 0.0
    for s in scales:
        side = round(patch * s)
        total += sum(forward_flops(config, batch * patch * patch,
                                   batch * side * side).values())
    return 3.0 * total


def predict_flops(config: dict, lr_hw, hr_hw) -> float:
    """Model FLOPs of one forward of an image of ``lr_hw`` to ``hr_hw``."""
    return sum(forward_flops(config, lr_hw[0] * lr_hw[1],
                             hr_hw[0] * hr_hw[1]).values())


# -- the decoder's least time --------------------------------------------

def _decoder_weight_bytes(hidden: Sequence[int], out_ch: int,
                          dtype: str) -> int:
    """The chain's weights in the compute dtype, its biases float32."""
    h = list(hidden)
    w = 3 * h[0] + sum(2 * h[i - 1] * h[i] for i in range(1, len(h)))
    w += h[-1] * out_ch
    b = h[0] + sum(2 * x for x in h[1:]) + out_ch
    return w * ITEMSIZE[dtype] + b * 4


def decoder_call(config: dict, dtype: str, batch: int, lr_hw, hr_hw,
                 backward: bool) -> Dict[str, float]:
    """FLOPs and bytes of one decode of ``batch`` images (its forward, or
    with ``backward`` its gradient): z (the stacked LR convs in the
    compute dtype), the synthesis grid (H_out x W_out x 3 float32), the
    weights and the output (float32) each counted once; the gradient
    also reads the upstream gradient and writes dz and the weights'
    float32 gradients."""
    d = config["decoder"]
    h, out_ch = d["hidden_dims"], d["out_channels"]
    n_query = batch * hr_hw[0] * hr_hw[1]
    flops = 2.0 * decoder_hr_macs_per_query(h, out_ch) * n_query
    z = batch * lr_hw[0] * lr_hw[1] * sum(h) * ITEMSIZE[dtype]
    syn = hr_hw[0] * hr_hw[1] * 3 * 4
    w = _decoder_weight_bytes(h, out_ch, dtype)
    out = n_query * out_ch * 4
    if not backward:
        return {"flops": flops, "bytes": float(z + syn + w + out)}
    w_grad = _decoder_weight_bytes(h, out_ch, "float32")
    return {"flops": 2 * flops,
            "bytes": float(2 * z + syn + w + out + w_grad)}


def least_seconds(call: Dict[str, float], device_name: str,
                  dtype: str) -> float:
    """The least time the card could take for ``call``: the larger of its
    FLOPs over the precision's peak and its bytes over the HBM rate."""
    return max(call["flops"] / peak_flops(device_name, dtype),
               call["bytes"] / peak_bytes_per_s(device_name))
