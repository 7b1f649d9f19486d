"""LIIF's model FLOPs and its decoder's work, on ``counts.py``'s yardstick.

Model FLOPs are 2 x MACs of the model as published, whatever implements
it: the encoder (``counts.encoder_macs_per_px``), the unfolded-feature
part of the imnet's first layer (C x 9 -> h0) once per LR pixel, and per
HR query and corner (four corners) the rest of the first layer (rel and
rel_cell, 2 x 2 -> h0), the hidden layers and the output layer. The first
layer's feature part is counted at LR: the lesser count of the same
function (the published code applies it per query and corner to the
gathered unfolded features), so that the yardstick stays whatever
implements it. Gathers, the blend, activations and biases are not
counted. At the configuration's widths a query and corner is 198,400
MACs (1,024 + 3 x 256^2 + 768).

The decoder call is the per-query part, with its bytes: z (the first
layer's feature conv at LR, h0 float32 channels) read once, the imnet's
float32 weights once, and the float32 output written once. Its least time
is ``counts.least_seconds``: the larger of its FLOPs over the precision's
peak (TF32's for float32, as ``decoder_roofline``) and its bytes over
HBM's.
"""

from __future__ import annotations

from typing import Dict, Sequence

from perfbench import counts

CORNERS = 4


def _feat_ch(config: dict) -> int:
    e = config["encoder"]
    return e["growth0"] if e["kind"] == "rdn" else e["features"]


def feat_macs_per_px(config: dict) -> int:
    """The first layer's unfolded-feature part (a 3x3 conv), per LR px."""
    return counts.conv_macs_per_px(3, 3, _feat_ch(config),
                                   config["imnet"]["hidden_dims"][0])


def query_macs(hidden: Sequence[int], out_ch: int) -> int:
    """MACs of one query at one corner: rel and rel_cell into layer 0,
    then each hidden layer and the output layer."""
    h = list(hidden)
    total = 4 * h[0]
    for i in range(1, len(h)):
        total += h[i - 1] * h[i]
    return total + h[-1] * out_ch


def _query_flops(config: dict, n_query: int) -> float:
    im = config["imnet"]
    return (2.0 * CORNERS * query_macs(im["hidden_dims"], im["out_channels"])
            * n_query)


def predict_flops(config: dict, lr_hw, hr_hw) -> float:
    """Model FLOPs of one forward of an image of ``lr_hw`` to ``hr_hw``:
    the encoder and the first layer's feature part at LR, the rest per
    HR query and corner."""
    lr_px = lr_hw[0] * lr_hw[1]
    return (2.0 * (counts.encoder_macs_per_px(config)
                   + feat_macs_per_px(config)) * lr_px
            + _query_flops(config, hr_hw[0] * hr_hw[1]))


def _weight_bytes(config: dict) -> int:
    im = config["imnet"]
    dims = [_feat_ch(config) * 9 + 4] + list(im["hidden_dims"]) + [
        im["out_channels"]]
    return 4 * sum(dims[i - 1] * dims[i] + dims[i]
                   for i in range(1, len(dims)))


def decoder_call(config: dict, batch: int, lr_hw, hr_hw) -> Dict[str, float]:
    """FLOPs and bytes of one float32 decode of ``batch`` images."""
    im = config["imnet"]
    n_query = batch * hr_hw[0] * hr_hw[1]
    z = batch * lr_hw[0] * lr_hw[1] * im["hidden_dims"][0] * 4
    out = n_query * im["out_channels"] * 4
    return {"flops": _query_flops(config, n_query),
            "bytes": float(z + _weight_bytes(config) + out)}
