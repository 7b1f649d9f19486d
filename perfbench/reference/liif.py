"""Plain PyTorch reference of the benchmark's LIIF configuration.

LIIF (Chen, Liu & Wang, CVPR 2021; ``configs/train-div2k/
train_rdn-liif.yaml`` of github.com/yinboc/liif) as its paper and the
configuration file describe it: an RDN encoder without its upsampling
head, then a local implicit image function with ``local_ensemble``,
``feat_unfold`` and ``cell_decode`` on. The features are unfolded to
their 3x3 neighbourhoods (``F.unfold``, channel-major: C x 9 channels).
For each corner v = (vy, vx) in {-1, 1}^2 an HR query at pixel centre c
(over [-1, 1]) is shifted by v / (H_in, W_in) + 1e-6, clamped to
+-(1 - 1e-6), and reads the LR cell that ``grid_sample(mode="nearest",
align_corners=False)`` maps it to; then

    rel = (c - centre of that cell) * (H_in, W_in)
    rel_cell = (2 / H_out, 2 / W_out) * (H_in, W_in)
    pred_v = fc4(relu(fc3(relu(fc2(relu(fc1(relu(
                 L0([unfold, rel, rel_cell])))))))))
    area_v = |rel_y * rel_x| + 1e-9

with L0 one Linear(C x 9 + 4 -> h0) applied to each query. The output is
the sum of pred_v times the area of the diagonally opposite corner, over
the sum of the areas. Inputs in [0, 1] are mapped to [-1, 1]; a
prediction is mapped back and clamped (``diinn.predict``'s convention).

Departures from the published code, each a choice of arithmetic and not
of the function:

- the query grid, the shifted coordinates and the nearest indices are
  worked out in float64 (the published code in float32), so that the ties
  of integer scales fall as its goldens show;
- L0's weight is assembled from the state-dict tensors of the model under
  test by name (``param_spec``): ``imnet_feat`` (a bias-less 3x3 conv,
  reshaped to (h0, C x 9)), ``imnet_rel`` (with L0's bias) and
  ``imnet_cell``, concatenated in the published input order. The
  reference applies it per query and per corner, as published; the
  program computes the unfolded part once at LR as a conv and gathers it;
- the decoder runs in blocks of HR rows, so that an x8 request fits.

The encoder is ``diinn.encode`` (RDN or EDSR-baseline), unchanged. Nothing
here comes from the program under test. Products run in float32 with the
operands of ``precision.Rounding``; the caller turns TF32 off. Parameters
are a dict of float32 tensors under the names of ``param_spec``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.diinn import _conv, encode, normalize
from perfbench.reference.precision import Rounding

Params = Dict[str, torch.Tensor]

EPS_SHIFT = 1e-6
CLAMP = 1.0 - 1e-6
# (vy, vx) in the published loop order; the area swap reverses it
CORNERS = ((-1, -1), (-1, 1), (1, -1), (1, 1))


# -- parameters -------------------------------------------------------------

def _encoder_spec(e: dict) -> List[Tuple[str, tuple, int]]:
    cin = e["in_channels"]
    if e["kind"] == "rdn":
        g0, g, nb, nc = e["growth0"], e["growth"], e["blocks"], e["convs"]
        spec = _conv("encoder.sfe1", cin, g0, 3) + _conv("encoder.sfe2",
                                                          g0, g0, 3)
        for i in range(nb):
            for c in range(nc):
                spec += _conv(f"encoder.rdb{i}.conv{c}", g0 + c * g, g, 3)
            spec += _conv(f"encoder.rdb{i}.lff", g0 + nc * g, g0, 1)
        return (spec + _conv("encoder.gff1", nb * g0, g0, 1)
                + _conv("encoder.gff2", g0, g0, 3))
    if e["kind"] == "edsr-baseline":
        nf = e["features"]
        spec = _conv("encoder.head", cin, nf, 3)
        for i in range(e["resblocks"]):
            spec += _conv(f"encoder.res{i}.conv0", nf, nf, 3)
            spec += _conv(f"encoder.res{i}.conv1", nf, nf, 3)
        return spec + _conv("encoder.body_tail", nf, nf, 3)
    raise ValueError(f"encoder {e['kind']!r}")


def feat_channels(config: dict) -> int:
    e = config["encoder"]
    return e["growth0"] if e["kind"] == "rdn" else e["features"]


def param_spec(config: dict) -> List[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every parameter, in a fixed order. L0's
    three parts take L0's fan-in, C x 9 + 4, as the published
    Linear(580, 256) draws them."""
    im = config["imnet"]
    if not (im["local_ensemble"] and im["feat_unfold"]
            and im["cell_decode"]):
        raise ValueError("the reference is LIIF with local_ensemble, "
                         "feat_unfold and cell_decode on")
    spec = _encoder_spec(config["encoder"])
    c = feat_channels(config)
    h = list(im["hidden_dims"])
    fan0 = c * 9 + 4
    spec += [("imnet_feat.conv.weight", (h[0], c, 3, 3), fan0),
             ("imnet_rel.dense.weight", (h[0], 2), fan0),
             ("imnet_rel.dense.bias", (h[0],), fan0),
             ("imnet_cell.dense.weight", (h[0], 2), fan0)]
    dims = h + [im["out_channels"]]
    for i in range(1, len(dims)):
        spec += [(f"imnet_fc{i}.dense.weight", (dims[i], dims[i - 1]),
                  dims[i - 1]),
                 (f"imnet_fc{i}.dense.bias", (dims[i],), dims[i - 1])]
    return spec


def layer0(p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight (h0, C x 9 + 4), bias) of L0 over [unfold, rel, rel_cell]."""
    wf = p["imnet_feat.conv.weight"]
    w = torch.cat([wf.reshape(wf.shape[0], -1), p["imnet_rel.dense.weight"],
                   p["imnet_cell.dense.weight"]], dim=1)
    return w, p["imnet_rel.dense.bias"]


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            rnd: Rounding) -> torch.Tensor:
    return rnd.output(F.linear(rnd.operand(x), rnd.operand(w), b))


# -- the corner lookups -----------------------------------------------------

def _centres(n: int, device) -> torch.Tensor:
    """Pixel-centre coordinates of ``n`` cells over [-1, 1], float64."""
    return -1.0 + (2 * torch.arange(n, dtype=torch.float64,
                                    device=device) + 1) / n


def corner_axis(n_in: int, n_out: int, v: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LR index, rel) of each of ``n_out`` HR positions of one axis for
    corner offset ``v``: the nearest cell of ``grid_sample`` (round half
    to even of ((c + 1) n_in - 1) / 2) at the shifted, clamped coordinate;
    rel float64, scaled by ``n_in``."""
    c = _centres(n_out, device)
    shifted = (c + (v / n_in + EPS_SHIFT)).clamp(-CLAMP, CLAMP)
    idx = torch.round(((shifted + 1) * n_in - 1) / 2).clamp(0, n_in - 1)
    idx = idx.long()
    return idx, (c - _centres(n_in, device)[idx]) * n_in


# -- decode -----------------------------------------------------------------

def _row_blocks(b: int, h_out: int, w_out: int, block: int):
    rows = max(1, block // max(1, b * w_out))
    return [(r, min(r + rows, h_out)) for r in range(0, h_out, rows)]


def decode_rows(p: Params, config: dict, unfolded: torch.Tensor,
                lr_hw: Tuple[int, int], hr_hw: Tuple[int, int], r0: int,
                r1: int, rnd: Rounding) -> torch.Tensor:
    """The output of HR rows [r0, r1) of every image, from the unfolded
    features (B, H_in x W_in, C x 9): (B, r1 - r0, W_out, out)."""
    (h_in, w_in), (h_out, w_out) = lr_hw, hr_hw
    b, dev = unfolded.shape[0], unfolded.device
    n = (r1 - r0) * w_out
    w0, b0 = layer0(p)
    n_fc = len(config["imnet"]["hidden_dims"])
    rel_cell = torch.tensor([2.0 / h_out * h_in, 2.0 / w_out * w_in],
                            dtype=torch.float32, device=dev)
    preds, areas = [], []
    for vy, vx in CORNERS:
        iy, ry = corner_axis(h_in, h_out, vy, dev)
        ix, rx = corner_axis(w_in, w_out, vx, dev)
        iy, ry = iy[r0:r1], ry[r0:r1]
        cells = (iy[:, None] * w_in + ix[None, :]).reshape(-1)
        rel = torch.stack([ry[:, None].expand(-1, w_out),
                           rx[None, :].expand(r1 - r0, -1)],
                          dim=-1).reshape(-1, 2).float()
        inp = torch.cat([unfolded[:, cells], rel.expand(b, n, 2),
                         rel_cell.expand(b, n, 2)], dim=-1)
        y = torch.relu(_linear(inp, w0, b0, rnd))
        for i in range(1, n_fc):
            y = torch.relu(_linear(y, p[f"imnet_fc{i}.dense.weight"],
                                   p[f"imnet_fc{i}.dense.bias"], rnd))
        preds.append(_linear(y, p[f"imnet_fc{n_fc}.dense.weight"],
                             p[f"imnet_fc{n_fc}.dense.bias"], rnd))
        areas.append(torch.abs(rel[:, 0] * rel[:, 1]) + 1e-9)
    areas = areas[::-1]
    total = sum(areas)
    out = sum(pr * (a / total)[:, None] for pr, a in zip(preds, areas))
    return out.reshape(b, r1 - r0, w_out, -1)


def decode(p: Params, config: dict, feat: torch.Tensor,
           hr_hw: Tuple[int, int], rnd: Rounding, block: int = 1 << 19
           ) -> torch.Tensor:
    """The implicit decode (B, H_out, W_out, out) of NCHW features
    ``feat``, ``block`` queries at a time; differentiable."""
    b, c, h_in, w_in = feat.shape
    unfolded = F.unfold(feat, 3, padding=1).view(b, c * 9, h_in * w_in)
    unfolded = unfolded.permute(0, 2, 1)
    return torch.cat([decode_rows(p, config, unfolded, (h_in, w_in), hr_hw,
                                  r0, r1, rnd)
                      for r0, r1 in _row_blocks(b, *hr_hw, block)], dim=1)


def forward(p: Params, config: dict, x: torch.Tensor,
            hr_hw: Tuple[int, int], rnd: Rounding, block: int = 1 << 19
            ) -> torch.Tensor:
    """The model's output (B, H_out, W_out, out) of NCHW input ``x``."""
    return decode(p, config, encode(p, config, x, rnd), hr_hw, rnd, block)


@torch.no_grad()
def predict(p: Params, config: dict, lr: torch.Tensor,
            hr_hw: Tuple[int, int], rnd: Rounding, block: int = 1 << 19
            ) -> torch.Tensor:
    """Clamped [0, 1] prediction (B, H_out, W_out, 3) of NHWC ``lr`` in
    [0, 1] at output size ``hr_hw``."""
    out = forward(p, config, normalize(lr.permute(0, 3, 1, 2)), hr_hw, rnd,
                  block)
    return torch.clamp(out * 0.5 + 0.5, 0.0, 1.0)
