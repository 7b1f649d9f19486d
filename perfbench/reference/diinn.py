"""Plain PyTorch reference of the benchmark's DIINN configurations.

DIINN (Nguyen & Beksi, WACV 2023) as the configuration files describe it:
an RDN or EDSR-baseline encoder, then the mode-3 dual-interactive implicit
decoder without ``init_q``, whose sine is the degree-11 polynomial of the
configuration. Every HR query (y, x) reads the LR cell that PyTorch's
``nearest-exact`` resize maps it to, and runs

    k_0 = relu(conv_k0(f));  q_0 = k_0 * sin(q0([rel_y, rel_x, ratio]))
    k_i = relu(kq_i(q_{i-1}) + conv_kx_i(f));  q_i = k_i * sin(q_i(q_{i-1}))
    out = last(q_{L-1})

with ``conv_k0`` (bias) and ``conv_kx_i`` (no bias) 3x3 convs of the
features f at the query's LR cell, ``rel`` the query's pixel-centre
coordinate minus its LR cell's, times the LR size, and ``ratio`` the LR
area over the HR area. Inputs in [0, 1] are mapped to [-1, 1]; a
prediction is mapped back and clamped; the training loss is the mean over
scales of the L1 distance to the mapped HR target.

Written from that description alone: nothing here comes from the program
under test, and every derived quantity (the per-layer LR convs, the
gather indices, the synthesis grid) is worked out again here. Products run
in float32 with the operands of ``precision.Rounding`` (float32, or a
control's lower precision); the caller turns TF32 off. The decoder runs in
blocks of HR rows and the encoder's backward in blocks of images, so that
a full-size step fits beside nothing else on the card.

Parameters are a dict of float32 tensors under the names of
``param_spec``, the torch state-dict names of the model.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Rounding

Params = Dict[str, torch.Tensor]

# The configuration's sine: a degree-11 odd minimax polynomial on [-pi, pi]
# after a two-term Cody-Waite reduction, its derivative the degree-12
# polynomial cosine on the same reduction.
_INV_TWO_PI = 0.15915494309189535
_TWO_PI_HI = 6.2831855
_TWO_PI_LO = -1.7484555e-07
_SIN = (9.9999959990e-01, -1.6666552631e-01, 8.3324029612e-03,
        -1.9808632624e-04, 2.6997138288e-06, -2.0362212148e-08)
_COS = (9.9999995963e-01, -4.9999978455e-01, 4.1666391842e-02,
        -1.3887438022e-03, 2.4763353977e-05, -2.7023758023e-07,
        1.7066625985e-09)


def _poly(r2: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    acc = torch.full_like(r2, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * r2 + c
    return acc


def _reduce(x: torch.Tensor) -> torch.Tensor:
    n = torch.round(x * _INV_TWO_PI)
    return x - n * _TWO_PI_HI - n * _TWO_PI_LO


class _PolySin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        r = _reduce(x)
        return r * _poly(r * r, _SIN)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        r = _reduce(x)
        return g * _poly(r * r, _COS)


def poly_sin(x: torch.Tensor) -> torch.Tensor:
    return _PolySin.apply(x)


# -- parameters -------------------------------------------------------------

def _conv(name: str, cin: int, cout: int, k: int, bias: bool = True):
    out = [(f"{name}.conv.weight", (cout, cin, k, k), cin * k * k)]
    if bias:
        out.append((f"{name}.conv.bias", (cout,), cin * k * k))
    return out


def _dense(name: str, cin: int, cout: int):
    return [(f"{name}.dense.weight", (cout, cin), cin),
            (f"{name}.dense.bias", (cout,), cin)]


def _check(config: dict) -> None:
    d = config["decoder"]
    if d["mode"] != 3 or d["init_q"] or d["sine"] != "polynomial":
        raise ValueError("the reference is the mode-3 decoder without "
                         "init_q, with the polynomial sine")
    if config["encoder"]["kind"] not in ("rdn", "edsr-baseline"):
        raise ValueError(f"encoder {config['encoder']['kind']!r}")


def encoder_out_channels(config: dict) -> int:
    e = config["encoder"]
    return e["growth0"] if e["kind"] == "rdn" else e["features"]


def param_spec(config: dict) -> List[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every parameter, in a fixed order."""
    _check(config)
    e, d = config["encoder"], config["decoder"]
    spec = []
    cin = e["in_channels"]
    if e["kind"] == "rdn":
        g0, g, nb, nc = e["growth0"], e["growth"], e["blocks"], e["convs"]
        spec += _conv("encoder.sfe1", cin, g0, 3)
        spec += _conv("encoder.sfe2", g0, g0, 3)
        for i in range(nb):
            for c in range(nc):
                spec += _conv(f"encoder.rdb{i}.conv{c}", g0 + c * g, g, 3)
            spec += _conv(f"encoder.rdb{i}.lff", g0 + nc * g, g0, 1)
        spec += _conv("encoder.gff1", nb * g0, g0, 1)
        spec += _conv("encoder.gff2", g0, g0, 3)
    else:
        nf = e["features"]
        spec += _conv("encoder.head", cin, nf, 3)
        for i in range(e["resblocks"]):
            spec += _conv(f"encoder.res{i}.conv0", nf, nf, 3)
            spec += _conv(f"encoder.res{i}.conv1", nf, nf, 3)
        spec += _conv("encoder.body_tail", nf, nf, 3)
    f = encoder_out_channels(config)
    h = list(d["hidden_dims"])
    spec += _conv("decoder.k0_conv", f, h[0], 3)
    for i in range(1, len(h)):
        spec += _dense(f"decoder.kq{i}", h[i - 1], h[i])
        spec += _conv(f"decoder.kx{i}", f, h[i], 3, bias=False)
    spec += _dense("decoder.q0", 3, h[0])
    for i in range(1, len(h)):
        spec += _dense(f"decoder.q{i}", h[i - 1], h[i])
    spec += _dense("decoder.last_dense", h[-1], d["out_channels"])
    return spec


# -- layers -------------------------------------------------------------------

def conv(p: Params, name: str, x: torch.Tensor, rnd: Rounding
         ) -> torch.Tensor:
    """Same-padded stride-1 conv of NCHW ``x`` by layer ``name``."""
    w = p[f"{name}.conv.weight"]
    y = F.conv2d(rnd.operand(x), rnd.operand(w), p.get(f"{name}.conv.bias"),
                 padding=w.shape[-1] // 2)
    return rnd.output(y)


def dense(p: Params, name: str, x: torch.Tensor, rnd: Rounding
          ) -> torch.Tensor:
    y = F.linear(rnd.operand(x), rnd.operand(p[f"{name}.dense.weight"]),
                 p[f"{name}.dense.bias"])
    return rnd.output(y)


def encode(p: Params, config: dict, x: torch.Tensor, rnd: Rounding
           ) -> torch.Tensor:
    """Features (B, C, H, W) of NCHW input ``x`` (already in [-1, 1])."""
    e = config["encoder"]
    if e["kind"] == "rdn":
        f1 = conv(p, "encoder.sfe1", x, rnd)
        y = conv(p, "encoder.sfe2", f1, rnd)
        outs = []
        for i in range(e["blocks"]):
            t = y
            for c in range(e["convs"]):
                t = torch.cat([t, torch.relu(
                    conv(p, f"encoder.rdb{i}.conv{c}", t, rnd))], dim=1)
            y = rnd.store(y + conv(p, f"encoder.rdb{i}.lff", t, rnd))
            outs.append(y)
        y = conv(p, "encoder.gff1", torch.cat(outs, dim=1), rnd)
        return rnd.store(conv(p, "encoder.gff2", y, rnd) + f1)
    y = conv(p, "encoder.head", x, rnd)
    r = y
    for i in range(e["resblocks"]):
        r = rnd.store(r + conv(p, f"encoder.res{i}.conv1", torch.relu(
            conv(p, f"encoder.res{i}.conv0", r, rnd)), rnd))
    return rnd.store(y + conv(p, "encoder.body_tail", r, rnd))


def lr_convs(p: Params, config: dict, feat: torch.Tensor, rnd: Rounding
             ) -> List[torch.Tensor]:
    """Each decoder layer's content conv of the features, at LR (NCHW)."""
    n = len(config["decoder"]["hidden_dims"])
    return ([conv(p, "decoder.k0_conv", feat, rnd)]
            + [conv(p, f"decoder.kx{i}", feat, rnd) for i in range(1, n)])


def chain(p: Params, config: dict, zs: List[torch.Tensor], syn: torch.Tensor,
          rnd: Rounding) -> torch.Tensor:
    """The per-query network over gathered LR convs ``zs`` (each (M, h))
    and the synthesis input ``syn`` (M, 3): (M, out)."""
    k = torch.relu(zs[0])
    q = k * poly_sin(dense(p, "decoder.q0", syn, rnd))
    for i in range(1, len(zs)):
        k = torch.relu(dense(p, f"decoder.kq{i}", q, rnd) + zs[i])
        q = k * poly_sin(dense(p, f"decoder.q{i}", q, rnd))
    return dense(p, "decoder.last_dense", q, rnd)


# -- the HR query grid ------------------------------------------------------

def nearest_exact(n_in: int, n_out: int, device) -> torch.Tensor:
    """LR index of each of ``n_out`` HR positions under ``nearest-exact``:
    floor((i + 1/2) n_in / n_out), clamped to n_in - 1."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    idx = torch.floor((i + 0.5) * (n_in / n_out))
    return idx.clamp(0, n_in - 1).long()


def _centres(n: int, device) -> torch.Tensor:
    """Pixel-centre coordinates of ``n`` cells over [-1, 1], float64."""
    return -1.0 + (2 * torch.arange(n, dtype=torch.float64,
                                    device=device) + 1) / n


def rel_coords(n_in: int, n_out: int, device) -> torch.Tensor:
    """Each HR position's centre minus its LR cell's, times ``n_in``."""
    idx = nearest_exact(n_in, n_out, device)
    return (_centres(n_out, device) - _centres(n_in, device)[idx]) * n_in


def syn_rows(lr_hw: Tuple[int, int], hr_hw: Tuple[int, int], r0: int,
             r1: int, device) -> torch.Tensor:
    """The synthesis input of HR rows [r0, r1): (r1 - r0, W_out, 3)
    float32 [rel_y, rel_x, LR area / HR area]."""
    (h_in, w_in), (h_out, w_out) = lr_hw, hr_hw
    ry = rel_coords(h_in, h_out, device)[r0:r1]
    rx = rel_coords(w_in, w_out, device)
    ratio = (h_in * w_in) / (h_out * w_out)
    grid = torch.stack([ry[:, None].expand(-1, w_out),
                        rx[None, :].expand(r1 - r0, -1),
                        torch.full((r1 - r0, w_out), ratio,
                                   dtype=torch.float64, device=device)],
                       dim=-1)
    return grid.float()


def _row_blocks(b: int, h_out: int, w_out: int, block: int):
    rows = max(1, block // max(1, b * w_out))
    return [(r, min(r + rows, h_out)) for r in range(0, h_out, rows)]


def decode_rows(p: Params, config: dict, zs: List[torch.Tensor],
                hr_hw: Tuple[int, int], r0: int, r1: int, rnd: Rounding
                ) -> torch.Tensor:
    """The decoder's output for HR rows [r0, r1) of every image, from the
    LR convs ``zs`` (each (B, h, H_in, W_in)): (B, r1 - r0, W_out, out)."""
    b, _, h_in, w_in = zs[0].shape
    h_out, w_out = hr_hw
    dev = zs[0].device
    ri = nearest_exact(h_in, h_out, dev)[r0:r1]
    ci = nearest_exact(w_in, w_out, dev)
    gathered = [z[:, :, ri][:, :, :, ci].permute(0, 2, 3, 1)
                .reshape(-1, z.shape[1]) for z in zs]
    syn = syn_rows((h_in, w_in), hr_hw, r0, r1, dev)
    syn = syn[None].expand(b, -1, -1, -1).reshape(-1, 3)
    out = chain(p, config, gathered, syn, rnd)
    return out.reshape(b, r1 - r0, w_out, -1)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return (x - 0.5) / 0.5


# -- inference --------------------------------------------------------------

@torch.no_grad()
def predict(p: Params, config: dict, lr: torch.Tensor,
            hr_hw: Tuple[int, int], rnd: Rounding, block: int = 1 << 19
            ) -> torch.Tensor:
    """Clamped [0, 1] prediction (B, H_out, W_out, 3) of NHWC ``lr`` in
    [0, 1] at output size ``hr_hw``, ``block`` queries at a time."""
    feat = encode(p, config, normalize(lr.permute(0, 3, 1, 2)), rnd)
    zs = lr_convs(p, config, feat, rnd)
    out = torch.empty((lr.shape[0], *hr_hw, 3), dtype=torch.float32,
                      device=lr.device)
    for r0, r1 in _row_blocks(lr.shape[0], *hr_hw, block):
        out[:, r0:r1] = decode_rows(p, config, zs, hr_hw, r0, r1, rnd)
    return torch.clamp(out * 0.5 + 0.5, 0.0, 1.0)


# -- training ---------------------------------------------------------------

def loss_and_grads(p: Params, config: dict,
                   batch: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   rnd: Rounding, block: int = 1 << 16,
                   image_block: int = 16,
                   preds: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[float, Params]:
    """The multi-scale L1 loss of ``batch`` (a (lr, hr) NHWC pair in [0, 1]
    per scale, every lr of one shape) and its gradient with respect to
    every parameter. The encoder runs once over the scales' stacked
    images; the decoder's loss is taken and differentiated in blocks of
    HR rows; the encoder's backward is recomputed in blocks of
    ``image_block`` images. Where ``preds`` is a list, each scale's
    prediction (B, H_out, W_out, 3), the decoder's output in [-1, 1]'s
    scale as the loss takes it, is appended to it."""
    names = list(p)
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    n_scales = len(batch)
    x = torch.cat([normalize(lr.permute(0, 3, 1, 2)) for lr, _ in batch])
    with torch.no_grad():
        feat = torch.cat([encode(leaves, config, x[i:i + image_block], rnd)
                          for i in range(0, x.shape[0], image_block)])
    feat = feat.requires_grad_(True)
    loss = 0.0
    at = 0
    for lr, hr in batch:
        b = lr.shape[0]
        zs = lr_convs(leaves, config, feat[at:at + b], rnd)
        zl = [z.detach().requires_grad_(True) for z in zs]
        target = normalize(hr)
        hr_hw = (hr.shape[1], hr.shape[2])
        denom = float(hr.numel() * n_scales)
        kept = (torch.empty(hr.shape, dtype=torch.float32, device=hr.device)
                if preds is not None else None)
        for r0, r1 in _row_blocks(b, *hr_hw, block):
            pred = decode_rows(leaves, config, zl, hr_hw, r0, r1, rnd)
            part = (pred - target[:, r0:r1]).abs().sum() / denom
            part.backward()
            loss += part.detach().item()
            if kept is not None:
                kept[:, r0:r1] = pred.detach()
        if kept is not None:
            preds.append(kept)
        torch.autograd.backward(zs, [z.grad for z in zl])
        at += b
    dfeat = feat.grad
    for i in range(0, x.shape[0], image_block):
        out = encode(leaves, config, x[i:i + image_block], rnd)
        out.backward(dfeat[i:i + image_block])
    grads = {k: (leaves[k].grad if leaves[k].grad is not None
                 else torch.zeros_like(leaves[k])) for k in names}
    return loss, grads


class Adam:
    """torch.optim.Adam's update with its defaults (betas 0.9 / 0.999, eps
    1e-8, no weight decay), written out."""

    def __init__(self, params: Params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1 = 1 - b1 ** self.t
        c2 = math.sqrt(1 - b2 ** self.t)
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2).add_(self.eps)
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)
