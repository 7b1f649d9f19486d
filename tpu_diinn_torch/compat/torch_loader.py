"""Reference PyTorch ``state_dict`` arrays -> flat flax parameter paths.

The port's own copy of ``tpu_diinn/compat/torch_loader.py`` (numpy only):
it loads checkpoints trained with the reference implementation and holds
the port to the reference's golden fixtures. Input is a flat mapping
``name -> numpy array`` with the reference's module names; each
``convert_*`` returns the flax ``{'params': ...}`` tree of the model, and
``flatten`` turns it into the flat ``params/a/b/kernel`` paths that
``train/checkpoint.state_dict_from_jax`` carries into the port's modules.

Layout conventions:
- torch conv OIHW -> flax HWIO (transpose 2,3,1,0).
- torch 1x1 "per-pixel" convs (the decoder layers) -> Dense kernels (in, out).
- reference 1x1 convs over ``F.unfold(x, 3)`` channels (ordered c*9+kh*3+kw)
  -> 3x3 convs: W1[o, c*9 + kh*3 + kw] == W3[kh, kw, c, o].
- reference concat layers ``K_i(cat[q|k, unfold(x)])`` (832 -> h) split into a
  Dense over the first ``h`` channels (kq, keeps the bias) and a bias-free
  3x3 conv over the unfolded part (kx); with ``init_q`` the unfolded part
  stays a bias-free Dense.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

Tree = Dict


def _conv(sd: Mapping[str, np.ndarray], name: str) -> Tree:
    out = {"kernel": np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0))}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return {"conv": out}


def _dense(sd: Mapping[str, np.ndarray], name: str) -> Tree:
    w = sd[f"{name}.weight"]
    if w.ndim == 4:  # 1x1 conv used as a per-pixel linear layer
        w = w[:, :, 0, 0]
    out = {"kernel": np.ascontiguousarray(w.T)}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return {"dense": out}


def _unfold_conv_kernel(w1: np.ndarray, c: int) -> np.ndarray:
    """(out, c*9[,1,1]) 1x1-over-unfold weight -> (3, 3, c, out) conv kernel."""
    if w1.ndim == 4:
        w1 = w1[:, :, 0, 0]
    o = w1.shape[0]
    w = w1.reshape(o, c, 3, 3)          # (o, c, kh, kw)
    return np.transpose(w, (2, 3, 1, 0))  # (kh, kw, c, o)


def convert_rdn(sd: Mapping[str, np.ndarray], prefix: str = "",
                n_blocks: int = 16, n_convs: int = 8) -> Tree:
    """Reference RDN -> nn/rdn.py param tree."""
    p = prefix
    tree: Tree = {
        "sfe1": _conv(sd, f"{p}SFENet1"),
        "sfe2": _conv(sd, f"{p}SFENet2"),
        "gff1": _conv(sd, f"{p}GFF.0"),
        "gff2": _conv(sd, f"{p}GFF.1"),
    }
    for i in range(n_blocks):
        blk: Tree = {}
        for c in range(n_convs):
            blk[f"conv{c}"] = _conv(sd, f"{p}RDBs.{i}.convs.{c}.conv.0")
        blk["lff"] = _conv(sd, f"{p}RDBs.{i}.LFF")
        tree[f"rdb{i}"] = blk
    return tree


def convert_diinn_decoder(sd: Mapping[str, np.ndarray], prefix: str = "",
                          in_channels: int = 64, n_layers: int = 4,
                          hidden: int = 256, mode: int = 3,
                          init_q: bool = False) -> Tree:
    """Reference ImplicitDecoder -> nn/diinn.py tree."""
    p = prefix
    c = in_channels
    tree: Tree = {}
    if init_q:
        tree["first"] = _dense(sd, f"{p}first_layer.0")
        tree["k0_dense"] = _dense(sd, f"{p}K.0.0")
    else:
        w = sd[f"{p}K.0.0.weight"]
        tree["k0_conv"] = {"conv": {
            "kernel": _unfold_conv_kernel(w, c),
            "bias": sd[f"{p}K.0.0.bias"]}}
    for i in range(1, n_layers):
        w = sd[f"{p}K.{i}.0.weight"]
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        b = sd[f"{p}K.{i}.0.bias"]
        if mode == 1:
            tree[f"kq{i}"] = {"dense": {"kernel": np.ascontiguousarray(w.T),
                                        "bias": b}}
        else:
            tree[f"kq{i}"] = {"dense": {
                "kernel": np.ascontiguousarray(w[:, :hidden].T), "bias": b}}
            if init_q:
                tree[f"kx{i}"] = {"dense": {
                    "kernel": np.ascontiguousarray(w[:, hidden:].T)}}
            else:
                tree[f"kx{i}"] = {"conv": {
                    "kernel": _unfold_conv_kernel(w[:, hidden:], c)}}
    for i in range(n_layers):
        tree[f"q{i}"] = _dense(sd, f"{p}Q.{i}.0")
    if mode == 4:
        tree["last_conv"] = _conv(sd, f"{p}last_layer")
    else:
        tree["last_dense"] = _dense(sd, f"{p}last_layer")
    return tree


def convert_diinn(sd: Mapping[str, np.ndarray], *, mode: int = 3,
                  init_q: bool = False, in_channels: int = 64,
                  n_layers: int = 4, hidden: int = 256,
                  n_blocks: int = 16, n_convs: int = 8) -> Tree:
    return {"params": {
        "encoder": convert_rdn(sd, "encoder.", n_blocks, n_convs),
        "decoder": convert_diinn_decoder(
            sd, "decoder.", in_channels, n_layers, hidden, mode, init_q),
    }}


def convert_liif(sd: Mapping[str, np.ndarray], *, in_channels: int = 64,
                 hidden=(256, 256, 256, 256), n_blocks: int = 16,
                 n_convs: int = 8) -> Tree:
    """Reference LIIF (feature unfolding and cell decoding on, the port's
    only LIIF) -> nn/liif.py tree.

    imnet fc0 input order is [q_feat(C*9), rel(2), cell(2)]; the q_feat
    part becomes the LR 3x3 conv, rel keeps the bias, cell is bias-free.
    """
    c = in_channels
    cf = c * 9
    w0 = sd["imnet.layers.0.weight"]
    tree: Tree = {"encoder": convert_rdn(sd, "encoder.", n_blocks, n_convs)}
    tree["imnet_feat"] = {"conv": {"kernel": _unfold_conv_kernel(
        w0[:, :cf], c)}}
    tree["imnet_rel"] = {"dense": {
        "kernel": np.ascontiguousarray(w0[:, cf:cf + 2].T),
        "bias": sd["imnet.layers.0.bias"]}}
    tree["imnet_cell"] = {"dense": {
        "kernel": np.ascontiguousarray(w0[:, cf + 2:cf + 4].T)}}
    # torch Sequential(layers): Linear at even indices 0,2,4,...
    for i in range(1, len(hidden) + 1):
        tree[f"imnet_fc{i}"] = _dense(sd, f"imnet.layers.{2 * i}")
    return {"params": tree}


def convert_metasr(sd: Mapping[str, np.ndarray], *, n_blocks: int = 16,
                   n_convs: int = 8) -> Tree:
    """Reference MetaSR -> nn/metasr.py tree."""
    return {"params": {
        "encoder": convert_rdn(sd, "encoder.", n_blocks, n_convs),
        "hyper_fc0": _dense(sd, "imnet.layers.0"),
        "hyper_fc1": _dense(sd, "imnet.layers.2"),
    }}


def convert_edsr_baseline(sd: Mapping[str, np.ndarray],
                          n_resblocks: int = 16, prefix: str = "") -> Tree:
    """Reference EDSR head and body (no tail) -> EDSRBaseline tree."""
    p = prefix
    tree: Tree = {"head": _conv(sd, f"{p}head.0")}
    for i in range(n_resblocks):
        tree[f"res{i}"] = {
            "conv0": _conv(sd, f"{p}body.{i}.body.0"),
            "conv1": _conv(sd, f"{p}body.{i}.body.2"),
        }
    tree["body_tail"] = _conv(sd, f"{p}body.{n_resblocks}")
    return {"params": tree}


def flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested param tree -> flat ``a/b/c`` paths (``params/...`` for a
    ``convert_*`` result), float32 numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.ascontiguousarray(v, dtype=np.float32)
    return out
