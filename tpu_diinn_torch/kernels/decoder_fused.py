"""Fused DIINN mode-3 decoder: CUDA kernels, their plain versions, and
the autograd node that trains through them.

Counterpart of ``tpu_diinn/kernels/decoder_fused.py``. Given the stacked LR
content features ``z`` (B, H_in, W_in, L*hidden) with the per-layer kq
biases folded in (``ImplicitDecoder.lr_features_stacked``) and the
synthesis grid, every HR query runs

    k = relu(z0);  q = k * sin(syn @ W0 + b0)
    k = relu(q @ Wkq_i + z_i);  q = k * sin(q @ Wq_i + bq_i)   i = 1..L-1
    out = q @ Wl + bl

with the polynomial sine, reading z at its nearest-exact LR pixel.

- ``decode_int_fwd`` (replaces ``decode_fused_int_eval`` and the training
  forward ``_fwd_pallas_int``, both ``_fwd_kernel_int``): integer ratios
  s_h, s_w <= 16; query (y, x) reads z[:, y // s_h, x // s_w].
- ``decode_window_fwd`` (replaces ``_fwd_pallas`` / ``_fwd_kernel``): any
  ratio or window; query (i, j) reads z[:, rows[i], cols[j]] for int32
  index vectors (``index_vector``; nearest-exact maps, sliced to the
  window).
- ``decode_int_bwd`` (replaces ``_bwd_pallas_int`` / ``_bwd_kernel_int``)
  and ``decode_window_bwd`` (replaces ``_bwd_pallas`` / ``_bwd_kernel``):
  their VJPs. Each recomputes the chain and returns dz and the gradients of
  the packed weights; the kq half of ``dbcat`` is zero, because the kq
  biases reach the decoder folded into z and take their gradient through
  it.

Each dispatcher takes its plain PyTorch version (``*_ref``) only for a
tensor on the CPU. For a CUDA tensor it launches the kernels of
``csrc/decoder_fused.cu`` / ``csrc/decoder_bwd.cu`` or raises. The kernels
are fp32 only. ``decode`` runs a forward dispatcher as one autograd node
whose backward is the matching backward dispatcher. Each kernel launch
adds one to ``launches[name]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import numpy as np
import torch

from tpu_diinn_torch.core.fastmath import _poly_sin, _poly_sincos

# Hidden widths the CUDA kernels are instantiated for: each lane of a warp
# owns hidden/32 columns, held in a register tile sized at compile time.
KERNEL_HIDDEN = (32, 64, 256)
MAX_INT_RATIO = 16
PARAM_KEYS = ("w0", "b0", "wcat", "bcat", "wl", "bl")

launches: Dict[str, int] = {"decode_int_fwd": 0, "decode_window_fwd": 0,
                            "decode_int_bwd": 0, "decode_window_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pack_params(decoder_state: Mapping[str, torch.Tensor],
                n_layers: int) -> dict:
    """The kernels' weight layout from an ImplicitDecoder's parameters
    (mode 3, no init_q): fp32, contiguous, (in, out) matrices, and each
    layer's [Wkq | Wq] / [bkq | bq] concatenated.

    w0 (3, H), b0 (H,), wcat (L-1, H, 2H), bcat (L-1, 2H), wl (H, 3),
    bl (3,). The kernels add only the q half of ``bcat``: the kq biases are
    folded into z. The packed tensors keep their autograd history, so that
    the gradients ``decode`` returns reach each layer's parameters.
    """
    p = decoder_state
    f32 = torch.float32

    def w(name):
        return p[f"{name}.dense.weight"].to(f32).t()

    def b(name):
        return p[f"{name}.dense.bias"].to(f32)

    w0, b0 = w("q0"), b("q0")
    h = w0.shape[1]
    dev = w0.device
    if n_layers > 1:
        wcat = torch.stack([torch.cat([w(f"kq{i}"), w(f"q{i}")], dim=1)
                            for i in range(1, n_layers)])
        bcat = torch.stack([torch.cat([b(f"kq{i}"), b(f"q{i}")])
                            for i in range(1, n_layers)])
    else:
        wcat = torch.zeros((0, h, 2 * h), dtype=f32, device=dev)
        bcat = torch.zeros((0, 2 * h), dtype=f32, device=dev)
    return {"w0": w0.contiguous(), "b0": b0.contiguous(),
            "wcat": wcat.contiguous(), "bcat": bcat.contiguous(),
            "wl": w("last_dense").contiguous(),
            "bl": b("last_dense").contiguous()}


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _chain_ref(zt: torch.Tensor, syn: torch.Tensor, params: dict
               ) -> torch.Tensor:
    """The dual-MLP chain over flat (M, L*H) features and (M, 3) syn."""
    h = params["w0"].shape[1]
    n_layers = params["wcat"].shape[0] + 1
    k = torch.relu(zt[:, :h])
    q = k * _poly_sin(torch.matmul(syn, params["w0"]) + params["b0"])
    for i in range(1, n_layers):
        both = torch.matmul(q, params["wcat"][i - 1])
        k = torch.relu(both[:, :h] + zt[:, i * h:(i + 1) * h])
        q = k * _poly_sin(both[:, h:] + params["bcat"][i - 1, h:])
    return torch.matmul(q, params["wl"]) + params["bl"]


def _chain_bwd_ref(zt: torch.Tensor, syn: torch.Tensor, g: torch.Tensor,
                   params: dict) -> tuple:
    """VJP of ``_chain_ref`` for the upstream gradient ``g`` (M, 3), written
    out as the Pallas ``_chain_bwd`` computes it: recompute the chain,
    backprop layer by layer. Returns (dzt (M, L*H), weight gradients); the
    kq half of dbcat is zero (the kq biases are folded into z)."""
    h = params["w0"].shape[1]
    n_layers = params["wcat"].shape[0] + 1
    wcat = params["wcat"]
    ks, qs, sins, coss = [], [], [], []
    z0 = zt[:, :h]
    k = torch.relu(z0)
    s, c = _poly_sincos(torch.matmul(syn, params["w0"]) + params["b0"])
    q = k * s
    ks.append(k); qs.append(q); sins.append(s); coss.append(c)
    for i in range(1, n_layers):
        both = torch.matmul(q, wcat[i - 1])
        k = torch.relu(both[:, :h] + zt[:, i * h:(i + 1) * h])
        s, c = _poly_sincos(both[:, h:] + params["bcat"][i - 1, h:])
        q = k * s
        ks.append(k); qs.append(q); sins.append(s); coss.append(c)

    grads = {"wl": torch.matmul(qs[-1].t(), g), "bl": g.sum(0),
             "wcat": torch.zeros_like(wcat),
             "bcat": torch.zeros_like(params["bcat"])}
    dq = torch.matmul(g, params["wl"].t())
    dzt = [None] * n_layers
    for i in range(n_layers - 1, 0, -1):
        dkq = (dq * sins[i]) * (ks[i] > 0)
        dqp = (dq * ks[i]) * coss[i]
        dzt[i] = dkq
        dboth = torch.cat([dkq, dqp], dim=1)
        grads["bcat"][i - 1, h:] = dqp.sum(0)
        grads["wcat"][i - 1] = torch.matmul(qs[i - 1].t(), dboth)
        dq = torch.matmul(dboth, wcat[i - 1].t())
    dpre0 = (dq * ks[0]) * coss[0]
    grads["w0"] = torch.matmul(syn.t(), dpre0)
    grads["b0"] = dpre0.sum(0)
    dzt[0] = (dq * sins[0]) * (z0 > 0)
    return torch.cat(dzt, dim=1), grads


def _long(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).long()


def _gather_ref(z, syn, rows, cols, params):
    b = z.shape[0]
    zt = z[:, _long(rows, z.device)][:, :, _long(cols, z.device)]
    hq, wq = zt.shape[1], zt.shape[2]
    synb = syn.to(torch.float32).expand(b, hq, wq, 3)
    out = _chain_ref(zt.reshape(-1, zt.shape[-1]).to(torch.float32),
                     synb.reshape(-1, 3), params)
    return out.reshape(b, hq, wq, 3)


def _gather_bwd_ref(z, syn, rows, cols, params, g):
    """Backward of ``_gather_ref``: the chain's VJP per query, then
    ``index_add_`` as the adjoint of the row/column gather."""
    b, h_in, w_in, c_all = z.shape
    r, c = _long(rows, z.device), _long(cols, z.device)
    zt = z[:, r][:, :, c]
    hq, wq = zt.shape[1], zt.shape[2]
    synb = syn.to(torch.float32).expand(b, hq, wq, 3)
    dzt, grads = _chain_bwd_ref(zt.reshape(-1, c_all), synb.reshape(-1, 3),
                                g.reshape(-1, 3), params)
    bi = torch.arange(b, device=z.device)
    pix = ((bi[:, None, None] * h_in + r[None, :, None]) * w_in
           + c[None, None, :]).reshape(-1)
    dz = torch.zeros((b * h_in * w_in, c_all), dtype=dzt.dtype,
                     device=z.device).index_add_(0, pix, dzt)
    return dz.reshape(z.shape), grads


def _int_indices(h_in, w_in, s_h, s_w):
    return np.arange(h_in * s_h) // s_h, np.arange(w_in * s_w) // s_w


def decode_int_fwd_ref(z: torch.Tensor, syn: torch.Tensor, s_h: int,
                       s_w: int, params: dict) -> torch.Tensor:
    """Plain version of ``decode_int_fwd``."""
    rows, cols = _int_indices(z.shape[1], z.shape[2], s_h, s_w)
    return _gather_ref(z, syn, rows, cols, params)


def decode_window_fwd_ref(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                          params: dict) -> torch.Tensor:
    """Plain version of ``decode_window_fwd``."""
    return _gather_ref(z, syn, rows, cols, params)


def decode_int_bwd_ref(z: torch.Tensor, syn: torch.Tensor, s_h: int,
                       s_w: int, params: dict, g: torch.Tensor) -> tuple:
    """Plain version of ``decode_int_bwd``."""
    rows, cols = _int_indices(z.shape[1], z.shape[2], s_h, s_w)
    return _gather_bwd_ref(z, syn, rows, cols, params, g)


def decode_window_bwd_ref(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                          params: dict, g: torch.Tensor) -> tuple:
    """Plain version of ``decode_window_bwd``."""
    return _gather_bwd_ref(z, syn, rows, cols, params, g)


# ---------------------------------------------------------------------------
# The autograd node.
# ---------------------------------------------------------------------------

class _Decode(torch.autograd.Function):
    """One fused decode: the forward dispatcher, and as its backward the
    matching backward dispatcher. Saves z, syn and the packed weights; the
    backward recomputes the chain, so no HR activation is kept."""

    @staticmethod
    def forward(ctx, route, syn, z, *weights):
        ctx.route = route
        ctx.save_for_backward(syn, z, *weights)
        p = dict(zip(PARAM_KEYS, weights))
        if route[0] == "int":
            return decode_int_fwd(z, syn, route[1], route[2], p)
        return decode_window_fwd(z, syn, route[1], route[2], p)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        syn, z, *weights = ctx.saved_tensors
        p = dict(zip(PARAM_KEYS, weights))
        route = ctx.route
        g = g.to(torch.float32).contiguous()
        if route[0] == "int":
            dz, grads = decode_int_bwd(z, syn, route[1], route[2], p, g)
        else:
            dz, grads = decode_window_bwd(z, syn, route[1], route[2], p, g)
        return (None, None, dz, *(grads[k] for k in PARAM_KEYS))


def decode(z: torch.Tensor, syn: torch.Tensor, params: dict, *,
           ratio=None, rows=None, cols=None) -> torch.Tensor:
    """Fused decode as one autograd node: integer ratio ``ratio=(s_h,
    s_w)``, or the window read through ``rows``/``cols`` (``index_vector``
    tensors on z's device). The backward returns dz and the packed
    weights' gradients from the backward kernels (their plain versions for
    a CPU tensor)."""
    route = ("int", *ratio) if ratio is not None else ("window", rows, cols)
    return _Decode.apply(route, syn, z, *(params[k] for k in PARAM_KEYS))


# ---------------------------------------------------------------------------
# CUDA launches.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_libs: Dict[str, ctypes.CDLL] = {}


def _library(name: str = "decoder_fused") -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        from tpu_diinn_torch.kernels import build
        lib = build.load(name)
        if name == "decoder_fused":
            lib.launch_decode_int_fwd.argtypes = [_P] * 9 + [_I] * 7 + [_P]
            lib.launch_decode_window_fwd.argtypes = ([_P] * 11 + [_I] * 7
                                                     + [_P])
            fns = (lib.launch_decode_int_fwd, lib.launch_decode_window_fwd)
        else:
            lib.launch_decode_int_bwd.argtypes = [_P] * 12 + [_I] * 7 + [_P]
            lib.launch_decode_window_bwd.argtypes = ([_P] * 14 + [_I] * 7
                                                     + [_P])
            lib.decoder_bwd_scratch_floats.argtypes = [_L, _I, _I]
            lib.decoder_bwd_scratch_floats.restype = _L
            fns = (lib.launch_decode_int_bwd, lib.launch_decode_window_bwd)
        for fn in fns:
            fn.restype = _I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def index_vector(idx, n_lr: int, device) -> torch.Tensor:
    """LR indices of a run of HR rows or columns (``grids.
    nearest_exact_indices``, or a slice of it) as an int32 tensor on
    ``device``, checked once on the host: 1-D, in [0, n_lr), and
    non-decreasing, as nearest-exact maps are (the backward kernels find
    the queries of an LR pixel by binary search). A window's vectors are
    slices (views) of the full ones, so a forward uploads each once."""
    a = np.asarray(idx)
    _require(a.ndim == 1, "index vectors must be 1-D")
    _require(a.size == 0 or (a.min() >= 0 and a.max() < n_lr),
             f"indices out of [0, {n_lr})")
    _require(bool(np.all(np.diff(a) >= 0)), "indices must be non-decreasing")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def _check_index(idx, z: torch.Tensor, what: str) -> None:
    _require(isinstance(idx, torch.Tensor) and idx.dtype == torch.int32
             and idx.dim() == 1 and idx.device == z.device
             and idx.is_contiguous(),
             f"{what} must be a 1-D contiguous int32 tensor on {z.device} "
             f"(index_vector)")


def _check_common(z: torch.Tensor, syn: torch.Tensor, params: dict,
                  hw: tuple) -> tuple:
    _require(z.is_cuda, f"z must be a CUDA tensor, got {z.device}")
    _require(z.dim() == 4, f"z must be (B, H_in, W_in, C_all), got "
             f"{tuple(z.shape)}")
    h = params["w0"].shape[-1]
    n_layers = params["wcat"].shape[0] + 1
    _require(h in KERNEL_HIDDEN, f"hidden {h} not in {KERNEL_HIDDEN}")
    _require(z.shape[-1] == n_layers * h,
             f"z has {z.shape[-1]} channels, expected {n_layers}*{h}")
    _require(tuple(syn.shape) == (*hw, 3),
             f"syn must be {(*hw, 3)}, got {tuple(syn.shape)}")
    shapes = {"w0": (3, h), "b0": (h,), "wcat": (n_layers - 1, h, 2 * h),
              "bcat": (n_layers - 1, 2 * h), "wl": (h, 3), "bl": (3,)}
    for name, t in [("z", z), ("syn", syn)] + [(k, params[k])
                                              for k in shapes]:
        _check_tensor(name, t, z)
        if name in shapes:
            _require(tuple(t.shape) == shapes[name],
                     f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    return h, n_layers


def _check_tensor(name: str, t: torch.Tensor, z: torch.Tensor) -> None:
    _require(t.dtype == torch.float32,
             f"{name} must be float32 (the kernels are fp32 only), got "
             f"{t.dtype}")
    _require(t.device == z.device, f"{name} on {t.device}, z on {z.device}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _weights(params: dict) -> list:
    return [params[k].data_ptr() for k in PARAM_KEYS]


def _raise_on(rc: int, name: str, lib: str = "decoder_fused") -> None:
    if rc != 0:
        msg = getattr(_library(lib), f"{lib}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decode_int_fwd(z: torch.Tensor, syn: torch.Tensor, s_h: int, s_w: int,
                   params: dict) -> torch.Tensor:
    """Integer-ratio decode of the full HR grid (s_h*H_in, s_w*W_in).

    z (B, H_in, W_in, L*H), syn (s_h*H_in, s_w*W_in, 3) -> (B, H_out,
    W_out, 3) float32.
    """
    if z.device.type == "cpu":
        return decode_int_fwd_ref(z, syn, s_h, s_w, params)
    b, h_in, w_in, _ = z.shape
    _check_ratio(s_h, s_w)
    h_out, w_out = s_h * h_in, s_w * w_in
    h, n_layers = _check_common(z, syn, params, (h_out, w_out))
    out = torch.empty((b, h_out, w_out, 3), dtype=torch.float32,
                      device=z.device)
    with torch.cuda.device(z.device):
        rc = _library().launch_decode_int_fwd(
            z.data_ptr(), syn.data_ptr(), *_weights(params), out.data_ptr(),
            b, h_in, w_in, s_h, s_w, h, n_layers, _stream(z.device))
    _raise_on(rc, "decode_int_fwd")
    launches["decode_int_fwd"] += 1
    return out


def _check_ratio(s_h: int, s_w: int) -> None:
    _require(1 <= s_h <= MAX_INT_RATIO and 1 <= s_w <= MAX_INT_RATIO,
             f"integer ratios must be in 1..{MAX_INT_RATIO}, got "
             f"{(s_h, s_w)}")


def decode_window_fwd(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                      params: dict) -> torch.Tensor:
    """Decode the HR window whose queries read LR rows ``rows`` and LR
    columns ``cols`` (``index_vector`` tensors on z's device).

    z (B, H_in, W_in, L*H), syn (len(rows), len(cols), 3) -> (B,
    len(rows), len(cols), 3) float32.
    """
    _check_index(rows, z, "rows")
    _check_index(cols, z, "cols")
    if z.device.type == "cpu":
        return decode_window_fwd_ref(z, syn, rows, cols, params)
    b, h_in, w_in, _ = z.shape
    h_win, w_win = rows.numel(), cols.numel()
    h, n_layers = _check_common(z, syn, params, (h_win, w_win))
    out = torch.empty((b, h_win, w_win, 3), dtype=torch.float32,
                      device=z.device)
    with torch.cuda.device(z.device):
        rc = _library().launch_decode_window_fwd(
            z.data_ptr(), syn.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), *_weights(params), out.data_ptr(), b, h_in,
            w_in, h_win, w_win, h, n_layers, _stream(z.device))
    _raise_on(rc, "decode_window_fwd")
    launches["decode_window_fwd"] += 1
    return out


def _bwd_buffers(z: torch.Tensor, n_query: int, h: int, n_layers: int,
                 params: dict) -> tuple:
    """dz, the flat weight-gradient vector with its per-key views (the
    layout of ``decoder_bwd::Plan``), the transposed [Wkq | Wq] and the
    scratch buffer of one backward call."""
    dev = z.device
    sizes = {"w0": (3, h), "b0": (h,), "wcat": (n_layers - 1, h, 2 * h),
             "bcat": (n_layers - 1, 2 * h), "wl": (h, 3), "bl": (3,)}
    n_grad = sum(int(np.prod(s)) for s in sizes.values())
    flat = torch.empty(n_grad, dtype=torch.float32, device=dev)
    grads, at = {}, 0
    for k, shape in sizes.items():
        n = int(np.prod(shape))
        grads[k] = flat[at:at + n].view(shape)
        at += n
    n_scratch = _library("decoder_bwd").decoder_bwd_scratch_floats(
        n_query, h, n_layers)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    wcat_t = params["wcat"].transpose(1, 2).contiguous()
    return torch.empty_like(z), flat, grads, wcat_t, scratch


def decode_int_bwd(z: torch.Tensor, syn: torch.Tensor, s_h: int, s_w: int,
                   params: dict, g: torch.Tensor) -> tuple:
    """VJP of ``decode_int_fwd`` for the upstream gradient ``g`` (B, H_out,
    W_out, 3): (dz like z, {w0, b0, wcat, bcat, wl, bl} gradients)."""
    if z.device.type == "cpu":
        return decode_int_bwd_ref(z, syn, s_h, s_w, params, g)
    b, h_in, w_in, _ = z.shape
    _check_ratio(s_h, s_w)
    h_out, w_out = s_h * h_in, s_w * w_in
    h, n_layers = _check_common(z, syn, params, (h_out, w_out))
    _check_grad(g, z, (b, h_out, w_out, 3))
    dz, flat, grads, wcat_t, scratch = _bwd_buffers(
        z, b * h_out * w_out, h, n_layers, params)
    with torch.cuda.device(z.device):
        rc = _library("decoder_bwd").launch_decode_int_bwd(
            z.data_ptr(), syn.data_ptr(), *_weights(params)[:5],
            wcat_t.data_ptr(), g.data_ptr(), dz.data_ptr(), flat.data_ptr(),
            scratch.data_ptr(), b, h_in, w_in, s_h, s_w, h, n_layers,
            _stream(z.device))
    _raise_on(rc, "decode_int_bwd", "decoder_bwd")
    launches["decode_int_bwd"] += 1
    return dz, grads


def decode_window_bwd(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                      params: dict, g: torch.Tensor) -> tuple:
    """VJP of ``decode_window_fwd`` for ``g`` (B, len(rows), len(cols),
    3): (dz like z, weight gradients). LR pixels that no query of the
    window reads get zero."""
    _check_index(rows, z, "rows")
    _check_index(cols, z, "cols")
    if z.device.type == "cpu":
        return decode_window_bwd_ref(z, syn, rows, cols, params, g)
    b, h_in, w_in, _ = z.shape
    h_win, w_win = rows.numel(), cols.numel()
    h, n_layers = _check_common(z, syn, params, (h_win, w_win))
    _check_grad(g, z, (b, h_win, w_win, 3))
    dz, flat, grads, wcat_t, scratch = _bwd_buffers(
        z, b * h_win * w_win, h, n_layers, params)
    with torch.cuda.device(z.device):
        rc = _library("decoder_bwd").launch_decode_window_bwd(
            z.data_ptr(), syn.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), *_weights(params)[:5], wcat_t.data_ptr(),
            g.data_ptr(), dz.data_ptr(), flat.data_ptr(), scratch.data_ptr(),
            b, h_in, w_in, h_win, w_win, h, n_layers, _stream(z.device))
    _raise_on(rc, "decode_window_bwd", "decoder_bwd")
    launches["decode_window_bwd"] += 1
    return dz, grads


def _check_grad(g: torch.Tensor, z: torch.Tensor, shape: tuple) -> None:
    _check_tensor("g", g, z)
    _require(tuple(g.shape) == shape,
             f"g must be {shape}, got {tuple(g.shape)}")
