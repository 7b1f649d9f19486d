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

Two precisions, chosen by z's dtype (the compute dtype; the weights come
in it too, the biases, syn, the output and the upstream gradient are
float32):

- float32: every product runs on the tensor cores (``wgmma`` TF32) in
  3xTF32, which keeps fp32-level error;
- bfloat16, the JAX package's bf16 mode (``cdt = w0.dtype`` in its
  kernels): every product takes bf16 operands and sums in fp32 (``wgmma``
  BF16): syn and q are rounded to bf16 before each product (the head's
  too), the backward's d, dpre_0 and g before theirs; z is widened for the
  adds, and relu, the sine, k * sin and the bias gradients stay fp32. The
  forward's output and the weight gradients are fp32; dz sums in fp32 and
  is rounded to bf16 once.

The wrapper lays [Wkq | Wq] out in wgmma's B layout once per call
(``forward_slabs``, and ``mma_b_slabs`` of its transpose for the
backward); ``decode`` does it once per training step and hands the
forward's slabs on to the backward.

Each dispatcher takes its plain PyTorch version (``*_ref``) only for a
tensor on the CPU. For a CUDA tensor it launches the kernels of
``csrc/decoder_fused.cu`` / ``csrc/decoder_bwd.cu`` in z's precision or
raises. ``decode`` runs a forward dispatcher as one autograd node whose
backward is the matching backward dispatcher. Each kernel launch adds one
to ``launches[name]`` (``name + "_bf16"`` for a bf16 instance).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import numpy as np
import torch

from tpu_diinn_torch.core.fastmath import _poly_sin, _poly_sincos
from tpu_diinn_torch.train.profiling import span

# Hidden widths the CUDA kernels are instantiated for (one template
# instance each, sized at compile time: each of a CTA's two warpgroups owns
# hidden/2 columns, as wgmma products of N = hidden or less).
KERNEL_HIDDEN = (32, 64, 256)
MAX_INT_RATIO = 16
PARAM_KEYS = ("w0", "b0", "wcat", "bcat", "wl", "bl")
WEIGHT_KEYS = ("w0", "wcat", "wl")     # in the compute dtype; biases fp32
DTYPES = (torch.float32, torch.bfloat16)
KERNELS = ("decode_int_fwd", "decode_window_fwd", "decode_int_bwd",
           "decode_window_bwd")

launches: Dict[str, int] = {f"{k}{sfx}": 0 for sfx in ("", "_bf16")
                            for k in KERNELS}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def launch_key(name: str, dtype: torch.dtype) -> str:
    """``launches``' key of kernel ``name``'s instance for ``dtype``."""
    return name + ("_bf16" if dtype == torch.bfloat16 else "")


def pack_params(decoder_state: Mapping[str, torch.Tensor], n_layers: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """The kernels' weight layout from an ImplicitDecoder's parameters
    (mode 3, no init_q): contiguous (in, out) matrices, and each layer's
    [Wkq | Wq] / [bkq | bq] concatenated; the weights in ``dtype`` (the
    compute dtype), the biases float32.

    w0 (3, H), b0 (H,), wcat (L-1, H, 2H), bcat (L-1, 2H), wl (H, 3),
    bl (3,). The kernels add only the q half of ``bcat``: the kq biases are
    folded into z. The packed tensors keep their autograd history, so that
    the gradients ``decode`` returns reach each layer's parameters.
    """
    p = decoder_state
    f32 = torch.float32

    def w(name):
        return p[f"{name}.dense.weight"].to(f32).t().to(dtype)

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
        wcat = torch.zeros((0, h, 2 * h), dtype=dtype, device=dev)
        bcat = torch.zeros((0, 2 * h), dtype=f32, device=dev)
    return {"w0": w0.contiguous(), "b0": b0.contiguous(),
            "wcat": wcat.contiguous(), "bcat": bcat.contiguous(),
            "wl": w("last_dense").contiguous(),
            "bl": b("last_dense").contiguous()}


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype
        ) -> torch.Tensor:
    """a @ b with both operands rounded to ``cdt`` and fp32 sums (JAX's
    ``dot_general(a.astype(cdt), b, preferred_element_type=f32)``): a
    product of two bf16 values is exact in fp32."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float())


def _chain_ref(zt: torch.Tensor, syn: torch.Tensor, params: dict
               ) -> torch.Tensor:
    """The dual-MLP chain over flat (M, L*H) features and (M, 3) syn, in
    the compute dtype of the weights (the Pallas ``_chain_fwd``): q is
    rounded to it before each product, the rest is fp32."""
    h = params["w0"].shape[1]
    n_layers = params["wcat"].shape[0] + 1
    cdt = params["w0"].dtype
    zt = zt.float()
    k = torch.relu(zt[:, :h])
    q = k * _poly_sin(_mm(syn, params["w0"], cdt) + params["b0"])
    for i in range(1, n_layers):
        both = _mm(q, params["wcat"][i - 1], cdt)
        k = torch.relu(both[:, :h] + zt[:, i * h:(i + 1) * h])
        q = k * _poly_sin(both[:, h:] + params["bcat"][i - 1, h:])
    return _mm(q, params["wl"], cdt) + params["bl"]


def _chain_bwd_ref(zt: torch.Tensor, syn: torch.Tensor, g: torch.Tensor,
                   params: dict) -> tuple:
    """VJP of ``_chain_ref`` for the upstream gradient ``g`` (M, 3), written
    out as the Pallas ``_chain_bwd`` computes it: recompute the chain,
    backprop layer by layer, every product's operands rounded to the
    compute dtype (``mm``, ``mm_back``, ``mmT_acc`` there). Returns (dzt
    (M, L*H) fp32, fp32 weight gradients); the kq half of dbcat is zero
    (the kq biases are folded into z)."""
    h = params["w0"].shape[1]
    n_layers = params["wcat"].shape[0] + 1
    wcat = params["wcat"]
    cdt = params["w0"].dtype
    zt = zt.float()
    ks, qs, sins, coss = [], [], [], []
    z0 = zt[:, :h]
    k = torch.relu(z0)
    s, c = _poly_sincos(_mm(syn, params["w0"], cdt) + params["b0"])
    q = (k * s).to(cdt)
    ks.append(k); qs.append(q); sins.append(s); coss.append(c)
    for i in range(1, n_layers):
        both = _mm(q, wcat[i - 1], cdt)
        k = torch.relu(both[:, :h] + zt[:, i * h:(i + 1) * h])
        s, c = _poly_sincos(both[:, h:] + params["bcat"][i - 1, h:])
        q = (k * s).to(cdt)
        ks.append(k); qs.append(q); sins.append(s); coss.append(c)

    grads = {"wl": _mm(qs[-1].t(), g, cdt), "bl": g.sum(0),
             "wcat": torch.zeros(wcat.shape, dtype=torch.float32,
                                 device=wcat.device),
             "bcat": torch.zeros_like(params["bcat"])}
    dq = _mm(g, params["wl"].t(), cdt)
    dzt = [None] * n_layers
    for i in range(n_layers - 1, 0, -1):
        dkq = (dq * sins[i]) * (ks[i] > 0)
        dqp = (dq * ks[i]) * coss[i]
        dzt[i] = dkq
        dboth = torch.cat([dkq, dqp], dim=1)
        grads["bcat"][i - 1, h:] = dqp.sum(0)
        grads["wcat"][i - 1] = _mm(qs[i - 1].t(), dboth, cdt)
        dq = _mm(dboth, wcat[i - 1].t(), cdt)
    dpre0 = (dq * ks[0]) * coss[0]
    grads["w0"] = _mm(syn.t(), dpre0, cdt)
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
    out = _chain_ref(zt.reshape(-1, zt.shape[-1]), synb.reshape(-1, 3),
                     params)
    return out.reshape(b, hq, wq, 3)


def _gather_bwd_ref(z, syn, rows, cols, params, g):
    """Backward of ``_gather_ref``: the chain's VJP per query, then
    ``index_add_`` in fp32 as the adjoint of the row/column gather; dz is
    cast to z's dtype once, at the end."""
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
    return dz.reshape(z.shape).to(z.dtype), grads


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
    matching backward dispatcher. The weights arrive as their float32
    parameters and are cast to z's dtype here, out of autograd's sight, so
    that their gradients go back in float32, unrounded (as the Pallas VJP
    returns them). Saves z, syn, the cast weights and (on a card) the
    forward's weight slabs, which the backward reads again; the backward
    recomputes the chain, so no HR activation is kept."""

    @staticmethod
    def forward(ctx, route, syn, z, *weights):
        ctx.route = route
        with span("decoder.prepare"):
            weights = tuple(w.to(z.dtype) if k in WEIGHT_KEYS else w
                            for k, w in zip(PARAM_KEYS, weights))
            ctx.save_for_backward(syn, z, *weights)
            p = dict(zip(PARAM_KEYS, weights))
            ctx.slabs = None if z.device.type == "cpu" else forward_slabs(
                p["wcat"])
        if route[0] == "int":
            return decode_int_fwd(z, syn, route[1], route[2], p, ctx.slabs)
        return decode_window_fwd(z, syn, route[1], route[2], p, ctx.slabs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with span("decoder.backward"):
            syn, z, *weights = ctx.saved_tensors
            p = dict(zip(PARAM_KEYS, weights))
            route = ctx.route
            g = g.to(torch.float32).contiguous()
            if route[0] == "int":
                dz, grads = decode_int_bwd(z, syn, route[1], route[2], p, g,
                                           ctx.slabs)
            else:
                dz, grads = decode_window_bwd(z, syn, route[1], route[2], p,
                                              g, ctx.slabs)
            return (None, None, dz, *(grads[k] for k in PARAM_KEYS))


def decode(z: torch.Tensor, syn: torch.Tensor, params: dict, *,
           ratio=None, rows=None, cols=None) -> torch.Tensor:
    """Fused decode as one autograd node: integer ratio ``ratio=(s_h,
    s_w)``, or the window read through ``rows``/``cols`` (``index_vector``
    tensors on z's device), in z's dtype (``params`` as ``pack_params``
    gives them in float32). The backward returns dz (z's dtype) and the
    packed weights' float32 gradients from the backward kernels (their
    plain versions for a CPU tensor)."""
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
            lib.launch_decode_int_fwd.argtypes = [_P] * 9 + [_I] * 8 + [_P]
            lib.launch_decode_window_fwd.argtypes = ([_P] * 11 + [_I] * 8
                                                     + [_P])
            fns = (lib.launch_decode_int_fwd, lib.launch_decode_window_fwd)
        else:
            lib.launch_decode_int_bwd.argtypes = [_P] * 12 + [_I] * 8 + [_P]
            lib.launch_decode_window_bwd.argtypes = ([_P] * 14 + [_I] * 8
                                                     + [_P])
            lib.decoder_bwd_scratch_bytes.argtypes = [_L, _L] + [_I] * 5
            lib.decoder_bwd_scratch_bytes.restype = _L
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
    _require(z.dtype in DTYPES, f"z must be one of {DTYPES}, got {z.dtype}")
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
        _check_tensor(name, t, z, z.dtype if name in WEIGHT_KEYS + ("z",)
                      else torch.float32)
        if name in shapes:
            _require(tuple(t.shape) == shapes[name],
                     f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    return h, n_layers


def _check_tensor(name: str, t: torch.Tensor, z: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> None:
    _require(t.dtype == dtype,
             f"{name} must be {dtype} (z is {z.dtype}), got {t.dtype}")
    _require(t.device == z.device, f"{name} on {t.device}, z on {z.device}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _fwd_weights(params: dict, slabs) -> list:
    """The forward launchers' weight pointers: ``wcat`` as its wgmma B
    slabs (made here unless given)."""
    if slabs is None:
        slabs = forward_slabs(params["wcat"])
    return [(slabs if k == "wcat" else params[k]).data_ptr()
            for k in PARAM_KEYS]


def _raise_on(rc: int, name: str, lib: str = "decoder_fused") -> None:
    if rc != 0:
        msg = getattr(_library(lib), f"{lib}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decode_int_fwd(z: torch.Tensor, syn: torch.Tensor, s_h: int, s_w: int,
                   params: dict, slabs=None) -> torch.Tensor:
    """Integer-ratio decode of the full HR grid (s_h*H_in, s_w*W_in).

    z (B, H_in, W_in, L*H) float32 or bfloat16 (the weights of ``params``
    in the same dtype, ``pack_params(..., dtype)``), syn (s_h*H_in,
    s_w*W_in, 3) float32 -> (B, H_out, W_out, 3) float32. ``slabs``:
    ``forward_slabs(params["wcat"])`` where the caller has them (made here
    otherwise).
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
            z.data_ptr(), syn.data_ptr(), *_fwd_weights(params, slabs),
            out.data_ptr(), b, h_in, w_in, s_h, s_w, h, n_layers,
            _bf16(z), _stream(z.device))
    _raise_on(rc, "decode_int_fwd")
    launches[launch_key("decode_int_fwd", z.dtype)] += 1
    return out


def _bf16(z: torch.Tensor) -> int:
    return int(z.dtype == torch.bfloat16)


def _check_ratio(s_h: int, s_w: int) -> None:
    _require(1 <= s_h <= MAX_INT_RATIO and 1 <= s_w <= MAX_INT_RATIO,
             f"integer ratios must be in 1..{MAX_INT_RATIO}, got "
             f"{(s_h, s_w)}")


def decode_window_fwd(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                      params: dict, slabs=None) -> torch.Tensor:
    """Decode the HR window whose queries read LR rows ``rows`` and LR
    columns ``cols`` (``index_vector`` tensors on z's device).

    z (B, H_in, W_in, L*H), syn (len(rows), len(cols), 3) -> (B,
    len(rows), len(cols), 3) float32. ``slabs`` as for ``decode_int_fwd``.
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
            cols.data_ptr(), *_fwd_weights(params, slabs), out.data_ptr(),
            b, h_in, w_in, h_win, w_win, h, n_layers, _bf16(z),
            _stream(z.device))
    _raise_on(rc, "decode_window_fwd")
    launches[launch_key("decode_window_fwd", z.dtype)] += 1
    return out


def tf32_split(w: torch.Tensor) -> tuple:
    """(hi, lo) of fp32 ``w`` for 3xTF32 products: hi is w rounded to TF32
    (10 mantissa bits, to nearest, ties away from zero, as PTX
    ``cvt.rna.tf32.f32``), so its low 13 mantissa bits are zero; lo = w -
    hi, exact, so hi + lo == w."""
    bits = w.to(torch.float32).contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def chain_b_operands(wcat: torch.Tensor) -> tuple:
    """The B operands of the chain kernels' wgmma products
    (``hopper_chain.cuh``'s ChainTiling), as (L, K, passes, 2, n) views of
    ``wcat``: warpgroup wg owns hidden columns [wg h/2, (wg + 1) h/2).
    Forward (B = [Wkq | Wq], K = h): pass p of warpgroup wg reads the k and
    then the a columns of its jb = h/2/passes columns from wg h/2 + p jb.
    dq (B = [Wkq | Wq]^T, K = 2h): one pass, warpgroup wg reads its h/2
    columns."""
    n_layers, h, _ = wcat.shape
    passes = h // 128 if h >= 256 else 1
    jb = h // 2 // passes
    fwd = (wcat.reshape(n_layers, h, 2, 2, passes, jb)
           .permute(0, 1, 4, 3, 2, 5).reshape(n_layers, h, passes, 2, 2 * jb))
    dq = wcat.transpose(1, 2).reshape(n_layers, 2 * h, 1, 2, h // 2)
    return fwd, dq


def forward_slabs(wcat: torch.Tensor) -> torch.Tensor:
    """The forward chain's B slabs of ``wcat`` (both forward kernels, and
    the backward's recompute), in wcat's dtype."""
    return mma_b_slabs(chain_b_operands(wcat.detach())[0])


def mma_b_slabs(w: torch.Tensor) -> torch.Tensor:
    """B operands w (L, K, P, WG, n) (the n columns that pass p of
    warpgroup wg reads) of the chain kernel's wgmma products, in the layout
    its B descriptor reads (K-major, no swizzle: core matrices of 8 rows x
    16 bytes, the two k halves of a k step 128 bytes apart, n8 groups 256
    bytes apart).

    float32 (TF32 products): split, (L, P, K/8, WG, 2, n/8, 2, 8, 4); one
    slab (p, k8 step s, wg) holds hi then lo; within each, element (k = 8s
    + 4h + c, column 8g + r) sits at [g, h, r, c]. bfloat16: (L, P, K/16,
    WG, n/8, 2, 8, 8); in slab (p, k16 step s, wg), element (k = 16s + 8h +
    c, column 8g + r) sits at [g, h, r, c]."""
    n_layers, k, p, wg, n = w.shape
    if w.dtype == torch.bfloat16:
        x = w.reshape(n_layers, k // 16, 2, 8, p, wg, n // 8, 8)
        # (L, s, half, c, P, WG, g, r) -> (L, P, s, WG, g, half, r, c)
        return x.permute(0, 4, 1, 5, 6, 2, 7, 3).contiguous()
    hi, lo = tf32_split(w)
    x = torch.stack([hi, lo], dim=1)
    x = x.reshape(n_layers, 2, k // 8, 2, 4, p, wg, n // 8, 8)
    # (L, hi/lo, s, k half, c, P, WG, g, r) -> (L, P, s, WG, hi/lo, g, half,
    # r, c)
    return x.permute(0, 5, 2, 6, 1, 7, 3, 8, 4).contiguous()


def bwd_scratch_bytes(n_query: int, n_pix: int, run: int, h: int,
                      n_layers: int, dtype: torch.dtype,
                      activations_only: bool = False) -> int:
    """Bytes of scratch of one backward call (``decoder_bwd::
    scratch_bytes``) for ``n_query`` queries reading ``n_pix`` LR pixels
    in runs of ``run`` (s_h * s_w; 0 for a window), in ``dtype``'s
    instance; ``activations_only``: its per-query sections alone."""
    return _library("decoder_bwd").decoder_bwd_scratch_bytes(
        n_query, n_pix, run, h, n_layers, int(dtype == torch.bfloat16),
        int(activations_only))


def _bwd_buffers(z: torch.Tensor, n_query: int, run: int, h: int,
                 n_layers: int, params: dict, fwd_slabs) -> tuple:
    """dz (z's dtype), the flat fp32 weight-gradient vector with its
    per-key views (the layout of ``decoder_bwd::Plan``), the wgmma B slabs
    of [Wkq | Wq] (``fwd_slabs`` unless None) and of its transpose, and the
    scratch buffer of one backward call (``run``: as ``bwd_scratch_bytes``).
    """
    with span("decoder.backward.prepare"):
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
        n_pix = z.shape[0] * z.shape[1] * z.shape[2]
        scratch = torch.empty(bwd_scratch_bytes(n_query, n_pix, run, h,
                                                n_layers, z.dtype),
                              dtype=torch.uint8, device=dev)
        wcat = params["wcat"].detach()
        slabs = (forward_slabs(wcat) if fwd_slabs is None else fwd_slabs,
                 mma_b_slabs(chain_b_operands(wcat)[1]))
        return torch.empty_like(z), flat, grads, slabs, scratch


def _bwd_weights(params: dict, slabs: tuple) -> list:
    return [params["w0"].data_ptr(), params["b0"].data_ptr(),
            slabs[0].data_ptr(), params["bcat"].data_ptr(),
            params["wl"].data_ptr(), slabs[1].data_ptr()]


def decode_int_bwd(z: torch.Tensor, syn: torch.Tensor, s_h: int, s_w: int,
                   params: dict, g: torch.Tensor, slabs=None) -> tuple:
    """VJP of ``decode_int_fwd`` for the upstream gradient ``g`` (B, H_out,
    W_out, 3) float32: (dz like z, {w0, b0, wcat, bcat, wl, bl} float32
    gradients). ``slabs``: the forward's ``forward_slabs`` where the caller
    has them."""
    if z.device.type == "cpu":
        return decode_int_bwd_ref(z, syn, s_h, s_w, params, g)
    b, h_in, w_in, _ = z.shape
    _check_ratio(s_h, s_w)
    h_out, w_out = s_h * h_in, s_w * w_in
    h, n_layers = _check_common(z, syn, params, (h_out, w_out))
    _check_grad(g, z, (b, h_out, w_out, 3))
    dz, flat, grads, slabs, scratch = _bwd_buffers(
        z, b * h_out * w_out, s_h * s_w, h, n_layers, params, slabs)
    with torch.cuda.device(z.device):
        rc = _library("decoder_bwd").launch_decode_int_bwd(
            z.data_ptr(), syn.data_ptr(), *_bwd_weights(params, slabs),
            g.data_ptr(), dz.data_ptr(), flat.data_ptr(),
            scratch.data_ptr(), b, h_in, w_in, s_h, s_w, h, n_layers,
            _bf16(z), _stream(z.device))
    _raise_on(rc, "decode_int_bwd", "decoder_bwd")
    launches[launch_key("decode_int_bwd", z.dtype)] += 1
    return dz, grads


def decode_window_bwd(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                      params: dict, g: torch.Tensor, slabs=None) -> tuple:
    """VJP of ``decode_window_fwd`` for ``g`` (B, len(rows), len(cols),
    3): (dz like z, weight gradients). LR pixels that no query of the
    window reads get zero. ``slabs`` as for ``decode_int_bwd``."""
    _check_index(rows, z, "rows")
    _check_index(cols, z, "cols")
    if z.device.type == "cpu":
        return decode_window_bwd_ref(z, syn, rows, cols, params, g)
    b, h_in, w_in, _ = z.shape
    h_win, w_win = rows.numel(), cols.numel()
    h, n_layers = _check_common(z, syn, params, (h_win, w_win))
    _check_grad(g, z, (b, h_win, w_win, 3))
    dz, flat, grads, slabs, scratch = _bwd_buffers(
        z, b * h_win * w_win, 0, h, n_layers, params, slabs)
    with torch.cuda.device(z.device):
        rc = _library("decoder_bwd").launch_decode_window_bwd(
            z.data_ptr(), syn.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), *_bwd_weights(params, slabs),
            g.data_ptr(), dz.data_ptr(), flat.data_ptr(), scratch.data_ptr(),
            b, h_in, w_in, h_win, w_win, h, n_layers, _bf16(z),
            _stream(z.device))
    _raise_on(rc, "decode_window_bwd", "decoder_bwd")
    launches[launch_key("decode_window_bwd", z.dtype)] += 1
    return dz, grads


def _check_grad(g: torch.Tensor, z: torch.Tensor, shape: tuple) -> None:
    _check_tensor("g", g, z)
    _require(tuple(g.shape) == shape,
             f"g must be {shape}, got {tuple(g.shape)}")
