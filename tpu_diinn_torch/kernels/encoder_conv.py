"""The fp32 inference encoder's convolution: an implicit-GEMM CUDA kernel on
NHWC channel slabs, and its plain version.

It replaces no TPU kernel: the JAX package's encoder convs were XLA
convs. On the card, cuDNN's fp32 convs run on the CUDA cores (TF32 off, as
fp32 requires), NCHW, with layout kernels and a growing ``torch.cat`` in
every residual dense block around them. ``csrc/encoder_conv.cuh``
computes a stride-1, same-padded k x k conv (k = 1 or 3) in 3xTF32 on the
tensor cores, which keeps fp32-level error, and fuses the epilogue:

    out[..., 0:Cout] = conv(x[..., 0:Cin]) + bias  -> ReLU (``relu``)
                       -> + residual[..., 0:Cout]  (``residual``)

and the same values into ``out2`` where given. ``x``, ``out``,
``residual`` and ``out2`` are channel slices of NHWC slabs, (B, H, W, C)
views whose pixel stride may exceed C: a residual dense block keeps one
slab, each conv reading its channel prefix and writing the next 64
channels, so nothing is concatenated.

Who takes it (``engaged``): RDN without a head, EDSR-baseline and the
stacked LR conv (``nn/rdn.py``, ``nn/edsr.py``, ``nn/diinn.py``) when the
input is a CUDA tensor, the compute dtype and the input float32, autograd
off, no halo and no valid-extent masking. Everything else (training, bf16,
the halo-sharded encoder, the bucketed eval, RDN's head, the CPU) keeps
``nn/layers.Conv``'s cuDNN path.

``conv`` takes its plain version (``conv_ref``: ``F.conv2d`` on the slab
prefix, the same epilogue) only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises. Each launch adds one to ``launches``
(``reset_launches`` sets it to 0). The weights go to the kernel split
into TF32 hi and lo in wgmma's B layout (``weight_slabs``), made once per
parameter and kept on the module that owns it while the parameters'
storage and version stay (``operands``), so a ``load_state_dict`` or an
optimizer step makes them again.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpu_diinn_torch.kernels.decoder_fused import tf32_split
from tpu_diinn_torch.nn.masking import masking_active

KERNEL_SIZES = (1, 3)
N_TILE = 64      # output channels a tile (csrc/encoder_conv.cuh kN)
K_CHUNK = 32     # input channels a chunk (kKc)
K_STEP = 8       # a wgmma TF32 k step
SLAB_FLOATS = K_CHUNK // K_STEP * 2 * N_TILE * 8   # one slab (kSlabFloats)

launches = 0

_CACHE_ATTR = "_encoder_conv_operands"


def reset_launches() -> None:
    global launches
    launches = 0


def engaged(x: torch.Tensor, dtype: torch.dtype, halo=None) -> bool:
    """Whether a module of compute dtype ``dtype`` (and mesh axis
    ``halo``) runs its convs on the slab path for input ``x``."""
    return (x.is_cuda and dtype == torch.float32
            and x.dtype == torch.float32 and not torch.is_grad_enabled()
            and halo is None and not masking_active())


def weight_slabs(w: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand of a (Cout, Cin, k, k) float32 weight:
    (N tiles, chunks, taps, k8 steps, hi/lo, 8, 2, 8, 4), Cout padded to
    a multiple of 64 and Cin to one of 32 with zeros. Slab (nt, q, t) is
    one tap's 32 input channels for 64 output channels; in it, k8 step
    s = 2 j + u holds hi then lo (``tf32_split``), and the weight of input
    channel 32 q + 16 j + 4 c + 2 u + h and output channel 64 nt + 8 g + r
    sits at [g, h, r, c]: core matrices of 8 rows x 16 bytes, k halves 128
    bytes apart, n8 groups 256 (``mma_b_slabs``' layout), with the k order
    the kernel's fragment loads permute to (``load_tap``)."""
    cout, cin, kh, kw = w.shape
    nt = -(-cout // N_TILE)
    nq = -(-cin // K_CHUNK)
    wp = w.new_zeros((nt * N_TILE, nq * K_CHUNK, kh, kw))
    wp[:cout, :cin] = w
    # (nt, g, r, q, j, c, u, h, tap)
    x = wp.reshape(nt, 8, 8, nq, K_CHUNK // 16, 4, 2, 2, kh * kw)
    hi, lo = tf32_split(x)
    y = torch.stack([hi, lo])
    # (hl, nt, g, r, q, j, c, u, h, tap) -> (nt, q, tap, j, u, hl, g, h, r,
    # c), j u the k8 step
    y = y.permute(1, 4, 9, 5, 7, 0, 2, 8, 3, 6).contiguous()
    return y.reshape(nt, nq, kh * kw, K_CHUNK // K_STEP, 2, 8, 2, 8, 4)


def _version(t: torch.Tensor):
    try:
        return t._version
    except RuntimeError:  # an inference tensor keeps no version counter
        return None


def operands(owner: torch.nn.Module, weights: Sequence[torch.Tensor],
             biases: Sequence[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(weight, bias, slabs) of the conv whose output channels are those
    of ``weights`` and ``biases`` in turn, detached: the parameters
    themselves for a plain conv (one each), their concatenation for the
    stacked LR conv; slabs (``weight_slabs``) only for CUDA tensors, else
    None. Kept on ``owner`` while every tensor's storage and version
    stay."""
    ts = list(weights) + list(biases)
    key = tuple((t.data_ptr(), _version(t)) for t in ts)
    cached = owner.__dict__.get(_CACHE_ATTR)
    if (cached is not None and cached[0] == key
            and all(v is not None for _, v in key)):
        return cached[1]
    w, b = _joined(weights), _joined(biases)
    ops = (w, b, weight_slabs(w) if w.is_cuda else None)
    owner.__dict__[_CACHE_ATTR] = (key, ops)
    return ops


def _joined(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The one tensor of ``ts``, detached, or their concatenation."""
    if len(ts) == 1:
        return ts[0].detach()
    return torch.cat([t.detach() for t in ts])


def conv_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             out: torch.Tensor, *, relu: bool = False,
             residual: Optional[torch.Tensor] = None,
             out2: Optional[torch.Tensor] = None) -> None:
    """The plain version: ``F.conv2d`` on the NCHW view of the slab
    prefix, the epilogue, then the stores (after the whole result, so that
    ``out`` may overlap ``x`` or ``residual``)."""
    pad = (weight.shape[-1] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=pad)
    y = y.permute(0, 2, 3, 1)
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual
    out.copy_(y)
    if out2 is not None:
        out2.copy_(y)


def conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
         out: torch.Tensor, *, slabs: Optional[torch.Tensor],
         relu: bool = False, residual: Optional[torch.Tensor] = None,
         out2: Optional[torch.Tensor] = None) -> None:
    """out (and out2) = conv(x) + bias, ReLU'd where ``relu``, plus
    ``residual``: x (B, H, W, Cin), out, residual and out2 (B, H, W, Cout)
    float32 slab views (channel stride 1, a pixel stride of their own);
    weight (Cout, Cin, k, k) with k 1 or 3, bias (Cout,), ``slabs``
    ``weight_slabs(weight)`` (unused, and may be None, on the CPU). For
    k = 3, out must not overlap x's channels (a 1x1 conv may write its own
    input's pixels: each output pixel reads only its own)."""
    if x.device.type == "cpu":
        conv_ref(x, weight, bias, out, relu=relu, residual=residual,
                 out2=out2)
        return
    global launches
    b, h, w, cin = x.shape
    cout, wcin, kh, kw = weight.shape
    _require(x.is_cuda and x.dtype == torch.float32,
             f"x must be a float32 CUDA tensor, got {x.dtype} on {x.device}")
    _require(kh == kw and kh in KERNEL_SIZES,
             f"kernel size must be one of {KERNEL_SIZES}, got {(kh, kw)}")
    _require(wcin == cin, f"weight takes {wcin} channels, x has {cin}")
    _require(tuple(bias.shape) == (cout,), f"bias must be ({cout},)")
    x = _as_slab(x)
    out_cs = _slab_stride("out", out, x, cout)
    res_cs = 0 if residual is None else _slab_stride("residual", residual,
                                                     x, cout)
    out2_cs = 0 if out2 is None else _slab_stride("out2", out2, x, cout)
    if kh == 3:
        _require(not _overlaps(x, out), "a 3x3 conv's out must not overlap "
                 "its input channels")
    n_slabs = -(-cout // N_TILE) * -(-cin // K_CHUNK) * kh * kw
    _require(slabs is not None and slabs.dtype == torch.float32
             and slabs.is_contiguous()
             and slabs.numel() == n_slabs * SLAB_FLOATS
             and slabs.device == x.device,
             "slabs must be weight_slabs(weight)")
    _require(bias.dtype == torch.float32 and bias.is_contiguous()
             and bias.device == x.device, "bias must be a contiguous float32 "
             f"tensor on {x.device}")
    with torch.cuda.device(x.device):
        rc = _library().launch_encoder_conv(
            x.data_ptr(), cin, x.stride(2), b, h, w, kh, slabs.data_ptr(),
            bias.data_ptr(), cout, out.data_ptr(), out_cs,
            None if residual is None else residual.data_ptr(), res_cs,
            None if out2 is None else out2.data_ptr(), out2_cs, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = _library().encoder_conv_error_string(rc).decode()
        raise RuntimeError(f"encoder_conv launch failed: error {rc} ({msg})")
    launches += 1


def module_conv(module: torch.nn.Module, x: torch.Tensor, out: torch.Tensor,
                **kw) -> None:
    """``conv`` with an ``nn/layers.Conv``'s weight and bias (slabs kept
    on the module)."""
    c = module.conv
    w, b, slabs = operands(module, [c.weight], [c.bias])
    conv(x, w, b, out, slabs=slabs, **kw)


def new_slab(like: torch.Tensor, channels: int) -> torch.Tensor:
    """An uninitialised (B, H, W, channels) float32 slab beside ``like``."""
    b, h, w = like.shape[:3]
    return torch.empty((b, h, w, channels), dtype=torch.float32,
                       device=like.device)


# ---------------------------------------------------------------------------
# The launch.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from tpu_diinn_torch.kernels import build
        lib = build.load("encoder_conv")
        lib.launch_encoder_conv.argtypes = (
            [_P, _I, _L, _I, _I, _I, _I, _P, _P, _I, _P, _L, _P, _L, _P, _L,
             _I, _P])
        lib.launch_encoder_conv.restype = _I
        lib.encoder_conv_error_string.argtypes = [_I]
        lib.encoder_conv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _pixel_stride(t: torch.Tensor) -> Optional[int]:
    """The pixel stride of a (B, H, W, C) channel-slab view (channels
    contiguous, pixels evenly spaced), else None."""
    b, h, w, c = t.shape
    cs = t.stride(2)
    ok = ((c <= 1 or t.stride(3) == 1) and cs >= c
          and (h <= 1 or t.stride(1) == w * cs)
          and (b <= 1 or t.stride(0) == h * w * cs))
    return cs if ok else None


def _as_slab(x: torch.Tensor) -> torch.Tensor:
    """x itself where the tensor map can read it (a channel slab whose
    pixel stride is a multiple of 4 floats, 16-byte aligned), else a copy
    into such a slab."""
    cs = _pixel_stride(x)
    if cs is not None and cs % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    c = x.shape[3]
    s = new_slab(x, -(-c // 4) * 4)[..., :c]
    s.copy_(x)
    return s


def _slab_stride(name: str, t: torch.Tensor, x: torch.Tensor,
                 cout: int) -> int:
    _require(t.dtype == torch.float32 and t.device == x.device,
             f"{name} must be float32 on {x.device}")
    _require(tuple(t.shape) == (*x.shape[:3], cout),
             f"{name} must be {(*x.shape[:3], cout)}, got {tuple(t.shape)}")
    cs = _pixel_stride(t)
    _require(cs is not None, f"{name} must be a channel-slab view")
    return cs


def _overlaps(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether slab view out may share a channel of a pixel with slab view
    x (True where their layouts differ)."""
    if x.untyped_storage().data_ptr() != out.untyped_storage().data_ptr():
        return False
    cs = x.stride(2)
    d = (out.data_ptr() - x.data_ptr()) // 4
    if out.stride(2) != cs or not 0 <= d or d + out.shape[3] > cs:
        return True
    return d < x.shape[3]
