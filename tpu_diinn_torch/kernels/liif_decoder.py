"""LIIF's query MLP on the card: one hand-written CUDA kernel a column
chunk, in place of the torch path's per-corner passes.

It replaces no TPU kernel: the JAX package runs LIIF's per-query products
as XLA dense ops. ``nn/liif.py``'s ``_blend`` runs, for each corner of a
chunk, two gathers of ``z``, the rel and cell dense layers, three 256 x 256
layers and the 256 -> 3 layer as cuBLAS fp32 SGEMMs on the CUDA cores,
ReLUs and the area blend: about 27 launches a chunk and corner, every
intermediate through device memory. ``csrc/liif_decoder.cuh`` computes the
whole per-query function in one launch a chunk, the 256 x 256 products in
3xTF32 on the tensor cores (fp32-level error), and writes only the blended
value (the design and what bounds it are in the header).

Who takes it (``engaged``): ``LIIF._blend`` (so ``decode``, ``decode_stripe``
and ``decode_traced``) when ``z`` is a float32 CUDA tensor, the module
computes in float32, autograd is off, and the imnet has the compiled widths
(four hidden layers of 256, three outputs). Everything else (training, bf16,
other widths, the CPU) keeps the torch path, which is this kernel's plain
version. Each launch adds one to ``launches`` (``reset_launches`` sets it
to 0).

The weights go to the kernel as two tensors made once and kept on the
module while every parameter's storage and version stay (``operands``), so
a ``load_state_dict`` or an optimizer step makes them again:
``weight_slabs``, W_1..W_3 split into TF32 hi and lo in wgmma's B layout,
and ``small_operands``, the rest packed into one float32 vector.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_diinn_torch.kernels.decoder_fused import mma_b_slabs
from tpu_diinn_torch.kernels.encoder_conv import _version

HIDDEN = 256          # every hidden layer's width (csrc/liif_decoder.cuh)
OUT = 3
CORNERS = 4
LAYERS = 3            # W_1..W_3 on the tensor cores
K8_STEPS = HIDDEN // 8
SLAB_FLOATS = HIDDEN // 2 * 16  # one slab: a k8 step of 128 columns, hi+lo
SMALL_FLOATS = 5 * HIDDEN + LAYERS * HIDDEN + OUT * HIDDEN + 4

_CACHE_ATTR = "_liif_decoder_operands"

KEY = "liif_decoder"  # ``launches`` beside the decoder's launch counts
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def engaged(z: torch.Tensor, dtype: torch.dtype, hidden: Sequence[int],
            out_channels: int) -> bool:
    """Whether a LIIF whose imnet computes in ``dtype`` with ``hidden``
    widths and ``out_channels`` outputs decodes ``z`` on the kernel."""
    return (z.is_cuda and z.dtype == torch.float32
            and dtype == torch.float32 and not torch.is_grad_enabled()
            and tuple(hidden) == (HIDDEN,) * (LAYERS + 1)
            and out_channels == OUT)


def weight_slabs(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's B operand of W_1..W_3 ((256, 256) each, (out, in) as
    ``nn.Linear`` keeps them): ``decoder_fused.mma_b_slabs`` of the
    transposed weights, one pass of two 128-column halves, (layers, 1, k8
    steps, halves, hi/lo, 16, 2, 8, 4). Slab (l, 0, s, h) is k8 step s of
    layer l's output columns 128 h .. 128 h + 127, hi then lo
    (``tf32_split``); in each, the weight of input k = 8 s + 4 kh + c and
    output n = 128 h + 8 g + r sits at [g, kh, r, c]."""
    b = torch.stack([w.detach().to(torch.float32).t() for w in ws])
    return mma_b_slabs(b.reshape(len(ws), HIDDEN, 1, 2, HIDDEN // 2))


def small_operands(rel_w: torch.Tensor, rel_b: torch.Tensor,
                   cell_w: torch.Tensor, biases: Sequence[torch.Tensor],
                   w4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    """W_rel's two columns, b_rel, W_cell's two columns, b_1..b_3, W_4's
    three rows and b_4 (and one zero), as one float32 vector (the layout of
    ``csrc/liif_decoder.cuh``'s kWr0 .. kB4)."""
    parts = [rel_w[:, 0], rel_w[:, 1], rel_b, cell_w[:, 0], cell_w[:, 1],
             *biases, w4.reshape(-1), b4, b4.new_zeros(1)]
    return torch.cat([t.detach().to(torch.float32).reshape(-1)
                      for t in parts])


def _parameters(net: torch.nn.Module) -> List[torch.Tensor]:
    fcs = [getattr(net, f"imnet_fc{i}").dense for i in range(1, LAYERS + 2)]
    return ([net.imnet_rel.dense.weight, net.imnet_rel.dense.bias,
             net.imnet_cell.dense.weight]
            + [t for fc in fcs for t in (fc.weight, fc.bias)])


def operands(net: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """(small, slabs) of a LIIF's imnet (``small_operands``,
    ``weight_slabs``), kept on ``net`` while every parameter's storage and
    version stay."""
    ps = _parameters(net)
    key = tuple((t.data_ptr(), _version(t)) for t in ps)
    cached = net.__dict__.get(_CACHE_ATTR)
    if (cached is not None and cached[0] == key
            and all(v is not None for _, v in key)):
        return cached[1]
    rel_w, rel_b, cell_w = ps[:3]
    ws, bs = ps[3::2], ps[4::2]
    ops = (small_operands(rel_w, rel_b, cell_w, bs[:LAYERS], ws[LAYERS],
                          bs[LAYERS]),
           weight_slabs(ws[:LAYERS]))
    net.__dict__[_CACHE_ATTR] = (key, ops)
    return ops


def decode_chunk(z: torch.Tensor, per_corner: Sequence[tuple],
                 cell: torch.Tensor, small: torch.Tensor,
                 slabs: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One chunk of a LIIF decode on the kernel: z (B, H_in, W_in, 256)
    float32, contiguous; ``per_corner`` four (row index (h,), row rel (h,)
    float32, column index (w,), column rel (w,) float32), the indices all
    int64 or all int32; cell (2,) float32; ``small`` and ``slabs`` from
    ``operands``. Writes the
    blended (B, h, w, 3) float32 prediction into ``out`` (a view whose
    pixels hold their 3 channels contiguously; allocated when None) and
    returns it; a launch adds one to ``launches`` (an empty chunk launches
    nothing). Raises on what the kernel does not take."""
    global launches
    _require(z.dim() == 4 and z.dtype == torch.float32,
             f"z must be a 4-D float32 tensor, got {tuple(z.shape)} "
             f"{z.dtype}")
    _require(z.shape[3] == HIDDEN, f"z must have {HIDDEN} channels, got "
             f"{z.shape[3]}")
    _require(z.is_contiguous(), "z must be contiguous (NHWC)")
    _require(len(per_corner) == CORNERS, f"{CORNERS} corners, got "
             f"{len(per_corner)}")
    h, w = len(per_corner[0][0]), len(per_corner[0][2])
    idx = per_corner[0][0].dtype
    _require(idx in (torch.int64, torch.int32),
             f"indices must be int64 or int32, got {idx}")
    vecs = []
    for k, (iy, ry, ix, rx) in enumerate(per_corner):
        for name, t, n, dt in (("row index", iy, h, idx),
                               ("row rel", ry, h, torch.float32),
                               ("column index", ix, w, idx),
                               ("column rel", rx, w, torch.float32)):
            _require(t.dim() == 1 and len(t) == n and t.dtype == dt
                     and t.is_contiguous() and t.device == z.device,
                     f"corner {k}'s {name} must be a contiguous ({n},) "
                     f"{dt} vector on {z.device}, got {tuple(t.shape)} "
                     f"{t.dtype} on {t.device}")
            vecs.append(t)
    for name, t, n in (("cell", cell, 2), ("small", small, SMALL_FLOATS),
                       ("slabs", slabs, LAYERS * K8_STEPS * 2 * SLAB_FLOATS)):
        _require(t.dtype == torch.float32 and t.numel() == n
                 and t.is_contiguous() and t.device == z.device,
                 f"{name} must be a contiguous float32 tensor of {n} values "
                 f"on {z.device}")
    b = z.shape[0]
    if out is None:
        out = z.new_empty((b, h, w, OUT))
    _require(tuple(out.shape) == (b, h, w, OUT)
             and out.dtype == torch.float32 and out.device == z.device
             and out.stride(3) == 1 and (w <= 1 or out.stride(2) == OUT),
             f"out must be a float32 ({b}, {h}, {w}, {OUT}) view on "
             f"{z.device} with contiguous pixels")
    _require(z.is_cuda, f"z must be on a CUDA device, got {z.device}")
    if out.numel() == 0:
        return out
    ptrs = (ctypes.c_void_p * (4 * CORNERS))(*[t.data_ptr() for t in vecs])
    with torch.cuda.device(z.device):
        rc = _library().launch_liif_decoder(
            z.data_ptr(), b, z.shape[1], z.shape[2], ptrs,
            int(idx == torch.int64), h, w,
            cell.data_ptr(), small.data_ptr(), slabs.data_ptr(),
            out.data_ptr(), out.stride(0), out.stride(1),
            torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        msg = _library().liif_decoder_error_string(rc).decode()
        raise RuntimeError(f"liif_decoder launch failed: error {rc} ({msg})")
    launches += 1
    return out


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
        lib = build.load("liif_decoder")
        lib.launch_liif_decoder.argtypes = (
            [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _L, _L, _P])
        lib.launch_liif_decoder.restype = _I
        lib.liif_decoder_error_string.argtypes = [_I]
        lib.liif_decoder_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
