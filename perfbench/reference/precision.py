"""Operand rounding for the reference's lower-precision controls.

The reference computes every conv and matmul in float32 with TF32 off.
Its controls compute the same products from operands rounded to a lower
precision, with float32 sums, as the tensor cores do:

- ``tf32``: each operand rounded to TF32 (10 mantissa bits, to nearest,
  ties away from zero, as PTX ``cvt.rna.tf32.f32``). The product of two
  TF32 values is exact in float32, so the float32 sum is TF32's.
- ``fp8``: each operand scaled per tensor so that its largest magnitude
  maps to 448, rounded to ``float8_e4m3fn``, and scaled back (the usual
  per-tensor fp8 recipe); each product's result, and each sum kept
  between products, is stored in fp8 the same way, as a bf16 computation
  stores its results and residual sums in bf16. In training
  the gradient that reaches a product's output is rounded the same way
  before the backward products.
- ``int8``: as ``fp8``, with each tensor scaled so that its largest
  magnitude maps to 127 and rounded to an integer (symmetric per-tensor
  int8; the integer products sum exactly).

``fp32`` rounds nothing. The rounding is explicit, so a control computes
the same on the CPU as on the card, whatever the backends' TF32 flags.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32", "fp8", "int8")
FP8_MAX = 448.0
STORED = ("fp8", "int8")      # precisions that store results rounded


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def round_int8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, 127.0 / amax, torch.ones_like(amax))
    return torch.round(x * scale).clamp(-127, 127) / scale


_ROUND = {"tf32": round_tf32, "fp8": round_fp8, "int8": round_int8}


class _RoundOperand(torch.autograd.Function):
    """Rounds a product's operand; its gradient passes unchanged (it is
    a product's float32 sum, not an operand)."""

    @staticmethod
    def forward(ctx, x, precision):
        return _ROUND[precision](x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundResult(torch.autograd.Function):
    """Rounds a product's result where the precision stores it rounded
    (fp8), and the gradient that reaches it, the operand of its backward
    products."""

    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return _ROUND[precision](x) if precision in STORED else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[ctx.precision](g), None


class Rounding:
    """``operand(x)``, ``output(y)`` and ``store(y)`` of every product and
    kept sum at ``precision``."""

    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.precision = precision

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return x
        return _RoundOperand.apply(x, self.precision)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return y
        if not y.requires_grad:
            return _ROUND[self.precision](y) if self.precision in STORED else y
        return _RoundResult.apply(y, self.precision)

    def store(self, y: torch.Tensor) -> torch.Tensor:
        """A sum kept between products (a residual stream): rounded where
        the precision stores results rounded (fp8), as ``output``."""
        return self.output(y) if self.precision in STORED else y
