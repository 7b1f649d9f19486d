"""The bicubic baseline on the models' contract (counterpart of
``tpu_diinn/nn/bicubic.py``): an antialiased bicubic resize of the input
to ``size``. No parameters."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tpu_diinn_torch.core.resize import resize


class BicubicNet(nn.Module):
    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        return resize(x, size)
