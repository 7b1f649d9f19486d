"""MLP over the last axis (counterpart of ``tpu_diinn/nn/mlp.py``):
relu after each hidden layer, the layers named ``fc0..fc{len(hidden)}``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpu_diinn_torch.nn.layers import Dense


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"fc{i}", Dense(dims[i], dims[i + 1],
                                            generator=generator,
                                            dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers - 1):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.n_layers - 1}")(x)
