"""SRTask: normalization, multi-scale L1 loss, normalized inference.

Counterpart of ``tpu_diinn/train/task.py``: inputs in [0, 1] map to
[-1, 1] before the net, the training loss is the L1 distance to the
normalized HR target averaged over the scales of a batch, and predictions
map back and are clamped.

In the bf16 mode the net's prediction is bf16: the L1 loss against the
fp32 target promotes to fp32 (JAX's type promotion does the same), and the
clamped prediction stays bf16, denormalized and clamped in bf16 as JAX
clips it; the metrics take it in fp32 (``train/metrics.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from tpu_diinn_torch.train.profiling import span

SUB = 0.5
DIV = 0.5

Batch = Dict[float, Tuple[torch.Tensor, torch.Tensor]]


def normalize(x: torch.Tensor) -> torch.Tensor:
    return (x - SUB) / DIV


def denormalize(x: torch.Tensor) -> torch.Tensor:
    return x * DIV + SUB


@dataclasses.dataclass(frozen=True)
class SRTask:
    """Binds a model to the training objective and the eval protocol."""
    net: nn.Module
    eval_bsize: int = 30000

    def loss_and_preds(self, batch: Batch, bsize: Optional[int] = None):
        """Multi-scale step: ``batch`` maps scale -> (lr, hr) in [0, 1],
        NHWC. Returns (mean over scales of the L1 loss, {scale: clamped
        prediction})."""
        items = list(batch.items())
        feats = self._shared_lr_features(items)
        loss = 0.0
        preds = {}
        for i, (scale, (lr, hr)) in enumerate(items):
            size = (hr.shape[1], hr.shape[2])
            if feats is not None:
                b = lr.shape[0]
                pred = self.net.decoder(feats[i * b:(i + 1) * b], size,
                                        bsize)
            else:
                pred = self.net(normalize(lr), size, bsize)
            loss = loss + torch.mean(torch.abs(pred - normalize(hr)))
            preds[scale] = torch.clamp(denormalize(pred), 0.0, 1.0)
        return loss / len(items), preds

    def _shared_lr_features(self, items) -> Optional[torch.Tensor]:
        """When every scale of a multi-scale batch has the same LR shape
        (the training configuration: 48-px LR patches at scales {2,3,4}),
        the encoder runs once on the scale-concatenated batch instead of
        once per scale: the same features per sample, one encoder pass.
        Returns the stacked features, or None when that does not apply."""
        from tpu_diinn_torch.nn.diinn import DIINN
        if not isinstance(self.net, DIINN) or len(items) < 2:
            return None
        if len({tuple(lr.shape) for _, (lr, _) in items}) != 1:
            return None
        x = torch.cat([normalize(lr) for _, (lr, _) in items], dim=0)
        with span("encoder"):
            return self.net.encoder(x)

    def train_loss(self, batch: Batch) -> torch.Tensor:
        loss, _ = self.loss_and_preds(batch)
        return loss

    def stripe_loss(self, batch: Batch, index: int,
                    count: int) -> torch.Tensor:
        """Column stripe ``index`` of ``count``'s share of ``train_loss``:
        every scale's prediction decoded on that clamped stripe only
        (``parallel/sharding.py``), and the L1 distance summed over the
        stripe's own columns (not the repeated overhang) over the whole
        grid's element count. The ``count`` shares add up to
        ``train_loss`` (to fp32 rounding), and so do their gradients: the
        unit of the space-sharded training step."""
        from tpu_diinn_torch.parallel.sharding import (stripe_fns,
                                                       stripe_width)
        items = list(batch.items())
        encode, decode_stripe = stripe_fns(self.net)
        feats = self._shared_lr_features(items)
        loss = 0.0
        for i, (_, (lr, hr)) in enumerate(items):
            b, h_out, w_out = hr.shape[:3]
            width = stripe_width(w_out, count)
            start = index * width
            own = max(0, min(width, w_out - start))
            feat = (feats[i * b:(i + 1) * b] if feats is not None
                    else encode(normalize(lr)))
            pred = decode_stripe(feat, (h_out, w_out), start, width)
            y = normalize(hr[:, :, start:start + own])
            loss = loss + (torch.abs(pred[:, :, :own] - y).sum()
                           / hr.numel())
        return loss / len(items)

    def predict(self, lr: torch.Tensor, size: Tuple[int, int],
                bsize: Optional[int] = None) -> torch.Tensor:
        """[0, 1] NHWC in -> [0, 1] clamped NHWC out."""
        with span("predict"):
            pred = self.net(normalize(lr), size,
                            bsize if bsize is not None else self.eval_bsize)
            return torch.clamp(denormalize(pred), 0.0, 1.0)
