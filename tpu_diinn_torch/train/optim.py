"""Optimizer: Adam with a step-decay schedule on the global step.

Counterpart of ``tpu_diinn/train/optim.py`` (reference: Adam(lr=1e-4),
StepLR(10 epochs, gamma 0.5)). ``torch.optim.Adam`` with its defaults
(betas 0.9/0.999, eps 1e-8, no weight decay) is optax ``scale_by_adam``
with its defaults. The learning rate is piecewise constant on the global
step: update k (counting from 0) uses ``base_lr`` times ``lr_gamma`` for
every boundary ``e * steps_per_epoch <= k``, e = lr_step, 2 lr_step, ...,
max_epochs, as optax's ``piecewise_constant_schedule`` does.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


def step_decay_factor(step: int, steps_per_epoch: int,
                      lr_step_epochs: int = 10, lr_gamma: float = 0.5,
                      max_epochs: int = 50) -> float:
    """The schedule's multiplier of the base rate at global step ``step``."""
    factor = 1.0
    for e in range(lr_step_epochs, max_epochs + 1, lr_step_epochs):
        if step >= e * steps_per_epoch:
            factor *= lr_gamma
    return factor


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   base_lr: float = 1e-4, steps_per_epoch: int = 1,
                   lr_step_epochs: int = 10, lr_gamma: float = 0.5,
                   max_epochs: int = 50
                   ) -> Tuple[torch.optim.Adam, LambdaLR]:
    """Adam and its schedule; call ``scheduler.step()`` after every
    ``optimizer.step()``."""
    opt = torch.optim.Adam(params, lr=base_lr)
    sched = LambdaLR(
        opt, lambda step: step_decay_factor(step, steps_per_epoch,
                                            lr_step_epochs, lr_gamma,
                                            max_epochs))
    return opt, sched
