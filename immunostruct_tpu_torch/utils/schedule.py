"""Learning-rate schedules as functions of the epoch (counterpart of
``immunostruct_tpu/utils/schedule.py``; reference: utils/scheduler.py
LinearWarmupCosineAnnealingLR).

The reference steps its scheduler once per epoch: a linear warmup from
``warmup_start_lr`` to the base rate over ``warmup_epochs``, then cosine
annealing to ``eta_min`` over the remaining epochs. ``make_optimizer``
(procedures/train.py) indexes a schedule by ``step // steps_per_epoch``.
"""

from __future__ import annotations

import math


def linear_warmup_cosine_annealing(base_lr: float, warmup_epochs: int,
                                   max_epochs: int,
                                   warmup_start_lr: float = 0.0,
                                   eta_min: float = 0.0):
    """Returns lr(epoch) matching the reference's closed-form schedule."""

    def schedule(epoch) -> float:
        epoch = float(epoch)
        if epoch < warmup_epochs:
            return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / max(
                1, warmup_epochs - 1)
        denom = max(1, max_epochs - warmup_epochs)
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * (epoch - warmup_epochs) / denom))

    return schedule


def constant_lr(lr: float):
    def schedule(epoch) -> float:
        return float(lr)
    return schedule


def linear_warmup_constant(base_lr: float, warmup_epochs: int,
                           warmup_start_lr: float = 0.0):
    """Linear warmup to ``base_lr`` over ``warmup_epochs``, then constant:
    the cosine schedule with zero annealing amplitude."""
    return linear_warmup_cosine_annealing(
        base_lr, warmup_epochs, max_epochs=warmup_epochs + 1,
        warmup_start_lr=warmup_start_lr, eta_min=base_lr)
