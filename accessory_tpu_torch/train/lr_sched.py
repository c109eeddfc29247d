"""LR schedules: cosine with linear warmup, iteration- and epoch-based.
Port of ``accessory_tpu/train/lr_sched.py`` (evaluated on the host: the
optimizer reads the schedule once per step)."""

from __future__ import annotations

import math


def cosine_lr(it, lr: float, min_lr: float, warmup: float, total: float) -> float:
    """Schedule value at step ``it``: linear from 0 over ``warmup``, then a
    cosine from ``lr`` down to ``min_lr`` at ``total``."""
    it = float(it)
    if it < warmup:
        return lr * it / max(warmup, 1e-9)
    progress = min(max((it - warmup) / max(total - warmup, 1e-9), 0.0), 1.0)
    return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))


def adjust_learning_rate(it: int, args) -> float:
    """Iteration-based (the pretraining loop)."""
    return cosine_lr(it, args.lr, args.min_lr, args.warmup_iters, args.lr_decay_iters)


def adjust_learning_rate_epoch(epoch_frac: float, args) -> float:
    """Epoch-based (the finetuning loop)."""
    return cosine_lr(epoch_frac, args.lr, args.min_lr, args.warmup_epochs, args.epochs)
