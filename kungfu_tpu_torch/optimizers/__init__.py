"""Distributed optimizers (counterpart of kungfu_tpu.optimizers)."""
from __future__ import annotations

import functools

import torch

from .sync import SynchronousSGDOptimizer, all_reduce_gradients, synchronous_sgd


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """`torch.optim.AdamW` with optax.adamw's defaults and argument names.

    optax decays every parameter by 1e-4 unless told otherwise, where
    torch.optim.AdamW's default is 1e-2; the update rule is the same."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


__all__ = ["adamw", "synchronous_sgd", "all_reduce_gradients", "SynchronousSGDOptimizer"]
