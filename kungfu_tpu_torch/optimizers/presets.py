"""Optimizer presets (counterpart of kungfu_tpu.optimizers.presets): sensible
defaults for the model families shipped in kungfu_tpu_torch.models.  They
compose with the distributed wrappers like any inner optimizer factory:

    tx = synchronous_sgd(lm_adamw(3e-4, warmup_steps=2000, total_steps=100_000))

(The reference wraps TF optimizers; presets have no reference analog.)
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from .sync import OptimizerWrapper


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0,
                        exponent: float = 1.0) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule`: linear from `init_value` to
    `peak_value` over `warmup_steps`, then cosine decay to `end_value` at
    `decay_steps` (warmup included), as a function of the update count."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


class LMAdamW(OptimizerWrapper):
    """Global-norm clipping, then AdamW on the schedule's rate.  `state` is
    the number of updates taken (the schedule's count)."""

    def __init__(self, params, schedule: Callable[[int], float], clip_norm: float,
                 b1: float, b2: float, weight_decay: float):
        params = list(params)
        # weight decay on matrices only: LayerNorm scales and other vectors do not decay
        groups = [{"params": [p for p in params if p.ndim >= 2], "weight_decay": weight_decay},
                  {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0}]
        super().__init__(torch.optim.AdamW([g for g in groups if g["params"]],
                                           lr=schedule(0), betas=(b1, b2), eps=1e-8))
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.state = 0

    def step(self) -> None:
        grads = [p.grad for p in self.params() if p.grad is not None]
        with torch.no_grad():
            # optax.clip_by_global_norm: unchanged below the limit, else
            # (g / norm) * limit
            norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * self.clip_norm))
        lr = self.schedule(self.state)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.state += 1


def lm_adamw(lr: float, warmup_steps: int, total_steps: int, weight_decay: float = 0.1,
             b1: float = 0.9, b2: float = 0.95, min_lr_ratio: float = 0.1,
             clip_norm: float = 1.0) -> Callable[[Iterable[torch.nn.Parameter]], LMAdamW]:
    """The standard LLM-pretraining recipe: global-norm clip (of the
    gradient the outer wrapper has already averaged), AdamW with b2=0.95,
    linear warmup -> cosine decay (optax.warmup_cosine_decay_schedule from
    0 to `lr` and down to `lr * min_lr_ratio`, step for step), and weight
    decay on rank >= 2 parameters only (matrices decay; LayerNorm scales and
    other vectors do not)."""
    schedule = warmup_cosine_decay(0.0, lr, warmup_steps, total_steps, lr * min_lr_ratio)

    def make(params: Iterable[torch.nn.Parameter]) -> LMAdamW:
        return LMAdamW(params, schedule, clip_norm, b1, b2, weight_decay)

    return make
