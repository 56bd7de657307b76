"""Distributed optimizers (counterpart of kungfu_tpu.optimizers).

Each algorithm is a factory `tx(params) -> optimizer` over an inner
factory (a `torch.optim` one such as `adamw(...)`, or another wrapper),
as the JAX package chains optax transforms:

    synchronous_sgd, synchronous_averaging, pair_averaging, adaptive_sgd,
    gradient_noise_scale, gradient_variance, noise_adaptive_compression,
    all_reduce_gradients, lm_adamw

and the host gossip over the blob store, HostPairAveraging and
OverlappedHostPairAveraging (`gossip.py`).

Reference-named aliases (for users migrating from KungFu) are the wrapper
classes, which take an inner optimizer instance as KungFu's take a TF
optimizer:

    SynchronousSGDOptimizer            (synchronous_sgd)
    SynchronousAveragingOptimizer      (synchronous_averaging)
    PairAveragingOptimizer             (pair_averaging)
    AdaptiveSGDOptimizer               (adaptive_sgd)
    MonitorGradientNoiseScaleOptimizer (gradient_noise_scale)
    MonitorGradientVarianceOptimizer   (gradient_variance)
"""
from __future__ import annotations

import functools

import torch

from .adaptive import (
    AdaptiveSGDOptimizer,
    AdaptiveSGDState,
    NoiseAdaptiveCompressionState,
    adaptive_sgd,
    get_compression_state,
    noise_adaptive_compression,
)
from .gossip import (
    GossipState,
    HostPairAveraging,
    OverlappedHostPairAveraging,
    PairAveragingOptimizer,
    pair_averaging,
)
from .monitor import (
    GradVarianceState,
    MonitorGradientNoiseScaleOptimizer,
    MonitorGradientVarianceOptimizer,
    NoiseScaleState,
    get_gradient_variance,
    get_noise_scale,
    gradient_noise_scale,
    gradient_variance,
)
from .presets import lm_adamw
from .sync import (
    CompressedGradState,
    SMAState,
    SynchronousAveragingOptimizer,
    SynchronousSGDOptimizer,
    all_reduce_gradients,
    synchronous_averaging,
    synchronous_sgd,
)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """`torch.optim.AdamW` with optax.adamw's defaults and argument names.

    optax decays every parameter by 1e-4 unless told otherwise, where
    torch.optim.AdamW's default is 1e-2; the update rule is the same."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


__all__ = [
    "adamw", "all_reduce_gradients", "synchronous_sgd", "synchronous_averaging",
    "pair_averaging", "GossipState", "PairAveragingOptimizer", "HostPairAveraging",
    "OverlappedHostPairAveraging",
    "adaptive_sgd", "gradient_noise_scale", "gradient_variance",
    "get_noise_scale", "get_gradient_variance",
    "noise_adaptive_compression", "get_compression_state",
    "SMAState", "AdaptiveSGDState", "NoiseScaleState", "GradVarianceState",
    "CompressedGradState", "NoiseAdaptiveCompressionState",
    "SynchronousSGDOptimizer", "SynchronousAveragingOptimizer", "AdaptiveSGDOptimizer",
    "MonitorGradientNoiseScaleOptimizer", "MonitorGradientVarianceOptimizer",
    "lm_adamw",
]
