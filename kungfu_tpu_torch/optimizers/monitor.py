"""In-step training monitors: gradient noise scale and gradient variance
(counterpart of kungfu_tpu.optimizers.monitor).

Reference: the GNS estimator (srcs/python/kungfu/tensorflow/ops/monitor.py:
6-18 global_noise_scale + the EMA'd NoiseScale kernel, srcs/cpp/src/
tensorflow/ops/cpu/collective.cpp:212-258) and the gradient-variance monitor
(optimizers/grad_variance.py:38-75).  Both wrap an inner optimizer (usually
`synchronous_sgd`), pass its gradients on unchanged and keep scalar metrics
in their state; read them after a step with `get_noise_scale` /
`get_gradient_variance`, or publish them by name with
`variables.publish_monitor_state`.

A monitor reads the **local** `.grad`s before its inner optimizer reduces
them in place, and takes its own mean of each on a copy (`pmean_`), as the
JAX monitor takes `lax.pmean` beside the inner's reduction: the gradients
are reduced twice, as in the reference.  The copy is one gradient at a
time.  The scalars stay on the gradients' device; nothing waits for the
step until a caller reads them.

GNS math (McCandlish et al., "An Empirical Model of Large-Batch Training",
same estimator the reference implements):

    |G_small|^2 = squared norm of one worker's gradient  (batch b)
    |G_big|^2   = squared norm of the averaged gradient  (batch B = n*b)
    G_biased = (B*|G_big|^2 - b*|G_small|^2) / (B - b)     ~ |true grad|^2
    S_biased = (|G_small|^2 - |G_big|^2) / (1/b - 1/B)     ~ trace of noise cov
    gns      = ema(S) / ema(G)        (bias-corrected EMAs, alpha=0.6)
"""
from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Tuple

import torch

from .sync import OptimizerWrapper, _world, pmean_


def global_sq_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of squares in f32: each tensor's sum, added in order."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return total


class EMAState(NamedTuple):
    value: torch.Tensor  # f32 scalar
    count: int


def ema_init(device) -> EMAState:
    return EMAState(value=torch.zeros((), dtype=torch.float32, device=device), count=0)


def ema_update(s: EMAState, x: torch.Tensor, alpha: float) -> Tuple[torch.Tensor, EMAState]:
    """Bias-corrected EMA (reference include/kungfu/utils/ema.hpp), in f32."""
    count = s.count + 1
    value = (1 - alpha) * s.value + alpha * x
    decay = torch.tensor(1 - alpha, dtype=torch.float32, device=x.device)
    corrected = value / (1 - decay ** count)
    return corrected, EMAState(value=value, count=count)


def _norms(grads: List[torch.Tensor], group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pmean of the local squared norm, squared norm of the pmean): the
    gradients themselves stay local."""
    g_small_sq = pmean_(global_sq_norm(grads), group)
    g_big_sq = global_sq_norm(pmean_(g.detach().clone(), group) for g in grads)
    return g_small_sq, g_big_sq


def noise_scale_step(g_ema: EMAState, s_ema: EMAState, g_small_sq: torch.Tensor,
                     g_big_sq: torch.Tensor, local_batch_size: int, n: int, alpha: float):
    """One step of the GNS estimator: (gns, g_ema, s_ema)."""
    f32 = dict(dtype=torch.float32, device=g_small_sq.device)
    b_small = torch.tensor(float(local_batch_size), **f32)
    b_big = torch.tensor(float(local_batch_size * n), **f32)
    g_biased = (b_big * g_big_sq - b_small * g_small_sq) / (b_big - b_small)
    s_biased = (g_small_sq - g_big_sq) / (1.0 / b_small - 1.0 / b_big)
    g_val, g_ema = ema_update(g_ema, g_biased, alpha)
    s_val, s_ema = ema_update(s_ema, s_biased, alpha)
    gns = s_val / torch.where(torch.abs(g_val) > 1e-30, g_val, torch.tensor(1e-30, **f32))
    return gns, g_ema, s_ema


class NoiseScaleState(NamedTuple):
    g_ema: EMAState
    s_ema: EMAState
    noise_scale: torch.Tensor  # the monitored metric


class MonitorGradientNoiseScaleOptimizer(OptimizerWrapper):
    """Estimates the gradient noise scale from the local and averaged
    gradient norms each step, then steps the inner optimizer."""

    def __init__(self, inner, local_batch_size: int, group=None, alpha: float = 0.6):
        super().__init__(inner, group)
        self.local_batch_size = local_batch_size
        self.alpha = alpha
        device = self.params()[0].device
        self.state = NoiseScaleState(ema_init(device), ema_init(device),
                                     torch.zeros((), dtype=torch.float32, device=device))

    def step(self) -> None:
        n = _world(self.group)
        s = self.state
        if n <= 1:
            # single worker: B == b makes the estimator 0/0; noise_scale
            # stays 0 rather than poisoning the EMA
            self.inner.step()
            self.state = s._replace(noise_scale=torch.zeros_like(s.noise_scale))
            return
        grads = [p.grad for p in self.params() if p.grad is not None]
        g_small_sq, g_big_sq = _norms(grads, self.group)
        gns, g_ema, s_ema = noise_scale_step(s.g_ema, s.s_ema, g_small_sq, g_big_sq,
                                             self.local_batch_size, n, self.alpha)
        self.inner.step()
        self.state = NoiseScaleState(g_ema, s_ema, gns)


def gradient_noise_scale(inner: Callable, local_batch_size: int, group=None, alpha: float = 0.6
                         ) -> Callable[[Iterable[torch.nn.Parameter]],
                                       MonitorGradientNoiseScaleOptimizer]:
    """MonitorGradientNoiseScaleOptimizer factory (grad_noise_scale.py:
    42-90): `inner(params)` (typically synchronous_sgd) steps on the
    gradients; the noise scale of each step's local gradients (batch
    `local_batch_size` a rank) is read by `get_noise_scale`.  B is b times
    the group's size, the ranks the means are taken over."""

    def make(params: Iterable[torch.nn.Parameter]) -> MonitorGradientNoiseScaleOptimizer:
        params = list(params)
        return MonitorGradientNoiseScaleOptimizer(inner(params), local_batch_size, group, alpha)

    return make


class GradVarianceState(NamedTuple):
    variance: torch.Tensor


class MonitorGradientVarianceOptimizer(OptimizerWrapper):
    """variance = E|g_i|^2 - |E g_i|^2 across ranks, one scalar a step."""

    def __init__(self, inner, group=None):
        super().__init__(inner, group)
        device = self.params()[0].device
        self.state = GradVarianceState(torch.zeros((), dtype=torch.float32, device=device))

    def step(self) -> None:
        grads = [p.grad for p in self.params() if p.grad is not None]
        mean_sq, sq_mean = _norms(grads, self.group)
        self.inner.step()
        self.state = GradVarianceState(torch.clamp(mean_sq - sq_mean, min=0.0))


def gradient_variance(inner: Callable, group=None
                      ) -> Callable[[Iterable[torch.nn.Parameter]],
                                    MonitorGradientVarianceOptimizer]:
    """MonitorGradientVarianceOptimizer factory (grad_variance.py:38-75)."""

    def make(params: Iterable[torch.nn.Parameter]) -> MonitorGradientVarianceOptimizer:
        params = list(params)
        return MonitorGradientVarianceOptimizer(inner(params), group)

    return make


# -- metric getters (analog of kungfu.tensorflow.variables getters) -------------------


def find_state(opt, cls):
    """The first state of type `cls` down the chain of wrappers' `.inner`."""
    while opt is not None:
        if isinstance(getattr(opt, "state", None), cls):
            return opt.state
        opt = getattr(opt, "inner", None)
    return None


def get_noise_scale(opt) -> torch.Tensor:
    s = find_state(opt, NoiseScaleState)
    if s is None:
        raise ValueError("no gradient_noise_scale in this optimizer chain")
    return s.noise_scale


def get_gradient_variance(opt) -> torch.Tensor:
    s = find_state(opt, GradVarianceState)
    if s is None:
        raise ValueError("no gradient_variance in this optimizer chain")
    return s.variance
