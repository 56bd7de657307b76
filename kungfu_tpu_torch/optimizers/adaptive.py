"""AdaptiveSGD and noise-driven compression (counterpart of
kungfu_tpu.optimizers.adaptive).

Reference: srcs/python/kungfu/tensorflow/optimizers/ada_sgd.py:27-84.  The
reference runs SMA (loose consensus, good for early exploration) until a
configured step, then broadcasts rank 0's model to everyone (AdaSGDHook) and
continues with synchronous SGD (tight consensus).  The JAX package switches
with a `lax.cond` inside the compiled step; here the step counter is a host
int, equal on every rank, so every rank takes the same branch and runs
the same collectives.
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import torch
import torch.distributed as dist

from .. import compression as Comp
from .monitor import EMAState, ema_init, find_state, global_sq_norm, noise_scale_step
from .sync import OptimizerWrapper, _world, pmean_, pull_toward_mean


class AdaptiveSGDState(NamedTuple):
    step: int  # steps taken; the same on every rank


class AdaptiveSGDOptimizer(OptimizerWrapper):
    """SMA for step < switch_step, S-SGD from it on; at the switch step
    every rank first takes rank 0's parameters."""

    def __init__(self, inner, switch_step: int, group=None, alpha: float = 0.1):
        super().__init__(inner, group)
        self.switch_step = switch_step
        self.alpha = alpha
        self.state = AdaptiveSGDState(step=0)

    def step(self) -> None:
        params = self.params()
        step = self.state.step
        if step < self.switch_step:
            pulls = pull_toward_mean(params, self.group, self.alpha)
            self.inner.step()
            with torch.no_grad():
                torch._foreach_add_(params, pulls)
        else:
            for p in params:
                if p.grad is not None:
                    pmean_(p.grad, self.group)
            if step == self.switch_step and _world(self.group) > 1:
                # AdaSGDHook's broadcast (ada_sgd.py:61-84): the parameters
                # only, never the inner state
                root = dist.get_global_rank(self.group, 0) if self.group is not None else 0
                with torch.no_grad():
                    for p in params:
                        dist.broadcast(p.data, src=root, group=self.group)
            self.inner.step()
        self.state = AdaptiveSGDState(step=step + 1)


def adaptive_sgd(inner: Callable, switch_step: int, group=None, alpha: float = 0.1
                 ) -> Callable[[Iterable[torch.nn.Parameter]], AdaptiveSGDOptimizer]:
    """AdaptiveSGDOptimizer factory: `synchronous_averaging` (SMA, pull
    `alpha`) for the first `switch_step` steps, then S-SGD (the gradients'
    pmean, then `inner(params)`'s step).  At step `switch_step` every rank
    takes rank 0's parameters before the inner step.

    The JAX package computes that step's update at each replica's own
    parameters and adds `broadcast(p) - p` to it; here the update is
    computed at rank 0's.  For an inner whose update does not read the
    parameters (SGD without weight decay) the two are the same arithmetic,
    and the replicas are bit-identical from the switch on, where adding the
    difference would round on each replica apart.  Only the parameters are
    broadcast: an inner with state (AdamW's moments) keeps each replica's
    own, so such replicas stay apart after the switch, as in the JAX
    package."""

    def make(params: Iterable[torch.nn.Parameter]) -> AdaptiveSGDOptimizer:
        params = list(params)
        return AdaptiveSGDOptimizer(inner(params), switch_step, group, alpha)

    return make


class NoiseAdaptiveCompressionState(NamedTuple):
    g_ema: EMAState
    s_ema: EMAState
    noise_scale: torch.Tensor  # last step's bias-corrected GNS (the monitor metric)
    compressed: bool  # the wire format this step took
    generator: torch.Generator  # stochastic rounding's


class NoiseAdaptiveCompressionOptimizer(OptimizerWrapper):
    """S-SGD whose gradient wire format follows the gradient noise scale."""

    def __init__(self, inner, local_batch_size: int, group=None, gns_threshold: float = 0.0,
                 compression="int8", alpha: float = 0.6, seed: int = 0):
        super().__init__(inner, group)
        self.local_batch_size = local_batch_size
        self.gns_threshold = gns_threshold
        self.config = Comp.resolve(compression)
        self.alpha = alpha
        device = self.params()[0].device
        self.state = NoiseAdaptiveCompressionState(
            ema_init(device), ema_init(device),
            torch.zeros((), dtype=torch.float32, device=device), False,
            torch.Generator(device=device).manual_seed(seed))

    def step(self) -> None:
        s = self.state
        n = _world(self.group)
        # the wire from LAST step's noise scale, min-reduced over the ranks:
        # they compress only when all agree (the JAX package's pmin fold)
        agree = (s.noise_scale >= self.gns_threshold).to(torch.int32)
        if n > 1:
            dist.all_reduce(agree, op=dist.ReduceOp.MIN, group=self.group)
        compressed = bool(agree.item())
        grads = [p.grad for p in self.params() if p.grad is not None]
        g_small_sq = pmean_(global_sq_norm(grads), self.group) if n > 1 else None
        for g in grads:  # in place: each gradient becomes its mean
            if compressed:
                g.copy_(Comp.all_reduce(g, self.group, self.config, op="mean",
                                        generator=s.generator))
            else:
                pmean_(g, self.group)
        if n > 1:
            gns, g_ema, s_ema = noise_scale_step(s.g_ema, s.s_ema, g_small_sq,
                                                 global_sq_norm(grads), self.local_batch_size,
                                                 n, self.alpha)
        else:
            gns, g_ema, s_ema = torch.zeros_like(s.noise_scale), s.g_ema, s.s_ema
        self.inner.step()
        self.state = NoiseAdaptiveCompressionState(g_ema, s_ema, gns, compressed, s.generator)


def noise_adaptive_compression(inner: Callable, local_batch_size: int, group=None,
                               gns_threshold: float = 0.0, compression="int8",
                               alpha: float = 0.6, seed: int = 0
                               ) -> Callable[[Iterable[torch.nn.Parameter]],
                                             NoiseAdaptiveCompressionOptimizer]:
    """S-SGD whose gradient wire format follows the gradient noise scale.

    When the GNS is large, per-step gradients are dominated by sampling
    noise, so quantization error (bounded by absmax/127 per block) is far
    below the noise floor and compression is free; when it drops, the
    gradients go back to the full-precision pmean.  Each step picks the
    wire from the previous step's noise scale (a one-step lag: the choice
    never depends on the bytes it is about to move), reduces every
    gradient with it (compressed: `compression.all_reduce(..., op="mean")`,
    each gradient drawing its own stochastic-rounding generators from the
    state's, seeded `seed`), updates the noise-scale EMAs from the local
    and averaged gradients, and steps `inner(params)` on the mean.  The
    default threshold 0 compresses while the estimate is not negative (it
    turns negative when the ranks' gradients barely agree, and the JAX
    package then leaves the compressed wire too); float("-inf") always
    compresses.  Read the state with `get_compression_state`."""
    cfg = Comp.resolve(compression)
    if not (cfg.is_quantized or cfg.scheme == "bf16"):
        raise ValueError(
            f"noise_adaptive_compression needs a dense wire format, got {cfg.scheme!r}")

    def make(params: Iterable[torch.nn.Parameter]) -> NoiseAdaptiveCompressionOptimizer:
        params = list(params)
        return NoiseAdaptiveCompressionOptimizer(inner(params), local_batch_size, group,
                                                 gns_threshold, cfg, alpha, seed)

    return make


def get_compression_state(opt) -> NoiseAdaptiveCompressionState:
    s = find_state(opt, NoiseAdaptiveCompressionState)
    if s is None:
        raise ValueError("no noise_adaptive_compression in this optimizer chain")
    return s
