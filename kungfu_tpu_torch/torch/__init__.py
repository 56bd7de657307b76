"""PyTorch interop: collectives and a synchronous-SGD wrapper for torch
models over the Session (counterpart of kungfu_tpu/torch/, the
reference's srcs/python/kungfu/torch/{__init__,ops/collective,
optimizers/sync_sgd}.py).

The JAX package carries torch tensors into its Session as numpy (bf16
through f32) and back.  Here the Session is torch's: each call reduces
this rank's tensor where it lies, on the card or the CPU, in its own
dtype, through the default peer's Session (`peer.default_peer`), so under
the strategies PALLAS_RING and PALLAS_RING_FUSED a card's f32/bf16 sum
runs the ring kernels (B5/B6, or B7/B8 with an int8/fp8 wire installed
by `Session.set_compression`).  One process is one rank with one card,
the rule the JAX bridge checks as one device per worker.

A cluster of one is the identity (a copy), as in the reference at np=1.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import torch

__all__ = [
    "all_reduce",
    "all_gather",
    "broadcast",
    "broadcast_parameters",
    "SynchronousSGDOptimizer",
    "cluster_size",
    "rank",
]


def _peer():
    from ..peer import default_peer

    return default_peer()


def _session():
    return _peer().current_session()


def rank() -> int:
    return _peer().rank


def cluster_size() -> int:
    return _peer().size


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Sum (or min, max, mean, prod) across the cluster (reference all_reduce_cpu)."""
    if cluster_size() == 1:
        return t.clone()
    return _session().all_reduce(t.detach(), op=op)


def broadcast(t: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Everyone adopts `root`'s tensor (reference broadcast_cuda_async)."""
    if cluster_size() == 1:
        return t.clone()
    return _session().broadcast(t.detach(), root=root)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every worker's tensor stacked along a new dim 0 (reference all_gather_cpu)."""
    if cluster_size() == 1:
        return t.clone().unsqueeze(0)
    return _session().all_gather(t.detach())


def broadcast_parameters(state_dict: Dict[str, "torch.Tensor"], root: int = 0) -> None:
    """In-place broadcast of a model/optimizer state dict from `root`
    (reference torch/ops/collective.py:42-48 broadcast_parameters)."""
    for name, value in sorted(state_dict.items()):
        if isinstance(value, torch.Tensor) and value.numel() > 0:
            synced = broadcast(value, root=root)
            value.detach().copy_(synced)


class SynchronousSGDOptimizer:
    """S-SGD wrapper for any torch optimizer: every gradient all-reduced,
    then divided by the cluster size, before the inner step (reference
    torch/optimizers/sync_sgd.py:6-33; one `all_reduce` a gradient, as the
    JAX bridge does).  Each step takes the route of the strategy and wire
    the Session holds then, so `set_strategy` and `set_compression` swap
    it between steps; `optimizers.sync.SynchronousSGDOptimizer`, the
    trainers' bucketed and compressed S-SGD, fixes its schedule when it is
    built.  Both take their routes from the Session's one table.

    Usage::

        opt = kungfu_tpu_torch.torch.SynchronousSGDOptimizer(torch.optim.SGD(...))
        kungfu_tpu_torch.torch.broadcast_parameters(model.state_dict())
        loss.backward(); opt.step(); opt.zero_grad()
    """

    def __init__(self, optimizer):
        self.inner = optimizer
        self._np = cluster_size()

    @property
    def param_groups(self) -> List[dict]:
        return self.inner.param_groups

    def _params(self) -> Iterable:
        for group in self.inner.param_groups:
            yield from group["params"]

    def _sync_gradients(self) -> None:
        if self._np <= 1:
            return
        for p in self._params():
            if p.grad is not None:
                p.grad.detach().copy_(all_reduce(p.grad) / self._np)

    def step(self, closure=None):
        self._sync_gradients()
        return self.inner.step(closure)

    def zero_grad(self, *a, **kw):
        return self.inner.zero_grad(*a, **kw)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, sd):
        return self.inner.load_state_dict(sd)
