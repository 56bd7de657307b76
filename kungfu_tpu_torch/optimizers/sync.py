"""Synchronous SGD: average gradients over the group, then step the inner
optimizer (counterpart of kungfu_tpu.optimizers.sync).

The JAX package composes optax transforms inside the compiled step.  Here
the inner optimizer is a `torch.optim` one, and the wrapper averages each
parameter's `.grad` in place before the inner step, so every rank applies
the same update and the replicas stay identical.

    tx = synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl="pallas_ring",
                         bucket_bytes=4 << 20)
    opt = tx(model.parameters())
    loss.backward(); opt.step()

`impl` names the schedule, as in the JAX package:

  pmean        dist.all_reduce(SUM) / world (NCCL or gloo pick the order)
  pallas_ring  the hand-written ring kernels B5 + B6
               (ops.ring_collectives.ring_all_reduce(g, op="mean")); a CPU
               gradient runs their plain ring over the process group
  ring         the lax ring of ops/collective.py, times 1/world
  rs_ag        reduce-scatter + all-gather of ops/collective.py, times 1/world

`bucket_bytes` packs consecutive same-dtype gradients into flat buffers of
at most that size and reduces each buffer with one collective.  The pmean
is element-wise, so bucketed and unbucketed results are identical; the
rings chunk the buffer they are given, so bucketing moves chunk
boundaries and with them the order of some adds.  `bucket_bytes="auto"`
(the tuner) and impl="hierarchical" are not ported yet and raise.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

from ..ops import collective as C
from ..ops import peer_memory, ring_collectives

BucketBytes = Union[int, str, None]


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _mean_reducer(group, impl: str) -> Callable[[torch.Tensor], None]:
    """In-place gradient mean over the group, by the named implementation."""
    if impl == "pmean":
        def reduce(flat: torch.Tensor) -> None:
            world = _world(group)
            if world > 1:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
                flat.div_(world)

        return reduce
    rings = {
        "pallas_ring": lambda g: ring_collectives.ring_all_reduce(g, group, op="mean"),
        "ring": lambda g: C.ring_all_reduce(g, group).mul_(1.0 / _world(group)),
        "rs_ag": lambda g: C.rs_ag_all_reduce(g, group).mul_(1.0 / _world(group)),
    }
    if impl in rings:
        mean = rings[impl]

        def reduce(flat: torch.Tensor) -> None:
            if _world(group) > 1:
                flat.copy_(mean(flat))

        return reduce
    if impl == "hierarchical":
        raise NotImplementedError(
            "impl='hierarchical' needs (dcn, ici) groups, not ported yet (ROADMAP A4)")
    raise ValueError(f"unknown reduce impl {impl!r}")


def _resolve_bucket_bytes(bucket_bytes: BucketBytes) -> int:
    """The bucket size the sync runs with (0 = one collective per leaf)."""
    if bucket_bytes == "auto":
        raise NotImplementedError(
            "bucket_bytes='auto' needs the compute tuner, not ported yet")
    return int(bucket_bytes) if bucket_bytes else 0


def _pack_buckets(leaves, bucket_bytes: int) -> List[List[int]]:
    """Greedy in-order packing of leaf indices: consecutive same-dtype
    leaves up to `bucket_bytes` each (an oversized leaf gets its own)."""
    buckets, cur, cur_bytes, cur_dtype = [], [], 0, None
    for i, g in enumerate(leaves):
        b = g.numel() * g.element_size()
        if cur and (g.dtype != cur_dtype or cur_bytes + b > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
        cur_dtype = g.dtype
    if cur:
        buckets.append(cur)
    return buckets


def _bucketed_reduce(leaves, buckets, reduce_flat) -> None:
    """Reduce each bucket's concatenated leaves in place; single-leaf
    buckets reduce the leaf itself."""
    for idxs in buckets:
        if len(idxs) == 1:
            reduce_flat(leaves[idxs[0]])
            continue
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        reduce_flat(flat)
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            leaves[i].copy_(flat[off:off + n].view_as(leaves[i]))
            off += n


def all_reduce_gradients(params: Iterable[torch.nn.Parameter], group=None,
                         impl: str = "pmean", bucket_bytes: BucketBytes = None) -> None:
    """Average every parameter's `.grad` over the group, in place: the core
    of S-SGD.  Parameters without a gradient are skipped."""
    reduce = _mean_reducer(group, impl)
    grads = [p.grad for p in params if p.grad is not None]
    if _world(group) == 1:
        return
    bb = _resolve_bucket_bytes(bucket_bytes)
    if bb:
        _bucketed_reduce(grads, _pack_buckets(grads, bb), reduce)
    else:
        for g in grads:
            reduce(g)
    if impl == "pallas_ring":
        peer_memory.check_all()  # a ring kernel that gave up on a peer raises here


class SynchronousSGDOptimizer:
    """An inner torch optimizer whose step first averages the gradients."""

    def __init__(self, inner: torch.optim.Optimizer, group=None,
                 impl: str = "pmean", bucket_bytes: BucketBytes = None):
        self.inner = inner
        self.group = group
        self.impl = impl
        self.bucket_bytes = bucket_bytes

    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def step(self) -> None:
        all_reduce_gradients(self.params(), self.group, self.impl, self.bucket_bytes)
        self.inner.step()

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def synchronous_sgd(inner: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
                    group: Optional[dist.ProcessGroup] = None, impl: str = "pmean",
                    bucket_bytes: BucketBytes = None
                    ) -> Callable[[Iterable[torch.nn.Parameter]], SynchronousSGDOptimizer]:
    """SynchronousSGDOptimizer factory: `inner(params)` builds the inner
    optimizer (e.g. `adamw(...)`); every step averages gradients over
    `group` (the default group when None) before it.  An unported `impl`
    or `bucket_bytes` raises here, not at the first step."""
    _mean_reducer(group, impl)
    _resolve_bucket_bytes(bucket_bytes)

    def make(params: Iterable[torch.nn.Parameter]) -> SynchronousSGDOptimizer:
        return SynchronousSGDOptimizer(inner(params), group, impl, bucket_bytes)

    return make
