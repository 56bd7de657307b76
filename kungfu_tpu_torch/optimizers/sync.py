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

`compression` selects the gradient wire format (kungfu_tpu_torch.compression):
a CompressionConfig or registered name ("int8", "fp8", "bf16", "int8-sr"),
or a {axis: config} dict over the data-parallel axis "dp".  Quantized
configs with error_feedback=True keep an f32 residual per gradient
(compression.error_feedback, in place: correct_, residual_update_): each
step reduces g + e, casts the result back to the gradient's dtype, and
keeps e' = (g + e) - roundtrip(g + e), per gradient, whatever the buckets
(on the card one `ef_residual` kernel launch per gradient).  Under impl="pallas_ring" int8/fp8 run
through the fused-codec ring kernels B7/B8
(ops.ring_collectives.fused_ring_all_reduce), which take no stochastic or
sparse config; under pmean, ring and rs_ag compression goes through
compression.all_reduce.  `seed` seeds the generator of stochastic rounding.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from .. import compression as Comp
from ..ops import collective as C
from ..ops import peer_memory, ring_collectives

BucketBytes = Union[int, str, None]
DP_AXIS = "dp"  # the axis name a per-axis compression dict may use for the group


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _mean_reducer(group, impl: str, op: str = "mean") -> Callable[[torch.Tensor], None]:
    """In-place gradient mean (op "mean") or sum (op "sum") over the
    group, by the named implementation."""
    if op not in ("mean", "sum"):
        raise ValueError(f"op must be 'mean' or 'sum', got {op!r}")
    average = op == "mean"
    if impl == "pmean":
        def reduce(flat: torch.Tensor) -> None:
            world = _world(group)
            if world > 1:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
                if average:
                    flat.div_(world)

        return reduce

    def times(x: torch.Tensor) -> torch.Tensor:  # the lax rings' sum times 1/n
        return x.mul_(1.0 / _world(group)) if average else x

    rings = {
        "pallas_ring": lambda g: ring_collectives.ring_all_reduce(g, group, op=op),
        "ring": lambda g: times(C.ring_all_reduce(g, group)),
        "rs_ag": lambda g: times(C.rs_ag_all_reduce(g, group)),
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


class CompressedGradState(NamedTuple):
    """What the compressed reduction carries from step to step: the EF
    residuals (one f32 tensor per gradient) and the generator of
    stochastic rounding."""

    ef: Comp.EFState
    generator: torch.Generator


def _compressed_reducer(group, impl: str, compression: Comp.AxisCompression):
    """(reduce(flat) -> the mean of flat over the group, the config whose
    error the residual tracks) for the selected schedule."""
    if impl == "hierarchical":
        raise NotImplementedError(
            "impl='hierarchical' needs (dcn, ici) groups, not ported yet (ROADMAP A4)")
    if impl not in ("pmean", "pallas_ring", "ring", "rs_ag"):
        raise ValueError(f"unknown reduce impl {impl!r}")
    cfg = Comp.resolve_for_axis(compression, DP_AXIS)
    if impl == "pallas_ring":
        ring_collectives.require_fused_kernel(cfg, "mean")  # refuse at construction, not in a step

        def reduce(flat, generator):
            return ring_collectives.fused_ring_all_reduce(flat, group, cfg, op="mean")
    else:
        def reduce(flat, generator):
            return Comp.all_reduce(flat, group, cfg, op="mean", generator=generator)
    return reduce, cfg


def _compressed_all_reduce_gradients(grads: List[torch.Tensor], group, impl: str,
                                     compression: Comp.AxisCompression, bucket_bytes,
                                     state: CompressedGradState) -> CompressedGradState:
    """The compressed mean of `grads` in place; returns the next state."""
    reduce, cfg = _compressed_reducer(group, impl, compression)
    use_ef = cfg.error_feedback and cfg.scheme != "none"
    # in place: the residuals' memory holds g + e, then the new residual
    # (one f32 copy of the gradients, not three)
    corrected = Comp.error_feedback.correct_(grads, state.ef) if use_ef else grads
    bb = _resolve_bucket_bytes(bucket_bytes)
    for idxs in (_pack_buckets(corrected, bb) if bb else [[i] for i in range(len(corrected))]):
        out = reduce(torch.cat([corrected[i].reshape(-1) for i in idxs]), state.generator)
        off = 0
        for i in idxs:
            n = grads[i].numel()
            grads[i].copy_(out[off:off + n].view_as(grads[i]))  # in the gradient's dtype
            off += n
    peer_memory.check_all()  # a ring or shift kernel that gave up on a peer raises here
    if use_ef:
        Comp.error_feedback.residual_update_(corrected, cfg, state.generator)
    return state


def init_compressed_state(grads: Iterable[torch.Tensor], seed: int = 0) -> CompressedGradState:
    """Zero residuals shaped like `grads` and a generator seeded `seed`."""
    grads = list(grads)
    device = grads[0].device if grads else torch.device("cpu")
    return CompressedGradState(Comp.error_feedback.init(grads),
                               torch.Generator(device=device).manual_seed(seed))


def all_reduce_gradients(params: Iterable[torch.nn.Parameter], group=None,
                         impl: str = "pmean", bucket_bytes: BucketBytes = None,
                         compression: Comp.AxisCompression = None, seed: int = 0,
                         state: Optional[CompressedGradState] = None, op: str = "mean"
                         ) -> Optional[CompressedGradState]:
    """Average every parameter's `.grad` over the group, in place: the core
    of S-SGD.  Parameters without a gradient are skipped.  op="sum" sums
    them instead (`trainer.MeshTrainer`, where each rank's loss is already
    its share of the global mean); compression takes the mean only.

    With `compression`, the reduction moves that wire format and keeps
    state from step to step: pass the state the previous call returned
    (None at the first step: zero residuals, a generator seeded `seed`);
    the new state is returned.  Without it, None is returned."""
    Comp.validate_axis_keys(compression, (DP_AXIS,), context="all_reduce_gradients")
    grads = [p.grad for p in params if p.grad is not None]
    if compression is not None:
        if op != "mean":
            raise NotImplementedError("compressed gradient reduction takes op='mean' only")
        if state is None:
            state = init_compressed_state(grads, seed)
        return _compressed_all_reduce_gradients(grads, group, impl, compression,
                                                bucket_bytes, state)
    reduce = _mean_reducer(group, impl, op)
    if _world(group) == 1:
        return None
    bb = _resolve_bucket_bytes(bucket_bytes)
    if bb:
        _bucketed_reduce(grads, _pack_buckets(grads, bb), reduce)
    else:
        for g in grads:
            reduce(g)
    peer_memory.check_all()  # a ring or shift kernel that gave up on a peer raises here
    return None


class SynchronousSGDOptimizer:
    """An inner torch optimizer whose step first averages the gradients
    (compressed, with its residuals kept here, when `compression` is set)."""

    def __init__(self, inner: torch.optim.Optimizer, group=None,
                 impl: str = "pmean", bucket_bytes: BucketBytes = None,
                 compression: Comp.AxisCompression = None, seed: int = 0):
        Comp.validate_axis_keys(compression, (DP_AXIS,), context="SynchronousSGDOptimizer")
        self.inner = inner
        self.group = group
        self.impl = impl
        self.bucket_bytes = bucket_bytes
        self.compression = compression
        self.seed = seed
        self.state: Optional[CompressedGradState] = None

    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def step(self) -> None:
        self.state = all_reduce_gradients(self.params(), self.group, self.impl,
                                          self.bucket_bytes, self.compression, self.seed,
                                          self.state)
        self.inner.step()

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def synchronous_sgd(inner: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
                    group: Optional[dist.ProcessGroup] = None, impl: str = "pmean",
                    bucket_bytes: BucketBytes = None,
                    compression: Comp.AxisCompression = None, seed: int = 0
                    ) -> Callable[[Iterable[torch.nn.Parameter]], SynchronousSGDOptimizer]:
    """SynchronousSGDOptimizer factory: `inner(params)` builds the inner
    optimizer (e.g. `adamw(...)`); every step averages gradients over
    `group` (the default group when None) before it, compressed as
    `compression` says.  An unported `impl` or `bucket_bytes`, a per-axis
    key that names no axis, or a compression the impl cannot run raises
    here, not at the first step."""
    Comp.validate_axis_keys(compression, (DP_AXIS,), context="synchronous_sgd")
    if compression is None:
        _mean_reducer(group, impl)
    else:
        _compressed_reducer(group, impl, compression)
    _resolve_bucket_bytes(bucket_bytes)

    def make(params: Iterable[torch.nn.Parameter]) -> SynchronousSGDOptimizer:
        return SynchronousSGDOptimizer(inner(params), group, impl, bucket_bytes, compression,
                                       seed)

    return make
