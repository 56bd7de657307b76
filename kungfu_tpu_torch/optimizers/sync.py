"""Synchronous SGD and SMA over the group (counterpart of
kungfu_tpu.optimizers.sync).

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
  hierarchical reduce-scatter within the host, all-reduce across hosts,
               all-gather within the host (ops.collective.
               hierarchical_all_reduce), times 1/world; `group` is then a
               ("dcn", "ici") mesh (plan.make_hierarchical_mesh), as the
               JAX package takes axis_name=(dcn, ici)

`bucket_bytes` packs consecutive same-dtype gradients into flat buffers of
at most that size and reduces each buffer with one collective.  The pmean
is element-wise, so bucketed and unbucketed results are identical; the
rings chunk the buffer they are given, so bucketing moves chunk
boundaries and with them the order of some adds.  `bucket_bytes="auto"`
(the tuner) is not ported yet and raises.

`compression` selects the gradient wire format (kungfu_tpu_torch.compression):
a CompressionConfig or registered name ("int8", "fp8", "bf16", "int8-sr"),
or a {axis: config} dict over the data-parallel axis "dp" (under
impl="hierarchical" over "dcn" and "ici": {"dcn": "int8"} quantizes the
cross-host leg alone, `compression.hierarchical_all_reduce`).  Quantized
configs with error_feedback=True keep an f32 residual per gradient
(compression.error_feedback, in place: correct_, residual_update_): each
step reduces g + e, casts the result back to the gradient's dtype, and
keeps e' = (g + e) - roundtrip(g + e), per gradient, whatever the buckets
(on the card one `ef_residual` kernel launch per gradient).  Under impl="pallas_ring" int8/fp8 run
through the fused-codec ring kernels B7/B8
(ops.ring_collectives.fused_ring_all_reduce), which take no stochastic or
sparse config; under pmean, ring and rs_ag compression goes through
compression.all_reduce.  `seed` seeds the generator of stochastic rounding.

`synchronous_averaging` (SMA) pulls each rank's parameters toward the
group's average and steps the inner optimizer on the local gradients;
`OptimizerWrapper` is the base of every wrapper here and in `monitor.py`,
`adaptive.py` and `presets.py`.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable, List, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from .. import compression as Comp
from ..ops import peer_memory, ring_collectives
from ..plan.mesh import Mesh
from ..plan.strategy import Impl
from ..session import KERNEL_ROUTES, all_reduce_route, run_route

BucketBytes = Union[int, str, None]
DP_AXIS = "dp"  # the axis name a per-axis compression dict may use for the group
HIER_AXES = ("dcn", "ici")  # impl="hierarchical": the mesh's axes, outer first


def _world(group) -> int:
    if isinstance(group, Mesh):
        return group.size
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _axes(impl: str):
    """The axis names a per-axis compression dict may use under `impl`."""
    return HIER_AXES if impl == "hierarchical" else (DP_AXIS,)


def _hier_mesh(group) -> Mesh:
    """The group as a hierarchical mesh; raises for anything else."""
    if not (isinstance(group, Mesh) and group.axis_names == HIER_AXES):
        raise ValueError("hierarchical reduction needs a ('dcn', 'ici') mesh "
                         f"(plan.make_hierarchical_mesh) as its group, got {group!r}")
    return group


#: impl= names (the JAX package's) -> the Impl whose route the Session's
#: table (session.all_reduce_route) gives each reduction
IMPLS = {"pmean": Impl.PSUM, "pallas_ring": Impl.PALLAS_RING, "ring": Impl.RING,
         "rs_ag": Impl.RS_AG, "hierarchical": Impl.HIERARCHICAL}


def _impl(impl: str) -> Impl:
    if impl not in IMPLS:
        raise ValueError(f"unknown reduce impl {impl!r}")
    return IMPLS[impl]


def _mean_reducer(group, impl: str, op: str = "mean") -> Callable[[torch.Tensor], None]:
    """In-place gradient mean (op "mean") or sum (op "sum") over the
    group, by the named implementation: the Session's route for its Impl.
    A ring kernel takes the mean itself; every other route sums, and the
    mean is taken here, as the JAX package's pmean (/ n) and rings (* 1/n)
    take it."""
    if op not in ("mean", "sum"):
        raise ValueError(f"op must be 'mean' or 'sum', got {op!r}")
    kind = _impl(impl)
    mesh = _hier_mesh(group) if kind is Impl.HIERARCHICAL else None  # refused here, not in a step
    pg = None if mesh is not None else group

    def reduce(flat: torch.Tensor) -> None:
        world = _world(group)
        if world == 1:
            return
        route = all_reduce_route(kind, op, flat.dtype, None, mesh is not None)
        if route in KERNEL_ROUTES:
            flat.copy_(run_route(route, flat, pg, op))
            return
        flat.copy_(run_route(all_reduce_route(kind, "sum", flat.dtype, None, mesh is not None),
                             flat, pg, "sum", mesh=mesh))
        if op == "mean" and kind is Impl.PSUM:
            flat.div_(world)
        elif op == "mean":
            flat.mul_(1.0 / world)

    return reduce


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
    """(reduce(flat, generator) -> the mean of flat over the group, the
    config whose error the residual tracks): the Session's route for the
    Impl and the wire."""
    kind = _impl(impl)
    if kind is Impl.HIERARCHICAL:
        mesh = _hier_mesh(group)
        ici_cfg = Comp.resolve_for_axis(compression, "ici")
        dcn_cfg = Comp.resolve_for_axis(compression, "dcn")
        cfg = Comp.AxisConfig.make({"ici": ici_cfg, "dcn": dcn_cfg})
        # the residual tracks the error of the leg that quantizes first
        ef_cfg = ici_cfg if ici_cfg.is_quantized else dcn_cfg
        route = all_reduce_route(kind, "mean", torch.float32, cfg, True)

        def reduce(flat, generator):
            return run_route(route, flat, None, "mean", cfg, mesh=mesh, generator=generator)

        return reduce, ef_cfg
    cfg = Comp.resolve_for_axis(compression, DP_AXIS)
    if kind is Impl.PALLAS_RING:
        ring_collectives.require_fused_kernel(cfg, "mean")  # refuse at construction, not in a step

    def reduce(flat, generator):
        route = all_reduce_route(kind, "mean", flat.dtype, cfg)
        return run_route(route, flat, group, "mean", cfg, generator=generator)

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
    Comp.validate_axis_keys(compression, _axes(impl), context="all_reduce_gradients")
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


def _save_tree(x):
    """A copy of a wrapper's own state for its state dict: tensors cloned,
    generators as (state, device)."""
    if isinstance(x, torch.Generator):
        return {"generator": x.get_state(), "device": str(x.device)}
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_save_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_save_tree(v) for v in x)
    return x


def _load_tree(x):
    """The state `_save_tree` saved, as fresh tensors and generators."""
    if isinstance(x, dict) and set(x) == {"generator", "device"}:
        gen = torch.Generator(device=x["device"])
        gen.set_state(x["generator"])
        return gen
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_load_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_load_tree(v) for v in x)
    return x


class OptimizerWrapper:
    """An inner optimizer (a `torch.optim` one or another wrapper) whose
    step a distributed algorithm extends.  `state` holds the wrapper's own
    state from step to step (a NamedTuple, or None), the counterpart of its
    optax state in the JAX package; `state_dict` holds it beside the
    inner's."""

    state = None
    #: why this optimizer no longer holds the state from before the step in
    #: flight, or None while it does (a failed step's "live" recovery rung
    #: reads it; the elastic loop clears it after every completed step)
    live_dirty: Optional[str] = None

    def __init_subclass__(cls, **kwargs):
        """Fail safe: every wrapper's step marks it dirty as it begins.  A
        step that changes state in place before its failure point (a pull
        mixed chunk by chunk, a broadcast leaf by leaf) so never hands over
        a torn state as "live"; a step whose failure point comes before any
        in-place write says so by clearing the mark."""
        super().__init_subclass__(**kwargs)
        step = cls.__dict__.get("step")
        if step is None:
            return

        @functools.wraps(step)
        def marked(self, *args, **kw):
            self.live_dirty = f"{cls.__name__}.step began"
            return step(self, *args, **kw)

        cls.step = marked

    def __init__(self, inner, group=None):
        self.inner = inner
        self.group = group

    @property
    def param_groups(self):
        return self.inner.param_groups

    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "state": _save_tree(self.state)}

    def load_state_dict(self, state_dict: dict) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        self.state = _load_tree(state_dict["state"])


class SynchronousSGDOptimizer(OptimizerWrapper):
    """An inner torch optimizer whose step first averages the gradients
    (compressed, with its residuals kept here, when `compression` is set)."""

    def __init__(self, inner, group=None, impl: str = "pmean",
                 bucket_bytes: BucketBytes = None,
                 compression: Comp.AxisCompression = None, seed: int = 0):
        Comp.validate_axis_keys(compression, _axes(impl), context="SynchronousSGDOptimizer")
        super().__init__(inner, group)
        self.impl = impl
        self.bucket_bytes = bucket_bytes
        self.compression = compression
        self.seed = seed
        self.state: Optional[CompressedGradState] = None

    def step(self) -> None:
        if self.compression is not None:
            # the residuals take g + e (and stochastic rounding draws) in
            # place before the reduction can fail
            self.live_dirty = "the compressed reduction changed its state in place"
        else:  # the mean reduction writes only the gradients
            self.live_dirty = None
        self.state = all_reduce_gradients(self.params(), self.group, self.impl,
                                          self.bucket_bytes, self.compression, self.seed,
                                          self.state)
        self.live_dirty = "the optimizer stepped"
        self.inner.step()


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
    Comp.validate_axis_keys(compression, _axes(impl), context="synchronous_sgd")
    if compression is None:
        _mean_reducer(group, impl)
    else:
        _compressed_reducer(group, impl, compression)
    _resolve_bucket_bytes(bucket_bytes)

    def make(params: Iterable[torch.nn.Parameter]) -> SynchronousSGDOptimizer:
        return SynchronousSGDOptimizer(inner(params), group, impl, bucket_bytes, compression,
                                       seed)

    return make


def pmean_(x: torch.Tensor, group=None) -> torch.Tensor:
    """`lax.pmean` in place: the sum over the group times 1/n."""
    world = _world(group)
    if world > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x.mul_(1.0 / world)
    return x


def pull_toward_mean(params: List[torch.Tensor], group, alpha: float) -> List[torch.Tensor]:
    """alpha * (pmean(p) - p) for every parameter, taken before an inner
    step moves p in place (one f32 copy of the parameters)."""
    pulls = []
    with torch.no_grad():
        for p in params:
            pull = pmean_(p.detach().clone(), group)
            pulls.append(pull.sub_(p).mul_(alpha))
    return pulls


class SMAState(NamedTuple):
    step: int  # steps taken


class SynchronousAveragingOptimizer(OptimizerWrapper):
    """SMA: each step pulls every replica toward the group's average
    parameters and applies its own local gradients."""

    def __init__(self, inner, group=None, alpha: float = 0.1):
        super().__init__(inner, group)
        self.alpha = alpha
        self.state = SMAState(step=0)

    def step(self) -> None:
        params = self.params()
        self.live_dirty = None  # the pulls are taken from copies
        pulls = pull_toward_mean(params, self.group, self.alpha)
        self.live_dirty = "the optimizer stepped"
        self.inner.step()
        with torch.no_grad():
            torch._foreach_add_(params, pulls)
        self.state = SMAState(step=self.state.step + 1)


def synchronous_averaging(inner: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
                          group: Optional[dist.ProcessGroup] = None, alpha: float = 0.1
                          ) -> Callable[[Iterable[torch.nn.Parameter]],
                                        SynchronousAveragingOptimizer]:
    """SynchronousAveragingOptimizer factory (SMA / EA-SGD; reference
    optimizers/sma_sgd.py:46-76): every step each rank pulls its
    parameters toward the group's average, v <- (1 - a) v + a avg(v), and
    applies its *local* gradients through `inner(params)`:

        p <- p + inner's update(local grads) + alpha * (pmean(p) - p)

    The average is of the parameters before the inner step, taken into a
    buffer (one f32 copy of the parameters) before `inner.step()` moves
    them in place and added after it.  The ranks' models differ between
    steps; run it under `DataParallelTrainer(per_replica_params=True)`."""

    def make(params: Iterable[torch.nn.Parameter]) -> SynchronousAveragingOptimizer:
        return SynchronousAveragingOptimizer(inner(params), group, alpha)

    return make
