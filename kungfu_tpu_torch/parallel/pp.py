"""Pipeline parallelism: the GPipe and circular schedules over a process
group (counterpart of kungfu_tpu/parallel/pp.py).

Each rank of the pp group is one stage and holds its layer groups.  The
schedule runs in lockstep ticks: every tick each stage applies one layer
group to the activation it holds, and the activation moves one hop along
the ring, rank s to rank s + 1, through the ring shift kernel B11
(`ops.fused_matmul.ring_shift`, the JAX `lax.ppermute(h, axis, [(i, (i +
1) % S)])`); the shift's backward moves the cotangent one hop back, so the
backward of the pipeline is the reverse pipeline, as `jax.grad` through
the JAX scan gives it.

  GPipe (repeats=1): S groups, one a stage.  M microbatches flow once
  around the ring: M + S - 1 ticks, bubble (S - 1) / (M + S - 1).

  Circular (repeats=R > 1): the model is cut into S R groups; stage s
  holds groups {r S + s : r < R}, one a round.  Microbatch i starts round
  r at stage 0 on tick r M + i: fresh microbatches enter on the first M
  ticks, and an activation that finished round r parks at stage 0 until
  its round-(r + 1) turn.  R M + S - 1 ticks at 1/(S R) of the model each:
  bubble (S - 1) / (R M + S - 1).  Needs M >= S.

The last stage's outputs are summed over the group (zeros elsewhere), so
every stage returns them (`mappings.reduce_from`: what follows is the
same on every stage, and the backward is the identity).  The input
microbatches are the same on every stage and only stage 0 reads them: they
enter through `mappings.copy_to`, so their gradient is summed over the
group and reaches every stage whole.

What this schedule does differently from the JAX scan, with the same
results:

  - a stage skips its layer group on the ticks where it holds no
    microbatch (the bubble; the JAX scan computes them on what it holds
    and never reads the result), so each stage runs R M groups a step;
  - the hop after the last tick is not made (the JAX scan's last carry is
    dropped): R M + S - 2 hops forward and as many backward, one B11 call
    each;
  - every hop's backward must run on every stage in the same order (each
    is a collective): a value a stage drops (the arrival at stage 0 that
    a fresh microbatch replaces, the microbatches on stages > 0, the last
    activation) is tied to what it keeps by `_keep`, whose backward gives
    it a zero cotangent, so each backward hop waits for the next one's.

remat=True checkpoints each layer group (torch.utils.checkpoint): its
forward runs again in the backward.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..ops.fused_matmul import ring_shift
from . import mappings


class _Keep(torch.autograd.Function):
    """`kept` itself; `dropped` join the graph with a zero cotangent."""

    @staticmethod
    def forward(ctx, kept, *dropped):
        ctx.like = [(d.shape, d.dtype, d.device) for d in dropped]
        return kept.view_as(kept)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.like))


def _keep(kept: torch.Tensor, *dropped: torch.Tensor) -> torch.Tensor:
    return _Keep.apply(kept, *dropped) if torch.is_grad_enabled() else kept


def pipeline_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], rounds: Sequence[Any],
                  xs: torch.Tensor, group=None, repeats: int = 1, remat: bool = False
                  ) -> torch.Tensor:
    """This stage's pipeline schedule over the pp process group `group`.

    stage_fn: (round_params, h) -> h', one layer group (h and h' of one
      shape and dtype).
    rounds: this stage's R layer groups' parameters, round by round.
    xs: [M, mb, ...] microbatches, the same on every stage.
    Returns [M, mb, ...]: the last stage's outputs, on every stage."""
    S, stage = mappings.group_size(group), mappings.group_rank(group)
    M, R = xs.shape[0], repeats
    if len(rounds) != R:
        raise ValueError(f"{len(rounds)} layer groups for repeats={R}")
    if R > 1 and M < S:
        raise ValueError(f"circular pipeline needs microbatches >= stages (M={M} < S={S})")
    if remat:
        fn = stage_fn

        def stage_fn(params, h):
            return checkpoint(fn, params, h, use_reentrant=False)

    xs = mappings.copy_to(xs, group)
    micro = xs.unbind(0)
    h = torch.zeros_like(micro[0])
    if torch.is_grad_enabled():  # every hop on every stage joins the graph
        h.requires_grad_()
    store, out = [None] * M, [None] * M
    ticks = R * M + S - 1
    for t in range(ticks):
        work = 0 <= t - stage < R * M  # (microbatch, round) at tick r M + i + stage
        if stage == 0:
            if R > 1 and t >= S:  # park the arrival for its next round (slot (t - S) % M)
                store[(t - S) % M] = h
            if work:
                h = _keep(micro[t] if t < M else store[t % M], h)
        elif t == 0:
            h = _keep(h, xs)
        if work:
            h = stage_fn(rounds[(t - stage) // M], h)
        emit = t - (S - 1) - (R - 1) * M
        if stage == S - 1 and emit >= 0:
            out[emit] = h
        if S > 1 and t < ticks - 1:
            h = ring_shift(h, group, 1)
    contrib = torch.stack(out) if stage == S - 1 else torch.zeros_like(xs)
    return mappings.reduce_from(_keep(contrib, h), group)


def pipeline_apply_grouped(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                           group_params: Any, x: torch.Tensor, mesh, axis_name: str = "pp",
                           repeats: int = 1, remat: bool = False) -> torch.Tensor:
    """Run x through S * repeats pipelined layer groups over the mesh's
    `axis_name` group.  group_params: a pytree of tensors stacked [S, R,
    ...], stage s's round-r group at [s, r] (each stage reads its own);
    x: [M, mb, ...] microbatches.  Returns [M, mb, ...]."""
    group = mesh.group(axis_name) if mesh is not None else None
    stage = mappings.group_rank(group)
    rounds = [pytree.tree_map(lambda p, r=r: p[stage, r], group_params)
              for r in range(repeats)]
    return pipeline_spmd(stage_fn, rounds, x, group, repeats=repeats, remat=remat)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x: torch.Tensor, mesh, axis_name: str = "pp") -> torch.Tensor:
    """GPipe over S = the mesh's `axis_name` size single-group stages.
    stage_params: a pytree of tensors stacked [S, ...]; x: [M, mb, ...]."""
    grouped = pytree.tree_map(lambda p: p[:, None], stage_params)
    return pipeline_apply_grouped(stage_fn, grouped, x, mesh, axis_name=axis_name, repeats=1)


def stack_stage_params(params_list) -> Any:
    """Stack per-stage pytrees into the [S, ...] layout `pipeline_apply` takes."""
    flat = [pytree.tree_flatten(p) for p in params_list]
    spec = flat[0][1]
    return pytree.tree_unflatten([torch.stack(xs) for xs in zip(*(f[0] for f in flat))], spec)


def stack_group_params(params_lists) -> Any:
    """Stack an [S][R] nested list of group pytrees into [S, R, ...] leaves."""
    return stack_stage_params([stack_stage_params(rounds) for rounds in params_lists])
