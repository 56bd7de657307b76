"""MeshTrainer: training over a dp x sp rank mesh (counterpart of
kungfu_tpu/trainer.py).

In the JAX package the step is one program over the mesh and XLA inserts
every collective.  Here each rank is one process holding the whole model
(parameters are replicated over both axes) and one shard of the batch:

  dp  each data-parallel index takes its rows of the batch
  sp  each sequence-parallel index takes its chunk of every sequence;
      the model (TransformerConfig(attention="ring" or "ulysses",
      mesh=mesh)) runs ring or Ulysses attention over the sp group and
      starts its positions at the chunk's absolute offset

`shard_batch` cuts this rank's `SeqShard` from the global token batch:
its tokens, each position's next token as target (the one that crosses
into the next chunk included; -1 past the end of a sequence), and the
global count of targets.  `loss_fn(model, shard)` returns this rank's
share of the global mean, e.g.
`lm_loss_shard(model(shard.tokens), shard.targets, shard.count)`, or for
a model with head="hidden" `lm_loss_shard_chunked(model, shard.tokens,
shard.targets, shard.count)` (the head streamed over vocab blocks,
`ops.chunked_ce`), so the shares sum to the global loss and their
gradients to its gradient: after the backward the gradients are summed
(not averaged) over every rank of the mesh, the counterpart of the psum
XLA inserts, through
`optimizers.sync.all_reduce_gradients(op="sum")` with its `impl` and
`bucket_bytes` ("pallas_ring": the ring kernels B5/B6, which also run
where ranks share a card; "pmean": torch.distributed).  Then every rank
applies the same update with its plain torch.optim optimizer (`tx`,
params -> optimizer), so the replicas stay identical.  The reported loss
is the sum of the shares over the ranks.

A loss that takes a third positional argument, (model, shard,
generator), gets a fresh torch.Generator each step on the trainer's
device, seeded from the trainer's `seed`, the step and this rank's place
in the mesh: dropout under train=True draws its masks from it, the masks
differ from step to step and from shard to shard (as slices of the JAX
trainer's one global mask do; `jax.random`'s bits are not reproduced), and
a restart at the same step draws the same ones.  The replicas stay
identical: they sum the same gradients.

The JAX trainer's other axes (tp, ep, pp) and its rules table are not
ported (ROADMAP.md A.6).  A mesh with an fsdp axis trains with
`fsdp.FSDPTrainer`.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .optimizers.sync import BucketBytes, all_reduce_gradients
from .plan.mesh import Mesh
from .train import DataParallelTrainer, TrainState


_MIX = 1_000_003  # an odd multiplier folding (seed, step, shard) into one seed


def _required_positionals(fn: Callable) -> int:
    """fn's positional parameters without a default (optional ones do not
    change how it is called)."""
    return sum(1 for p in inspect.signature(fn).parameters.values()
               if p.default is inspect.Parameter.empty
               and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))


@dataclasses.dataclass
class SeqShard:
    """This rank's piece of a token batch."""

    tokens: torch.Tensor  # [B / dp, L / sp] inputs
    targets: torch.Tensor  # [B / dp, L / sp] next tokens, -1 past a sequence's end
    count: int  # next-token targets of the whole batch, B * (L - 1)


def _local_shard(tokens: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inputs, targets) of this rank: its dp rows, its sp chunk, and the
    targets one position on (the last chunk ends with -1)."""
    B, L = tokens.shape
    dp, sp = mesh.shape.get("dp", 1), mesh.shape.get("sp", 1)
    if B % dp or L % sp:
        raise ValueError(f"batch {B} x {L} does not split over dp={dp} x sp={sp}")
    rows, chunk = B // dp, L // sp
    r0, c0 = mesh.coord("dp") * rows, mesh.coord("sp") * chunk
    mine = tokens[r0:r0 + rows]
    ends = torch.full((rows, 1), -1, dtype=tokens.dtype, device=tokens.device)
    targets = torch.cat([mine[:, 1:], ends], dim=1)[:, c0:c0 + chunk]
    return mine[:, c0:c0 + chunk], targets


class MeshTrainer(DataParallelTrainer):
    """Trainer over a dp x sp mesh of ranks: `DataParallelTrainer`'s `init`,
    `train_steps` and `eval_params` over the whole world, with its own
    batch sharding and gradient sum.

    Args:
      loss_fn: (model, shard) -> this rank's share of the global loss.
      tx: optimizer factory, params -> torch.optim optimizer (plain: the
        trainer sums the gradients itself).
      mesh: the rank mesh; it must cover every rank of the process group.
      impl, bucket_bytes: how `all_reduce_gradients` sums the gradients.
      device: where the model and batches live ("cuda" unless "cpu").
      seed: the per-step loss generators' seed (a loss that takes one).
    """

    def __init__(self, loss_fn: Callable[..., torch.Tensor], tx: Callable, mesh: Mesh,
                 impl: str = "pmean", bucket_bytes: BucketBytes = None, device=None,
                 seed: int = 0):
        super().__init__(loss_fn, tx, device=device)
        self.mesh = mesh
        self.impl = impl
        self.bucket_bytes = bucket_bytes
        self.seed = seed
        self._loss_takes_rng = loss_fn is not None and _required_positionals(loss_fn) >= 3
        if self.mesh.shape.get("fsdp", 1) > 1:
            raise ValueError("MeshTrainer replicates the model: a mesh with an fsdp axis "
                             "trains with fsdp.FSDPTrainer")
        if self.mesh.size != self.world:
            raise ValueError(f"mesh {self.mesh.shape} does not cover the {self.world} ranks")

    def step_generator(self, step: int) -> torch.Generator:
        """The loss generator of `step` on this rank: seeded from the
        trainer's seed, the step and this rank's shard (its mesh rank)."""
        seed = ((self.seed * _MIX + step) * _MIX + self.mesh.rank) % 2**63
        return torch.Generator(device=self.device).manual_seed(seed)

    def shard_batch(self, tokens: torch.Tensor) -> SeqShard:
        """This rank's `SeqShard` of the global [B, L] token batch, on the
        trainer's device."""
        inputs, targets = _local_shard(tokens, self.mesh)
        B, L = tokens.shape
        return SeqShard(inputs.to(self.device), targets.to(self.device), B * (L - 1))

    def train_step(self, state: TrainState, batch: SeqShard) -> Tuple[TrainState, Dict]:
        model, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        if self._loss_takes_rng:
            loss = self.loss_fn(model, batch, self.step_generator(state.step))
        else:
            loss = self.loss_fn(model, batch)
        loss.backward()
        # also raises the error of a shift or ring kernel that gave up
        all_reduce_gradients(model.parameters(), None, self.impl, self.bucket_bytes, op="sum")
        opt.step()
        loss = loss.detach().float().clone()
        if self.world > 1:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM)
        return TrainState(model, opt, state.step + 1), {"loss": loss}
