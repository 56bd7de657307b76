"""Data-parallel trainer (counterpart of kungfu_tpu.train).

One process per rank, each holding the whole model (replicated mode, the
S-SGD family): every rank computes its batch shard's gradients, the
distributed optimizer (`optimizers.synchronous_sgd`) averages them over
the process group and applies the same update everywhere, so the
replicas stay identical.  `distributed.init_distributed` brings the group
up from the KungFu env; without a group the world is this process alone.

`per_replica_params` (SMA, gossip) waits for a later slice and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .compat import resolve_device


@dataclasses.dataclass
class TrainState:
    params: nn.Module  # the model, which holds the parameters
    opt_state: Any  # the distributed optimizer built over its parameters
    step: int = 0
    # non-trainable state threaded through the step when has_aux=True
    model_state: Any = None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class DataParallelTrainer:
    """Runs `loss_fn` + a distributed optimizer as the training step.

    Args:
      loss_fn: (model, batch) -> scalar loss for this rank's batch shard.
      tx: optimizer factory, params -> optimizer (e.g.
        `synchronous_sgd(adamw(...))`); its step reduces the gradients.
      group: the process group the gradients average over (default group).
      has_aux: loss_fn is (model, model_state, batch) -> (loss,
        new_model_state); floating tensors of the new state are averaged
        over the group each step.
      accum_steps: split the batch's leading dim into this many
        micro-batches, sum their gradients and apply their mean once.
      device: where the model and batches live ("cuda" unless "cpu").
    """

    def __init__(self, loss_fn: Callable, tx: Callable, group=None,
                 per_replica_params: bool = False, has_aux: bool = False,
                 accum_steps: int = 1, device=None):
        if per_replica_params:
            raise NotImplementedError(
                "per_replica_params (SMA/gossip) is not ported yet (see ROADMAP.md)")
        self.loss_fn = loss_fn
        self.tx = tx
        self.group = group
        self.has_aux = has_aux
        self.accum_steps = accum_steps
        self.device = resolve_device(device)

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group) if dist.is_initialized() else 1

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.world > 1:
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
            x /= self.world
        return x

    def init(self, model: nn.Module, model_state: Any = None) -> TrainState:
        """Place the model on the trainer's device, start every rank from
        rank 0's parameters (KungFu's broadcast-at-init) and build the
        optimizer over them."""
        if self.has_aux and model_state is None:
            raise ValueError("has_aux=True requires model_state at init")
        model.to(self.device)
        if self.world > 1:
            src = dist.get_global_rank(self.group, 0) if self.group is not None else 0
            with torch.no_grad():
                for p in model.parameters():
                    dist.broadcast(p.data, src=src, group=self.group)
        model_state = _tree_map(lambda x: x.to(self.device), model_state)
        return TrainState(params=model, opt_state=self.tx(model.parameters()),
                          model_state=model_state)

    def shard_batch(self, batch: Any) -> Any:
        """Place this rank's batch shard on the trainer's device."""
        return _tree_map(lambda x: x.to(self.device, non_blocking=True), batch)

    def _loss(self, model, model_state, batch):
        if self.has_aux:
            return self.loss_fn(model, model_state, batch)
        return self.loss_fn(model, batch), model_state

    def train_step(self, state: TrainState, batch: Any) -> Tuple[TrainState, Dict]:
        model, opt = state.params, state.opt_state
        opt.zero_grad()
        ms = state.model_state
        if self.accum_steps > 1:
            a = self.accum_steps

            def split(x):
                if x.shape[0] % a:
                    raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                     f"accum_steps={a}")
                return x.reshape((a, x.shape[0] // a) + tuple(x.shape[1:]))

            micro = _tree_map(split, batch)
            loss_sum = torch.zeros((), device=self.device)
            for i in range(a):
                loss, ms = self._loss(model, ms, _tree_map(lambda x: x[i], micro))
                loss.backward()
                loss_sum += loss.detach().float()
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(1.0 / a)
            loss = loss_sum / a
        else:
            loss, ms = self._loss(model, ms, batch)
            loss.backward()
            loss = loss.detach()
        if self.has_aux:
            ms = _tree_map(lambda x: self._mean(x) if x.is_floating_point() else x, ms)
        opt.step()
        metrics = {"loss": self._mean(loss.float())}
        return TrainState(model, opt, state.step + 1, ms), metrics

    def train_steps(self, state: TrainState, batch: Any, n: int) -> Tuple[TrainState, Dict]:
        """`n` steps on one device-resident batch; metrics of the last."""
        metrics: Dict = {}
        for _ in range(n):
            state, metrics = self.train_step(state, batch)
        return state, metrics

    def eval_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The model's parameters (every replica holds the same)."""
        return {k: v.detach() for k, v in state.params.state_dict().items()}
