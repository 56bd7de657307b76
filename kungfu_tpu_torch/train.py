"""Data-parallel trainer (counterpart of kungfu_tpu.train).

One process per rank, each holding the whole model; every rank computes
its batch shard's gradients and the distributed optimizer
(`optimizers.*`) reduces them over the process group inside its step.
`distributed.init_distributed` brings the group up from the KungFu env;
without a group the world is this process alone.  Two parameter modes,
matching the optimizer families:

  replicated   (S-SGD): every rank applies the same averaged update, so the
               replicas stay identical; model_state's floating tensors are
               averaged over the group each step.
  per_replica  (SMA, AdaptiveSGD before its switch): each rank owns its
               model, the reference's "every worker has its own model";
               model_state is each rank's own.  The JAX package stacks the
               replicas on a leading device dim; here each process holds
               its own, as in its multi-controller mode, so `eval_params`
               and `eval_model_state` read this rank's replica only.

Both start every rank from rank 0's parameters (`init`, `place_state`).
`fit` drives `train_step` over a data iterator with policies
(`policy.PolicyRunner`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .compat import resolve_device
from .initializer import broadcast_params
from .utils import get_logger

log = get_logger("kungfu.train")


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


def _first_tensor(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next(t for t in (_first_tensor(v) for v in tree) if t is not None)
    return tree if isinstance(tree, torch.Tensor) else None


class DataParallelTrainer:
    """Runs `loss_fn` + a distributed optimizer as the training step.

    Args:
      loss_fn: (model, batch) -> scalar loss for this rank's batch shard.
      tx: optimizer factory, params -> optimizer (e.g.
        `synchronous_sgd(adamw(...))`); its step reduces the gradients.
      group: the process group the gradients average over (default group).
      per_replica_params: see the module docstring.
      has_aux: loss_fn is (model, model_state, batch) -> (loss,
        new_model_state); in replicated mode floating tensors of the new
        state are averaged over the group each step.
      accum_steps: split the batch's leading dim into this many
        micro-batches, sum their gradients and apply their mean once.
      device: where the model and batches live ("cuda" unless "cpu").
    """

    def __init__(self, loss_fn: Callable, tx: Callable, group=None,
                 per_replica_params: bool = False, has_aux: bool = False,
                 accum_steps: int = 1, device=None):
        self.loss_fn = loss_fn
        self.tx = tx
        self.group = group
        self.per_replica = per_replica_params
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
        rank 0's parameters (KungFu's broadcast-at-init, reference
        initializer/__init__.py:13-99) and build the optimizer over them."""
        return self.place_state(model, model_state=model_state)

    def place_state(self, model: nn.Module, opt_state: Optional[dict] = None, step: int = 0,
                    model_state: Any = None) -> TrainState:
        """The TrainState of `model` and `opt_state` on the trainer's
        device: also the checkpoint-restore path.  Every rank starts from
        rank 0's parameters, so a single-replica snapshot starts every
        replica in per_replica mode too.  `opt_state` is an optimizer state
        dict (`TrainState.opt_state.state_dict()`), loaded into the
        optimizer built over the model's parameters; None starts it fresh."""
        if self.has_aux and model_state is None:
            raise ValueError("has_aux=True requires model_state at init/place_state")
        model.to(self.device)
        self._broadcast_params(model)
        model_state = _tree_map(lambda x: x.to(self.device), model_state)
        opt = self.tx(model.parameters())
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        return TrainState(params=model, opt_state=opt, step=step, model_state=model_state)

    def _broadcast_params(self, model: nn.Module) -> None:
        """Every rank takes rank 0's parameters."""
        broadcast_params(model, self.group)

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
        if self.has_aux and not self.per_replica:
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

    def _check_replica(self, replica: int, what: str) -> None:
        if self.per_replica and replica != 0:
            raise ValueError(f"{what} can only read this rank's own replica (pass replica=0): "
                             "each rank's process holds one")

    def eval_params(self, state: TrainState, replica: int = 0) -> Dict[str, torch.Tensor]:
        """One replica's parameters (for eval/checkpoint): in per_replica
        mode this rank's own (`replica` 0, the JAX package's
        multi-controller rule; another raises ValueError); replicated,
        every rank holds the same."""
        self._check_replica(replica, "eval_params")
        return {k: v.detach() for k, v in state.params.state_dict().items()}

    def eval_model_state(self, state: TrainState, replica: int = 0) -> Any:
        """model_state analog of eval_params (e.g. BN stats at
        eval/checkpoint)."""
        if state.model_state is None:
            return None
        self._check_replica(replica, "eval_model_state")
        return state.model_state

    def fit(self, state: TrainState, data_iter, steps: int, log_every: int = 50,
            policies=None) -> Tuple[TrainState, Dict]:
        """Train for `steps` on this rank's batches from `data_iter`;
        `policies` is an optional sequence of BasePolicy hooks (reference
        PolicyHook, policy/policy_hook.py) or an already-configured
        PolicyRunner.  A step's samples are the global batch, this rank's
        rows times the world, as the JAX package's single-controller fit
        counts them; the result holds `samples_per_sec`."""
        runner = None
        if policies is not None:
            from .policy import PolicyRunner

            runner = (policies if isinstance(policies, PolicyRunner)
                      else PolicyRunner(policies, batch_size=0))
            runner.begin()
        t0 = time.perf_counter()
        samples = 0
        metrics: Dict[str, Any] = {}
        for i in range(steps):
            if runner is not None:
                runner.before_step()
            batch = self.shard_batch(next(data_iter))
            n = int(_first_tensor(batch).shape[0]) * self.world
            samples += n
            state, metrics = self.train_step(state, batch)
            if runner is not None:
                runner.after_step(n, metrics)
            if log_every and (i + 1) % log_every == 0:
                log.info("step %d loss %.4f", state.step, float(metrics["loss"]))
        if runner is not None:
            runner.end()
        if metrics:
            float(metrics["loss"])  # waits for the last step
        metrics = dict(metrics)
        metrics["samples_per_sec"] = samples / (time.perf_counter() - t0)
        return state, metrics
