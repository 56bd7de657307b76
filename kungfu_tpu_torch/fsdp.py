"""FSDP: fully-sharded data parallelism over the `fsdp` mesh axis, ZeRO-3
(counterpart of kungfu_tpu/fsdp.py).

The JAX trainer runs the step as one shard_map program and lets autodiff
transpose its gathers into reduce-scatters.  Here every rank is one
process and the same pieces are eager:

  storage   every parameter lives as a flat chunk: flattened, zero-padded
            to a multiple of n_fsdp, and this rank's 1/n of it kept as the
            optimizer's parameter (`_chunk`); the module's own full
            parameters are freed at `init`, so a rank holds 1/n of the
            model and of the optimizer state
  compute   each step gathers every chunk (`dma_all_gather_group`, the
            ring all-gather B6 on a card, one launch a bucket;
            `dma_collectives=False`: `all_gather_into_tensor` a chunk),
            reshapes it to its parameter, and runs the loss on the module
            with those tensors in place of its parameters
            (`torch.func.functional_call`)
  gradients the gather's backward reduce-scatters each bucket's gradients
            (the ring reduce-scatter B5 on a card, one launch a bucket; off:
            `reduce_scatter_tensor` a chunk), so each rank's chunk receives
            the sum of its chunk over the fsdp
            ranks; it is divided by n_fsdp, then averaged over `dp` if the
            mesh has a replicated data axis (hybrid sharded DP), compressed
            there by `compression`, bucketed by `bucket_bytes`
  update    the elementwise optimizer (Adam, AdamW, SGD, ...) steps on the
            chunks, so its state is sharded with them

The fsdp axis is also a data axis: every rank of the mesh takes its own
rows of the batch (`shard_batch`) and the reported loss is the mean over
the data axes.  `remat=True` checkpoints the gathers with the loss
(`torch.utils.checkpoint`), so the full parameters are gathered again in
the backward instead of being kept, as `jax.checkpoint` makes the JAX
step do.

Buckets (`bucket_plan`): consecutive parameters in the module's order, of
one dtype, at most `ring_collectives.MAX_SEGMENTS` of them, their chunks
together at most one ring slot, which `init` grows once to the largest
chunk (a larger chunk is a bucket of its own), so the gathers and
reduce-scatters of a bucket are one launch each and add no memory to the
workspace; the flagship's 195 parameters make 12 buckets at fsdp=4.  A
grouped call is bit-equal to a call per parameter.  Every rank must make
the same ring calls in the same order: every rank plans the same buckets
from the same shapes, the forward gathers them in the module's order, and
the backward's reduce-scatters follow the autograd graph, which is the
same on every rank.

    tx = adamw(3e-4, b1=0.9, b2=0.95)
    trainer = FSDPTrainer(lambda m, b: lm_loss(m(b), b), tx, make_mesh(fsdp=4))
    state = trainer.init(model)            # the same weights on every rank
    batch = trainer.shard_batch(tokens)    # this rank's rows of the global batch
    state, metrics = trainer.train_step(state, batch)
    params = trainer.eval_params(state)    # the full state dict, on every rank

`analyze` (kf-lint) and `bucket_bytes="auto"` need the planner and tuner
(ROADMAP A.8) and raise.  There is no `donate`: torch frees what the step
no longer references.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from . import compression as Comp
from .compat import resolve_device
from .ops import collective as C
from .ops import peer_memory
from .ops import ring_collectives as RC
from .ops.fused_matmul import dma_all_gather_group
from .optimizers.sync import (_bucketed_reduce, _mean_reducer, _pack_buckets,
                              _resolve_bucket_bytes)
from .plan.mesh import Mesh, make_mesh
from .train import TrainState, _tree_map


def _chunk(x: torch.Tensor, n: int) -> torch.Tensor:
    """Flatten and zero-pad to a multiple of n -> (n, chunk)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.view(n, -1)


def _unchunk(c: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return c.reshape(-1)[:math.prod(shape)].view(shape)


def _ring_bytes(chunks: Sequence[torch.Tensor]) -> int:
    """Bytes of the ring slot that holds the largest chunk (padded to the
    ring's 1024-value tile): what `init` grows the fsdp group's workspace
    to."""
    return peer_memory.slot_size(max(-(-max(c.numel(), 1) // C.TILE) * C.TILE * c.element_size()
                                     for c in chunks))


def bucket_plan(chunks: Sequence[torch.Tensor]) -> List[Tuple[int, int]]:
    """The buckets [start, stop) of a rank's chunks (in the module's
    order): `ring_collectives.segment_plan` within one slot of
    `_ring_bytes`, so each is one launch of B6 and one of B5."""
    return RC.segment_plan([(c.numel(), c.dtype) for c in chunks], _ring_bytes(chunks))


def _lib_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    C.host_staged(dist.all_gather_into_tensor, out, x.contiguous(), group)
    return out


class _LibAllGather(torch.autograd.Function):
    """The tiled gather on torch.distributed (`dma_collectives=False`); its
    backward is the summed tiled scatter, `reduce_scatter_tensor`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _lib_all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        C.host_staged(dist.reduce_scatter_tensor, out, g.contiguous(), ctx.group)
        return out, None


class _Loss(nn.Module):
    """loss_fn(model, batch) as a module, so `functional_call` can swap the
    model's parameters (names under "model.")."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


class FSDPTrainer:
    """Fully-sharded data-parallel trainer (`DataParallelTrainer`'s surface).

    Args:
      loss_fn: (model, batch) -> scalar loss of this rank's rows.
      tx: elementwise optimizer factory, params -> torch.optim optimizer
        (e.g. `optimizers.adamw(3e-4)`); it steps on the chunks.
      mesh: a mesh with an `fsdp` axis (default `make_mesh(fsdp=-1)`); a
        `dp` axis beside it gives hybrid sharded DP.
      remat: gather the parameters again in the backward instead of
        keeping the gathered ones (ZeRO-3's memory, one more gather).
      compression: wire format of the dp leg's gradient mean (a config, a
        registered name, or {"dp": ...}); the fsdp traffic stays f32.
      analyze: the kf-lint hook; needs ROADMAP A.8 and raises if set.
      bucket_bytes: the dp leg reduces buckets of at most this many bytes
        (`optimizers/sync.py`'s packing) instead of one chunk at a time.
      dma_collectives: the unshard and its backward on the ring kernels
        (B6/B5; None or True); False: torch.distributed's
        all_gather_into_tensor / reduce_scatter_tensor.
      device: where chunks and batches live ("cuda" unless "cpu").
    """

    def __init__(self, loss_fn: Callable, tx: Callable, mesh: Optional[Mesh] = None,
                 remat: bool = False, compression=None,
                 analyze: Optional[bool] = None, bucket_bytes=None,
                 dma_collectives: Optional[bool] = None, device=None):
        if analyze:
            raise NotImplementedError(
                "FSDPTrainer(analyze=True): the kf-lint hook needs the analysis package, "
                "not ported yet (ROADMAP A.8)")
        if bucket_bytes == "auto":
            raise NotImplementedError(
                "FSDPTrainer(bucket_bytes='auto') needs the compute tuner, not ported yet "
                "(ROADMAP A.8)")
        self.mesh = mesh if mesh is not None else make_mesh(fsdp=-1)
        if "fsdp" not in self.mesh.axis_names:
            raise ValueError(f"mesh {self.mesh.axis_names} has no 'fsdp' axis")
        others = [a for a, s in self.mesh.shape.items() if a not in ("dp", "fsdp") and s > 1]
        if others:
            raise ValueError(f"FSDPTrainer shards over fsdp and replicates over dp; the mesh "
                             f"also splits {others}")
        if isinstance(compression, dict):
            Comp.validate_axis_keys(compression, self.mesh.axis_names, context="FSDPTrainer")
            compression = compression.get("dp")
        self.compression = Comp.resolve(compression) if compression is not None else None
        self.bucket_bytes = _resolve_bucket_bytes(bucket_bytes)
        self.dma_collectives = dma_collectives is not False and dma_collectives != "off"
        self.loss_fn = loss_fn
        self.tx = tx
        self.remat = remat
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:  # the rank's card
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n_shard = self.mesh.shape["fsdp"]
        self.has_dp = self.mesh.shape.get("dp", 1) > 1
        self.fsdp_group = self.mesh.group("fsdp")
        self.dp_group = self.mesh.group("dp") if self.has_dp else None
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.mesh.size != world:
            raise ValueError(f"mesh {self.mesh.shape} does not cover the {world} ranks")
        self._module: Optional[_Loss] = None
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._buckets: List[Tuple[int, int]] = []
        self._generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def world(self) -> int:
        return self.mesh.size

    # -- chunk layout -------------------------------------------------------

    def _chunks(self, full: Dict[str, torch.Tensor]) -> Dict[str, nn.Parameter]:
        """This rank's chunk of every full tensor, as optimizer parameters."""
        me = self.mesh.coord("fsdp")
        return {name: nn.Parameter(_chunk(t.detach().to(self.device), self.n_shard)[me].clone())
                for name, t in full.items()}

    def _reserve_ring(self, chunks: Sequence[torch.Tensor]) -> None:
        """Plan the buckets and grow the fsdp group's ring workspace to the
        largest chunk now, so no gather or reduce-scatter of a step grows
        it (collective)."""
        self._buckets = bucket_plan(chunks)
        if not (self.dma_collectives and self.device.type == "cuda" and self.n_shard > 1):
            return
        peer_memory.workspace(self.fsdp_group, self.device).reserve(_ring_bytes(chunks),
                                                                     "rs", "ag")

    def _gather(self, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every chunk gathered: a grouped ring call a bucket, or
        torch.distributed a chunk."""
        if self.n_shard == 1:
            return list(chunks)
        if not self.dma_collectives:
            return [_LibAllGather.apply(c, self.fsdp_group) for c in chunks]
        return [full for start, stop in self._buckets
                for full in dma_all_gather_group(chunks[start:stop], self.fsdp_group)]

    def _full_params(self, chunks: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {f"model.{name}": _unchunk(full, shape)
                for (name, shape), full in zip(self._shapes.items(), self._gather(chunks))}

    def _loss(self, batch, *chunks: torch.Tensor) -> torch.Tensor:
        return functional_call(self._module, self._full_params(chunks), (batch,))

    # -- host API -----------------------------------------------------------

    def init(self, model: nn.Module) -> TrainState:
        """Chunk the module's parameters (every rank must pass the same
        weights, as the JAX package's processes pass the same host params),
        free its full parameters and build the optimizer over the chunks."""
        model.to(self.device)
        self._module = _Loss(model, self.loss_fn)
        full = dict(model.named_parameters())
        self._shapes = {name: tuple(p.shape) for name, p in full.items()}
        chunks = self._chunks(full)
        with torch.no_grad():
            for p in full.values():  # the module keeps names, not memory
                p.data = p.data.new_empty(0)
        self._reserve_ring(list(chunks.values()))
        return TrainState(params=chunks, opt_state=self.tx(list(chunks.values())))

    def place_state(self, state_dict: Dict[str, torch.Tensor],
                    opt_state_full: Optional[Dict[str, Dict[str, Any]]] = None,
                    step: int = 0) -> TrainState:
        """The checkpoint-restore path: full parameters (and optionally the
        optimizer's state per parameter name, tensors shaped like the
        parameter, as `eval_opt_state` returns it) -> a sharded state.
        Needs the module of an earlier `init`."""
        if self._module is None:
            raise ValueError("place_state needs the module: call init(model) first")
        if set(state_dict) != set(self._shapes):
            raise ValueError(f"state_dict names {sorted(set(state_dict) ^ set(self._shapes))} "
                             "differ from the module's parameters")
        chunks = self._chunks({name: state_dict[name] for name in self._shapes})
        opt = self.tx(list(chunks.values()))
        if opt_state_full is not None:
            me = self.mesh.coord("fsdp")
            for name, p in chunks.items():
                opt.state[p] = {
                    k: (_chunk(v.to(self.device), self.n_shard)[me].clone()
                        if torch.is_tensor(v) and tuple(v.shape) == self._shapes[name]
                        else (v.clone() if torch.is_tensor(v) else v))
                    for k, v in opt_state_full[name].items()}
        self._reserve_ring(list(chunks.values()))
        return TrainState(params=chunks, opt_state=opt, step=step)

    def shard_batch(self, batch: Any) -> Any:
        """This rank's rows of the global batch (dim 0 split over dp x
        fsdp in rank order), on the trainer's device."""
        index = self.mesh.coord("dp") * self.n_shard + self.mesh.coord("fsdp")

        def rows(x: torch.Tensor) -> torch.Tensor:
            if x.shape[0] % self.world:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by {self.world} ranks")
            per = x.shape[0] // self.world
            return x[index * per:(index + 1) * per].to(self.device, non_blocking=True)

        return _tree_map(rows, batch)

    def _dp_mean(self, grads) -> None:
        """The dp leg in place: the mean over dp of every chunk's gradient,
        compressed as configured, bucketed by bucket_bytes."""
        if not self.has_dp:
            return
        if self.compression is not None:
            def mean(flat):
                flat.copy_(Comp.all_reduce(flat, self.dp_group, self.compression, op="mean",
                                           generator=self._generator))
        else:
            mean = _mean_reducer(self.dp_group, "pmean")
        if self.bucket_bytes:
            _bucketed_reduce(grads, _pack_buckets(grads, self.bucket_bytes), mean)
        else:
            for g in grads:
                mean(g)

    def train_step(self, state: TrainState, batch: Any) -> Tuple[TrainState, Dict]:
        chunks, opt = state.params, state.opt_state
        opt.zero_grad()
        if self.remat:
            loss = checkpoint(self._loss, batch, *chunks.values(), use_reentrant=False)
        else:
            loss = self._loss(batch, *chunks.values())
        loss.backward()
        grads = []
        for c in chunks.values():
            if c.grad is None:  # a parameter the loss does not reach
                c.grad = torch.zeros_like(c)
            grads.append(c.grad.div_(self.n_shard))
        self._dp_mean(grads)
        if self.device.type == "cuda":
            peer_memory.check_all()  # a ring kernel that gave up on a peer raises here
        opt.step()
        loss = loss.detach().float().clone()
        if self.world > 1:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM)
            loss /= self.world
        return TrainState(chunks, opt, state.step + 1), {"loss": loss}

    def train_steps(self, state: TrainState, batch: Any, n: int) -> Tuple[TrainState, Dict]:
        """`n` steps on one batch; the metrics of the last."""
        metrics: Dict = {}
        for _ in range(n):
            state, metrics = self.train_step(state, batch)
        return state, metrics

    def _unshard(self, chunk: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
        chunk = chunk.detach()
        full = chunk if self.n_shard == 1 else _lib_all_gather(chunk, self.fsdp_group)
        return _unchunk(full, shape).clone()

    def eval_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The full parameters, by name, on every rank (collective)."""
        return {name: self._unshard(c, self._shapes[name])
                for name, c in state.params.items()}

    def eval_opt_state(self, state: TrainState) -> Dict[str, Dict[str, Any]]:
        """The optimizer's state per parameter name, each chunked tensor put
        back to the parameter's shape (collective); `place_state` takes it."""
        out = {}
        for name, p in state.params.items():
            st = state.opt_state.state.get(p, {})
            out[name] = {k: (self._unshard(v, self._shapes[name])
                             if torch.is_tensor(v) and v.shape == p.shape else v)
                         for k, v in st.items()}
        return out
