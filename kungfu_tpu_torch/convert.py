"""Weights between the JAX package's models and this one.

`params_from_flax` turns a flax parameter tree (nested dicts of numpy
arrays, unboxed) into a whole `state_dict` for `models.TransformerLM`, or
for the JAX `PipelinedLM`'s tree a whole stacked one; `params_to_flax` is
its inverse.  Names map one to one:

  block_0/attn/q/kernel  [in, out]  <->  block_0.attn.q.weight  [out, in]
  block_0/mlp/in/kernel             <->  block_0.mlp.in_.weight
  lm_head/kernel [d, vocab]         <->  lm_head.weight [vocab, d]
  block_1/moe/router, w_in, w_out   unchanged (the JAX layouts)
  blocks/attn/q/kernel [S, R, Lg, in, out]  <->  blocks.attn.q.weight
                                    [S, R, Lg, out, in] (PipelinedLM)
  embed/embedding, pos_embed, */scale, */bias   unchanged

`stack_pipeline` repacks a whole TransformerLM state dict into the
stacked one (stage s, round r, in-group layer j <- layer (r S + s) Lg +
j), as the JAX `PipelinedLM.init` repacks its model's tree.

`shard_state_dict` cuts a whole state dict to this rank's shards by the
rules table (`parallel/sharding.py`): each dim split over a model axis
(tp, ep, pp) keeps this rank's block, and a stacked pipeline leaf becomes
this stage's `blocks.<r>.<j>.<leaf>`: the state dict of the rank's
`TransformerLM` or `PipelinedLM` on that mesh.  `gather_state_dict` is
its inverse over the process group (collective).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.transformer import TransformerConfig
from .parallel import mappings
from .parallel.sharding import held_splits, param_shardings

_STAGED = re.compile(r"^blocks\.(\d+)\.(\d+)\.(.*)$")  # a stage's block parameter


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _check_layers(sd: Mapping, cfg: TransformerConfig) -> None:
    layers = {n.split(".")[0] for n in sd if n.startswith("block_")}
    stacked = [v for n, v in sd.items() if n.startswith("blocks.")]
    if stacked:  # [S, R, Lg, ...]: S R Lg layers
        layers = range(int(np.prod(stacked[0].shape[:3])))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree has {len(layers)} blocks, config says {cfg.n_layers}")


def params_from_flax(params: Mapping, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """flax TransformerLM (or PipelinedLM) params (numpy leaves) -> the
    whole torch state_dict (f32, CPU)."""
    sd = {}
    for path, value in _flatten(params).items():
        parts = ["in_" if p == "in" else p for p in path.split("/")]
        arr = np.asarray(value, dtype=np.float32)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            arr = np.swapaxes(arr, -1, -2)
        sd[".".join(parts)] = torch.tensor(np.ascontiguousarray(arr))
    _check_layers(sd, cfg)
    return sd


def params_to_flax(state_dict: Mapping[str, torch.Tensor],
                   cfg: TransformerConfig) -> Dict[str, Any]:
    """A whole torch state_dict -> flax TransformerLM (or PipelinedLM)
    params (nested numpy dicts)."""
    _check_layers(state_dict, cfg)
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        parts = ["in" if p == "in_" else p for p in name.split(".")]
        arr = t.detach().float().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            arr = np.swapaxes(arr, -1, -2)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree


def stack_pipeline(state_dict: Mapping[str, torch.Tensor], stages: int, repeats: int
                   ) -> Dict[str, torch.Tensor]:
    """A whole TransformerLM state dict -> the whole PipelinedLM one: the
    blocks' leaves stacked [S, R, Lg, ...] as `blocks.<leaf>`, layer
    (r S + s) Lg + j at [s, r, j]; the rest unchanged."""
    n = len({k.split(".")[0] for k in state_dict if k.startswith("block_")})
    if n % (stages * repeats):
        raise ValueError(f"{n} layers do not divide into S*R={stages * repeats} groups")
    lg = n // (stages * repeats)
    out = {k: v for k, v in state_dict.items() if not k.startswith("block_")}
    leaves = [k.split(".", 1)[1] for k in state_dict if k.startswith("block_0.")]
    for leaf in leaves:
        out["blocks." + leaf] = torch.stack([
            torch.stack([torch.stack([state_dict[f"block_{(r * stages + s) * lg + j}.{leaf}"]
                                      for j in range(lg)]) for r in range(repeats)])
            for s in range(stages)])
    return out


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], mesh, rules=None
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shards of a whole state dict, by the rules table: for
    each dim split over tp, ep or pp this rank's block of it (its
    coordinate on that axis), and for a stacked pipeline leaf this stage's
    groups as `blocks.<r>.<j>.<leaf>`."""
    specs = param_shardings(mesh, state_dict, rules)
    out = {}
    for name, full in state_dict.items():
        t = full
        for axis, dim in held_splits(specs[name]):
            t = t.chunk(mesh.shape[axis], dim=dim)[mesh.coord(axis)]
        if name.startswith("blocks."):  # [R, Lg, ...] of this stage (pp split dim 0)
            if t.shape[0] == 1:
                t = t[0]
            leaf = name[len("blocks."):]
            for r in range(t.shape[0]):
                for j in range(t.shape[1]):
                    out[f"blocks.{r}.{j}.{leaf}"] = t[r, j].contiguous()
        else:
            out[name] = t.contiguous()
    return out


def gather_state_dict(state_dict: Mapping[str, torch.Tensor], mesh, rules=None
                      ) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's shards (`shard_state_dict`'s
    inverse; collective over the process group: every rank calls it with
    the same names).  Stage groups come back stacked as `blocks.<leaf>`."""
    staged: Dict[str, Dict] = {}
    whole = {}
    for name, t in state_dict.items():
        m = _STAGED.match(name)
        if m:
            staged.setdefault(m.group(3), {})[int(m.group(1)), int(m.group(2))] = t
        else:
            whole[name] = t
    for leaf, parts in staged.items():
        R, Lg = max(r for r, _ in parts) + 1, max(j for _, j in parts) + 1
        whole["blocks." + leaf] = torch.stack([torch.stack([parts[r, j] for j in range(Lg)])
                                               for r in range(R)])[None]
    specs = param_shardings(mesh, whole, rules)
    out = {}
    for name in sorted(whole):
        t = whole[name].detach()  # the same names, in the same order, on every rank
        for axis, dim in held_splits(specs[name]):
            t = mappings.gather_from(t, mesh.group(axis), dim)
        out[name] = t
    return out
