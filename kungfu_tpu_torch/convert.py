"""Weights between the JAX package's TransformerLM and this one.

`params_from_flax` turns the flax parameter tree (nested dicts of numpy
arrays, unboxed) into a `state_dict` for `models.TransformerLM`;
`params_to_flax` is its inverse.  Names map one to one:

  block_0/attn/q/kernel  [in, out]  <->  block_0.attn.q.weight  [out, in]
  block_0/mlp/in/kernel             <->  block_0.mlp.in_.weight
  lm_head/kernel [d, vocab]         <->  lm_head.weight [vocab, d]
  embed/embedding, pos_embed, */scale, */bias   unchanged
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.transformer import TransformerConfig


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _check_layers(names, cfg: TransformerConfig) -> None:
    layers = {n.split(".")[0] for n in names if n.startswith("block_")}
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree has {len(layers)} blocks, config says {cfg.n_layers}")


def params_from_flax(params: Mapping, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """flax TransformerLM params (numpy leaves) -> torch state_dict (f32, CPU)."""
    sd = {}
    for path, value in _flatten(params).items():
        parts = ["in_" if p == "in" else p for p in path.split("/")]
        arr = np.asarray(value, dtype=np.float32)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            arr = arr.T
        sd[".".join(parts)] = torch.tensor(arr)
    _check_layers(sd, cfg)
    return sd


def params_to_flax(state_dict: Mapping[str, torch.Tensor],
                   cfg: TransformerConfig) -> Dict[str, Any]:
    """torch state_dict -> flax TransformerLM params (nested numpy dicts)."""
    _check_layers(state_dict, cfg)
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        parts = ["in" if p == "in_" else p for p in name.split(".")]
        arr = t.detach().float().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            arr = arr.T
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree
