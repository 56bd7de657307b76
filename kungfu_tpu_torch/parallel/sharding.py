"""The rules table: logical axis names -> mesh axes (counterpart of
kungfu_tpu/parallel/sharding.py).

The JAX package annotates every parameter with logical axis names
(flax `with_logical_partitioning`), maps them onto mesh axes with one
rules table and lets XLA place the shards and insert the collectives.
Here each rank is one process, and the same table decides three things:

  what convert cuts   `convert.shard_state_dict` slices each parameter of
                      a full state dict along the dims this table splits
                      over the model axes (tp, ep, pp), by this rank's
                      coordinates; `convert.gather_state_dict` puts the
                      shards back together
  what a rank holds   the models (`models.TransformerLM` under tp and ep,
                      `parallel.PipelinedLM` under pp) make their
                      parameters at those shards' shapes
  where a gradient    over the axes the table maps "batch" and "seq" to
  is summed           (`grad_axes`: dp and sp), by `trainer.MeshTrainer`;
                      over the model axes the models' own collectives
                      (`parallel.mappings`) make each rank's gradient whole
                      for what it holds, so no gradient is summed there

`DEFAULT_RULES` and `rules_for_mesh` are the JAX package's, copied (pure
Python).  `param_shardings(mesh, names)` is the counterpart of the JAX
`param_shardings`: each parameter's spec, one mesh axis (or None) per dim
of the full tensor in the port's layout (torch's `[out, in]` for a Dense
weight, where the flax kernel is `[in, out]`; a pipelined block leaf
stacked `[S, R, Lg, ...]` as the JAX `PipelinedLM` stacks it).  The
logical names of each parameter are those the JAX model gives it
(`logical_axes`), and a mesh axis goes to a dim as flax's
`logical_to_mesh_axes` gives it: rules in order, the first unassigned dim
of that name, a mesh axis used once.

The data axes split no parameter that a rank holds: the port keeps the
whole `pos_embed` table ("seq" -> sp in the JAX spec) on every rank of an
sp group, as the sequence-parallel path always has, and a mesh with an
fsdp axis trains with `fsdp.FSDPTrainer`.  `MODEL_AXES` are the axes that
do.

`logical_constraint` has no counterpart: a rank holds its shard, and the
layout of an activation is what the code that makes it computes.
`decode_cache_shardings` waits for decode (ROADMAP A.2).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

# logical axis -> mesh axis. None = replicated.
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "dp"),
    ("seq", "sp"),
    # "embed" names PARAMETER embed dims (fsdp shards them); activations
    # use "act_embed" so the fsdp rule never forces activation resharding
    ("embed", None),
    ("act_embed", None),
    # norm scales stay replicated even under ZeRO
    ("norm", None),
    ("heads", "tp"),
    ("kv", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    # activation/use-site vocab dim: tp-sharded when tp exists (Megatron
    # vocab-parallel logits), never rewritten to fsdp
    ("act_vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
)

# the axes whose shards a rank holds (MeshTrainer replicates over the rest)
MODEL_AXES = ("tp", "ep", "pp")


def rules_for_mesh(mesh, rules=DEFAULT_RULES) -> Tuple[Tuple[str, Optional[str]], ...]:
    """Drop rules whose mesh axis does not exist (e.g. no 'ep' axis).

    An `fsdp` mesh axis turns on the JAX package's GSPMD fully-sharded
    layout under the default rules: parameter embed dims shard over fsdp,
    the batch over both dp and fsdp, and (without tp) the vocab dim over
    fsdp, ranked before embed.  `mesh` is anything with `axis_names`."""
    names = set(mesh.axis_names)
    fsdp_defaults = rules is DEFAULT_RULES and "fsdp" in names
    out = []
    for logical, m in rules:
        if logical == "batch" and fsdp_defaults:
            axes = tuple(a for a in ("dp", "fsdp") if a in names)
            out.append((logical, axes if len(axes) > 1 else axes[0]))
        elif logical == "embed" and fsdp_defaults:
            out.append((logical, "fsdp"))
        elif logical == "vocab" and fsdp_defaults and "tp" not in names:
            out.append((logical, "fsdp"))
        elif isinstance(m, tuple):
            axes = tuple(a for a in m if a in names)
            out.append((logical, axes if len(axes) > 1 else (axes[0] if axes else None)))
        else:
            out.append((logical, m if m in names else None))
    if fsdp_defaults and "tp" not in names:
        # vocab outranks embed for the fsdp axis (the first rule claiming
        # a mesh axis gets it)
        out.sort(key=lambda r: 0 if r[0] == "vocab" else 1)
    if "fsdp" in names and not fsdp_defaults:
        used = set()
        for _, m in out:
            used.update(m if isinstance(m, tuple) else (m,))
        if "fsdp" not in used:
            from ..utils import get_logger

            get_logger("kungfu.sharding").warning(
                "mesh has an 'fsdp' axis but the custom rules table never maps it: "
                "parameters will be fully replicated.  Map a logical dim to 'fsdp' "
                "(DEFAULT_RULES does this automatically) or drop the axis.")
    return tuple(out)


def logical_to_mesh_axes(names: Sequence[Optional[str]], rules) -> Tuple:
    """flax `logical_to_mesh_axes`: one mesh axis (or None, or a tuple of
    axes) per dim named in `names`, by the rules in order of precedence."""
    named = [n for n in names if isinstance(n, str)]
    if len(named) != len(set(named)):
        raise ValueError(f"Unsupported: a dimension name occurs more than once in {names}")
    unassigned = object()
    result = [unassigned if isinstance(n, str) else None for n in names]

    def axes_of(m):
        return set(m if isinstance(m, tuple) else (m,)) - {None}

    for logical, mesh_axes in rules:
        if logical in names:
            pos = list(names).index(logical)
            used = set().union(*(axes_of(r) for r in result if r is not unassigned))
            if not (axes_of(mesh_axes) & used) and result[pos] is unassigned:
                result[pos] = mesh_axes
    return tuple(None if r is unassigned else r for r in result)


# logical names of each parameter of the port's models, in the port's
# layout (the flax model's names, a Dense kernel transposed), by the
# parameter name's tail
_DENSE = {"q": ("heads", "embed"), "k": ("heads", "embed"), "v": ("heads", "embed"),
          "out": ("embed", "heads"), "in_": ("mlp", "embed"), "gate": ("mlp", "embed")}
_LEAVES = {
    "embed.embedding": ("vocab", "embed"),
    "pos_embed": ("seq", "embed"),
    "lm_head.weight": ("vocab", "embed"),
    "moe.router": ("embed", "expert"),
    "moe.w_in": ("expert", "embed", "mlp"),
    "moe.w_out": ("expert", "mlp", "embed"),
    "mlp.out.weight": ("embed", "mlp"),
}
# a pipelined block leaf: `blocks.<leaf>` stacked [S, R, Lg, ...] as the
# JAX PipelinedLM holds it, of which a stage's `blocks.<r>.<j>.<leaf>` is
# entry [stage, r, j]
_STAGE = ("stage", None, None)
_PIPELINED = re.compile(r"^blocks\.(\d+\.\d+\.)?")


def logical_axes(name: str) -> Tuple[Optional[str], ...]:
    """The flax logical names of the port's parameter `name`, one per dim
    in the port's layout.  A pipelined block parameter (`blocks.<leaf>`,
    or a stage's `blocks.<r>.<j>.<leaf>`) names the dims of the stacked
    leaf: ("stage", None, None, *the block leaf's)."""
    if _PIPELINED.match(name):
        return _STAGE + logical_axes("block_0." + _PIPELINED.sub("", name))
    if name.endswith(".scale"):
        return ("norm",)
    for tail, axes in _LEAVES.items():
        if name == tail or name.endswith("." + tail):
            return axes
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] in _DENSE:
        axes = _DENSE[parts[-2]]
        if parts[-1] == "weight":
            return axes
        if parts[-1] == "bias":  # the bias shards with the output dim
            return axes[:1]
    raise ValueError(f"no logical axes known for parameter {name!r}")


def param_shardings(mesh, names: Iterable[str], rules=None) -> Dict[str, Tuple]:
    """{name: spec} for the port's parameters `names` (a model's
    `named_parameters()` names, or a state dict's keys): the mesh axis of
    each dim of the full tensor, in the port's layout, by the rules
    (default `rules_for_mesh(mesh)`)."""
    rules = rules if rules is not None else rules_for_mesh(mesh)
    return {n: logical_to_mesh_axes(logical_axes(n), rules) for n in names}


def held_splits(spec: Tuple) -> Tuple[Tuple[str, int], ...]:
    """The (mesh axis, dim) pairs of `spec` that a rank holds a shard of:
    the dims split over a model axis (MODEL_AXES)."""
    return tuple((m, d) for d, m in enumerate(spec) if m in MODEL_AXES)


def grad_axes(mesh, rules=None) -> Tuple[str, ...]:
    """The mesh axes every gradient is summed over: those the rules map
    "batch" and "seq" to (dp and sp; fsdp under the fsdp defaults)."""
    rules = dict(rules if rules is not None else rules_for_mesh(mesh))
    out = []
    for logical in ("batch", "seq"):
        m = rules.get(logical)
        out += [a for a in ((m,) if isinstance(m, str) else (m or ()))]
    return tuple(a for a in mesh.axis_names if a in out)


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` on `mesh` (1 without a mesh or the axis)."""
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def data_size(mesh) -> int:
    """The ranks of a data group: the product of `grad_axes`' sizes."""
    return 1 if mesh is None else math.prod(mesh.shape[a] for a in grad_axes(mesh))
