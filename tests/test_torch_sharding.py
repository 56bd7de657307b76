"""The rules table: the port's `parallel/sharding.py` against the JAX
package's.

  rules      `rules_for_mesh` equal to the JAX one on meshes with and
             without tp, ep, pp and fsdp (the fsdp defaults' rewrite and
             reordering included), and `logical_to_mesh_axes` equal to
             flax's on names that compete for one mesh axis
  params     each parameter's spec from the port's `param_shardings` (one
             mesh axis or None per dim of the whole tensor, torch's
             [out, in] layout) against the JAX `param_shardings` of the
             same model (its PartitionSpec, a kernel's last two dims
             swapped), for a tp model (GQA, q/k/v biases, SwiGLU, learned
             positions), a MoE model under ep, a pipelined model under pp
             (the stacked [S, R, Lg, ...] leaves) and the tp model under
             the fsdp defaults
  cut        `convert.shard_state_dict` keeps, on each rank, the block of
             each split dim that the rank's coordinates pick, and the
             gradient group of MeshTrainer is the data group (dp and sp)

The JAX side needs no device: `param_shardings` reads the logical names
of `jax.eval_shape`'s abstract parameters.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.parallel import sharding as ts
from kungfu_tpu_torch.plan import mesh as pm

MESHES = [dict(dp=4), dict(dp=2, tp=2), dict(sp=2, tp=2), dict(dp=2, ep=2), dict(dp=2, pp=2),
          dict(pp=4), dict(fsdp=4), dict(dp=2, fsdp=2), dict(fsdp=2, tp=2),
          dict(dp=1, fsdp=2, sp=2), dict(ep=2, tp=2)]
SMALL = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64, max_len=16)
# name -> (mesh sizes, config fields, pipeline (repeats, microbatches) or None)
MODELS = {
    "tp-gqa": (dict(dp=2, tp=2), dict(n_kv_heads=2, attention_bias=True, ffn="swiglu"), None),
    "tp-tied-rope": (dict(dp=2, tp=2), dict(tie_embeddings=True, rope=True), None),
    "ep-moe": (dict(dp=2, ep=2), dict(n_experts=4), None),
    "pp": (dict(dp=2, pp=2), dict(rope=True), (2, 2)),
    "fsdp-tp": (dict(fsdp=2, tp=2), dict(n_kv_heads=2), None),
}


def _port_mesh(sizes):
    return pm.Mesh(sizes, 0, dict.fromkeys(sizes))


def _jax_mesh(sizes):
    from kungfu_tpu.plan import make_mesh

    n = int(np.prod(list(sizes.values())))
    return make_mesh(devices=jax.devices()[:n], **sizes)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(f"{a}{n}" for a, n in s.items()))
def test_rules_for_mesh_match_jax(sizes):
    with jax_reference():
        from kungfu_tpu.parallel.sharding import rules_for_mesh

        want = rules_for_mesh(_jax_mesh(sizes))
    assert ts.rules_for_mesh(_port_mesh(sizes)) == tuple(want)


def test_default_rules_are_the_jax_table():
    with jax_reference():
        from kungfu_tpu.parallel.sharding import DEFAULT_RULES

        assert ts.DEFAULT_RULES == tuple(DEFAULT_RULES)


@pytest.mark.parametrize("names", [("embed", "heads"), ("heads", "embed"), ("vocab", "embed"),
                                   ("expert", "embed", "mlp"), ("stage", None, None, "mlp",
                                                                "embed"),
                                   ("batch", "seq", "act_embed"), (None, "norm")])
def test_logical_to_mesh_axes_matches_flax(names):
    import flax.linen.spmd as flax_spmd

    for sizes in MESHES:
        rules = ts.rules_for_mesh(_port_mesh(sizes))
        want = tuple(flax_spmd.logical_to_mesh_axes(names, rules))
        got = ts.logical_to_mesh_axes(names, rules)
        assert got == want + (None,) * (len(got) - len(want)), (sizes, names)


def _jax_specs(name):
    """{port parameter name: spec in the port's layout} from the JAX
    `param_shardings` of model `name`."""
    sizes, kw, pipe = MODELS[name]
    from kungfu_tpu.models import transformer as jt
    from kungfu_tpu.parallel.pp_transformer import PipelinedLM
    from kungfu_tpu.parallel.sharding import param_shardings

    mesh = _jax_mesh(sizes)
    cfg = jt.TransformerConfig(dtype=jnp.float32, mesh=mesh, **SMALL, **kw)
    model = (PipelinedLM(cfg, repeats=pipe[0], microbatches=pipe[1]) if pipe
             else jt.TransformerLM(cfg))
    tokens = jnp.zeros((4, SMALL["max_len"]), jnp.int32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), tokens)["params"]
    shardings = param_shardings(mesh, abstract)
    out = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]:
        keys = [k.key for k in path]
        leaf = abstract
        for k in keys:
            leaf = leaf[k]
        ndim = len(leaf.value.shape if hasattr(leaf, "value") else leaf.shape)
        spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
        parts = ["in_" if p == "in" else p for p in keys]
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            spec = spec[:-2] + (spec[-1], spec[-2])
        out[".".join(parts)] = spec
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_param_shardings_match_jax(name):
    sizes, kw, pipe = MODELS[name]
    with jax_reference():
        want = _jax_specs(name)
    got = ts.param_shardings(_port_mesh(sizes), want)
    assert got == want
    assert any(ts.held_splits(s) for s in got.values())  # the model axis splits something


@pytest.mark.parametrize("name", ["tp-gqa", "ep-moe"])
def test_port_model_names_are_the_jax_leaves(name):
    """The port's model holds a parameter for each JAX leaf, at the shard
    shape the table gives it."""
    sizes, kw, _ = MODELS[name]
    with jax_reference():
        want = _jax_specs(name)
    whole = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32, **SMALL, **kw),
                             device="cpu").state_dict()
    for rank in range(int(np.prod(list(sizes.values())))):
        mesh = pm.Mesh(sizes, rank, dict.fromkeys(sizes))
        model = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32, mesh=mesh, **SMALL,
                                                      **kw), device="cpu")
        held = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert set(held) == set(want)
        cut = convert.shard_state_dict(whole, mesh)
        assert {n: tuple(t.shape) for n, t in cut.items()} == held
        for n, spec in ts.param_shardings(mesh, whole).items():
            t = whole[n]
            for axis, dim in ts.held_splits(spec):
                t = t.chunk(sizes[axis], dim)[mesh.coord(axis)]
            torch.testing.assert_close(cut[n], t, rtol=0, atol=0)


def test_gradient_axes_are_the_data_axes():
    assert ts.grad_axes(_port_mesh(dict(dp=2, sp=2, tp=2))) == ("dp", "sp")
    assert ts.grad_axes(_port_mesh(dict(dp=2, ep=2))) == ("dp",)
    assert ts.grad_axes(_port_mesh(dict(dp=2, pp=2))) == ("dp",)
    assert ts.grad_axes(_port_mesh(dict(dp=2, fsdp=2))) == ("dp", "fsdp")
    assert ts.data_size(_port_mesh(dict(dp=2, sp=2, tp=2))) == 4
    assert ts.data_size(None) == 1


def test_mesh_groups_over_several_axes():
    shape = {"dp": 2, "sp": 2, "tp": 2}
    assert pm.axis_partition(shape, "tp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert pm.axis_partition(shape, ("dp", "sp")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    mesh = pm.Mesh(shape, 5, dict.fromkeys(shape))
    assert mesh.coords == {"dp": 1, "sp": 0, "tp": 1}
    assert mesh.index(("dp", "sp")) == 2 and mesh.index(("tp",)) == 1
    assert pm.Mesh(shape, 0, dict.fromkeys(shape)).group(("dp", "sp")) is None  # world of one


def test_unknown_parameter_names_raise():
    with pytest.raises(ValueError, match="no logical axes"):
        ts.logical_axes("block_0.attn.rotary")
