"""Tensor parallelism: the port's MeshTrainer under a tp axis against the
JAX package's MeshTrainer (Megatron's layout by the rules table, XLA's
collectives) on the same weights and batch.

Each run trains 3 steps of plain SGD in f32 on 4 ranks (the JAX side on
4 virtual CPU devices, the port on 4 gloo ranks in subprocesses; 2
layers, d_model 32, d_ff 64, vocab 96, batch 4 x 32), from weights drawn
with numpy from a seed, and holds the port to the JAX run: every step's
loss, every parameter's gradient of the first step (the port's summed
over the data group and gathered over tp, the JAX one (p0 - p1) / lr),
and every parameter after the last step, each to 1e-5 absolute; and every
rank's gathered parameters the same bits (the replicated ones, norm
scales and the dp replicas, agree).  The runs:

  dp2-tp2-tied        dp=2 x tp=2, learned positions, gelu, tied
                      embeddings (the sharded table as the vocab-parallel
                      head)
  dp2-tp2-gqa-repeat  dp=2 x tp=2, one kv head (tp does not divide it: the
                      whole k/v projection gathered, repeated, cut to the
                      rank's heads), q/k/v biases, RoPE; the gradients
                      summed over dp by impl="pallas_ring"
  sp2-tp2-ring-gqa    sp=2 x tp=2, ring attention inside each tp shard,
                      GQA 4/2, RoPE, SwiGLU (the JAX package's multi-axis
                      dry run, phase A)
  sp2-tp2-ulysses-*   sp=2 x tp=2, Ulysses attention on each tp shard's
                      heads: GQA 4/2 (one kv head a shard: the all_to_all
                      repeats them) and GQA 8/4 (two a shard, split over
                      sp)

The readings are up to 1e-7 for the losses and parameters: both sides sum
the same f32 products in other orders.  A backward that sums the
row-parallel output over tp (a sum where Megatron's g has the identity)
doubles the attention and MLP gradients of the first step, far past the
tolerance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import (assert_tree_close, by_prefix, jax_run, numpy_weights,
                              port_results, replicas_identical, start_port)
from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.plan import mesh as pm
from kungfu_tpu_torch.trainer import MeshTrainer

COMMON = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=32)
RUNS = {
    "dp2-tp2-tied": (dict(dp=2, tp=2), dict(tie_embeddings=True), "pmean"),
    "dp2-tp2-gqa-repeat": (dict(dp=2, tp=2), dict(n_kv_heads=1, attention_bias=True, rope=True),
                           "pallas_ring"),
    "sp2-tp2-ring-gqa": (dict(sp=2, tp=2), dict(attention="ring", n_kv_heads=2, rope=True,
                                                ffn="swiglu"), "pmean"),
    "sp2-tp2-ulysses-gqa-repeat": (dict(sp=2, tp=2), dict(attention="ulysses", n_kv_heads=2,
                                                          rope=True), "pmean"),
    "sp2-tp2-ulysses-gqa-split": (dict(sp=2, tp=2), dict(attention="ulysses", n_heads=8,
                                                         n_kv_heads=4, rope=True), "pmean"),
}
LR, STEPS, TOL = 0.1, 3, 1e-5


def _tokens():
    rng = np.random.default_rng(21)
    return rng.integers(0, COMMON["vocab_size"], (4, COMMON["max_len"])).astype(np.int32)


def _config(kw):
    return {**COMMON, **kw}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (JAX (losses, grads, params), the port's per-rank npz)}, the
    port's runs three at a time beside the JAX runs."""
    tmp = tmp_path_factory.mktemp("tp")
    tokens = _tokens()
    out = {}
    with jax_reference():
        from kungfu_tpu.models import transformer as jt
        from kungfu_tpu.plan import make_mesh

        def loss(m, p, b):
            return jt.lm_loss(m.apply({"params": p}, b), b)

        names = list(RUNS)
        for batch in (names[i:i + 3] for i in range(0, len(names), 3)):
            started = {}
            for name in batch:
                sizes, kw, impl = RUNS[name]
                seed = names.index(name)
                mesh = make_mesh(devices=jax.devices()[:4], **sizes)
                model = jt.TransformerLM(jt.TransformerConfig(dtype=jnp.float32, mesh=mesh,
                                                              **_config(kw)))
                params = numpy_weights(model, jnp.asarray(tokens), seed)
                tcfg = tt.TransformerConfig(dtype=torch.float32, **_config(kw))
                whole = {k: v.numpy() for k, v in convert.params_from_flax(params, tcfg).items()}
                procs = start_port(tmp, name, whole, tokens, sizes, _config(kw), STEPS, LR,
                                   impl=impl)
                started[name] = (model, mesh, params, procs)
            for name, (model, mesh, params, procs) in started.items():
                ref = jax_run(model, loss, mesh, params, jnp.asarray(tokens), STEPS, LR)
                out[name] = (ref, port_results(tmp, name, procs))
    return out


def _port_tree(res, prefix, kw):
    cfg = tt.TransformerConfig(dtype=torch.float32, **_config(kw))
    return convert.params_to_flax({k: torch.from_numpy(v) for k, v in
                                   by_prefix(res, prefix).items()}, cfg)


@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_jax(runs, name):
    (losses, _, _), ranks = runs[name]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=0, atol=TOL)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", list(RUNS))
def test_first_step_gradients_match_jax(runs, name):
    (_, grads, _), ranks = runs[name]
    assert_tree_close(_port_tree(ranks[0], "grad", RUNS[name][1]), grads, TOL, "gradient")


@pytest.mark.parametrize("name", list(RUNS))
def test_parameters_after_three_steps_match_jax(runs, name):
    (_, _, params), ranks = runs[name]
    assert_tree_close(_port_tree(ranks[0], "param", RUNS[name][1]), params, TOL, "parameter")


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_holds_the_same_model(runs, name):
    replicas_identical(runs[name][1])


def test_local_shapes_follow_the_rules_table():
    """Under tp=2 a rank holds half the heads, d_ff and vocab; one kv head
    (tp does not divide it) keeps half the k/v projection's columns."""
    shape = {"dp": 2, "tp": 2}
    mesh = pm.Mesh(shape, 1, dict.fromkeys(shape))
    cfg = tt.TransformerConfig(dtype=torch.float32, mesh=mesh, n_kv_heads=1, **COMMON)
    got = {n: tuple(p.shape) for n, p in tt.TransformerLM(cfg, device="cpu").named_parameters()}
    assert got["embed.embedding"] == (48, 32) and got["lm_head.weight"] == (48, 32)
    assert got["block_0.attn.q.weight"] == (16, 32) and got["block_0.attn.out.weight"] == (32, 16)
    assert got["block_0.attn.k.weight"] == (4, 32)  # 1 head x 8 of 32 columns, halved
    assert got["block_0.mlp.in_.weight"] == (32, 32) and got["block_0.mlp.out.weight"] == (32, 32)
    assert got["block_0.ln1.scale"] == (32,)
    whole = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32, n_kv_heads=1, **COMMON),
                             device="cpu").state_dict()
    cut = convert.shard_state_dict(whole, mesh)
    assert {k: tuple(v.shape) for k, v in cut.items()} == got
    torch.testing.assert_close(cut["block_0.attn.q.weight"], whole["block_0.attn.q.weight"][16:])


def test_unported_combinations_raise():
    for shape in ({"tp": 2, "ep": 2}, {"pp": 2, "tp": 2}, {"pp": 2, "sp": 2},
                  {"ep": 2, "sp": 2}, {"dp": 2, "fsdp": 2}):
        mesh = pm.Mesh(shape, 0, dict.fromkeys(shape))
        with pytest.raises(NotImplementedError, match="A.6b"):
            MeshTrainer(None, None, mesh, device="cpu")
    tp = pm.Mesh({"tp": 2}, 0, {"tp": None})
    for kw in (dict(n_experts=4), dict(head="hidden")):
        with pytest.raises(NotImplementedError, match="A.6b"):
            tt.TransformerConfig(mesh=tp, **COMMON, **kw)
    with pytest.raises(ValueError, match="tp=2 must divide vocab_size"):
        tt.TransformerConfig(mesh=tp, **{**COMMON, "vocab_size": 97})
