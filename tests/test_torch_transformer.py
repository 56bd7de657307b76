"""The port's TransformerLM against the flax model on converted weights:
logits, loss and every parameter gradient, f32 on the CPU.

Tolerances: logits and loss to 2e-5 absolute (values of order one or
less, f32 sums in another order); gradients to 1e-4 relative plus 1e-6
absolute, since gradients pass through two layers of such sums and some
entries are near zero.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import transformer as tt

VOCAB, B, L = 97, 2, 16


@pytest.fixture(scope="module")
def kft():
    with jax_reference():
        import flax.linen as nn

        from kungfu_tpu.models import transformer

        yield transformer, nn


CONFIGS = {
    "layer-gelu-flash": dict(attention="flash", flash_block_q=8, flash_block_k=8),
    "rms-swiglu-rope-tied-full": dict(norm="rms", ffn="swiglu", rope=True,
                                      tie_embeddings=True, attention="full",
                                      attention_bias=True),
    "gqa-rope-full": dict(n_kv_heads=2, rope=True, attention="full"),
    "gqa-rope-flash": dict(n_kv_heads=2, rope=True, attention="flash", flash_block_q=8,
                           flash_block_k=8),
    "rope-window-flash": dict(rope=True, window=6, attention="flash",
                              flash_block_q=8, flash_block_k=8),
    "auto-remat": dict(attention="auto", rope=True, remat=True),
    "dots-remat-flash": dict(attention="flash", rope=True, remat=True, remat_policy="dots",
                             flash_block_q=8, flash_block_k=8),
}


def _configs(kft, name):
    jt, _ = kft
    common = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                  max_len=L, **CONFIGS[name])
    return (jt.TransformerConfig(dtype=jnp.float32, **common),
            tt.TransformerConfig(dtype=torch.float32, **common))


def _jax_params(kft, jcfg, tokens):
    jt, nn = kft
    model = jt.TransformerLM(jcfg)
    params = nn.meta.unbox(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    return model, jax.tree.map(np.asarray, params)


def _port_model(params, tcfg):
    model = tt.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params, tcfg))
    return model


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, L)).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_loss_grads_match_flax(kft, name):
    jt, _ = kft
    jcfg, tcfg = _configs(kft, name)
    tokens = _tokens()
    model, params = _jax_params(kft, jcfg, tokens)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return jt.lm_loss(logits, jnp.asarray(tokens)), logits

    (loss_ref, logits_ref), grads_ref = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    tmodel = _port_model(params, tcfg)
    ttokens = torch.from_numpy(tokens).long()
    logits = tmodel(ttokens)
    loss = tt.lm_loss(logits, ttokens)
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref), atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=2e-5)
    grads = convert.params_to_flax(
        {n: p.grad for n, p in tmodel.named_parameters()}, tcfg)
    flat_ref = jax.tree_util.tree_flatten_with_path(grads_ref)[0]
    assert len(flat_ref) == len(list(tmodel.parameters()))
    for path, want in flat_ref:
        got = grads
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_convert_round_trip(kft):
    jcfg, tcfg = _configs(kft, "rms-swiglu-rope-tied-full")
    _, params = _jax_params(kft, jcfg, _tokens())
    back = convert.params_to_flax(convert.params_from_flax(params, tcfg), tcfg)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, want), got in zip(flat, jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))


def test_rope_matches_flax(kft):
    jt, _ = kft
    x = np.random.default_rng(4).standard_normal((2, 8, 3, 16), dtype=np.float32)
    pos = np.arange(8)
    want = jt.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_bf16_forward_close_to_flax(kft):
    """Mixed precision (bf16 compute, f32 norms/head/loss): the loss agrees
    to 2e-2, the size of a few bf16 roundings (2^-8) on a loss near log V."""
    jt, _ = kft
    common = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                  max_len=L, rope=True, attention="full")
    jcfg = jt.TransformerConfig(dtype=jnp.bfloat16, **common)
    tcfg = tt.TransformerConfig(dtype=torch.bfloat16, **common)
    tokens = _tokens(5)
    model, params = _jax_params(kft, jcfg, tokens)
    want = jax.jit(lambda p, t: jt.lm_loss(model.apply({"params": p}, t), t))(
        params, jnp.asarray(tokens))
    tmodel = _port_model(params, tcfg)
    ttokens = torch.from_numpy(tokens).long()
    logits = tmodel(ttokens)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(tt.lm_loss(logits, ttokens).item(), float(want), atol=2e-2)


def test_later_slices_raise():
    for kw in (dict(decode=True), dict(n_experts=4)):
        with pytest.raises(NotImplementedError):
            tt.TransformerConfig(**kw)
    # ported: Ulysses attention (tests/test_torch_ulysses.py, test_torch_mesh_train.py)
    assert tt.TransformerConfig(attention="ulysses").attention == "ulysses"
    for kw in (dict(ffn="relu"), dict(dropout=1.5), dict(head="logits")):
        with pytest.raises(ValueError):
            tt.TransformerConfig(**kw)


# -- dropout: after the embedding and on each residual branch, only under
# train=True, from an explicit torch.Generator.  The two packages draw
# other bits, so against flax: train=False (no dropout at all) and rate 1.0
# (every branch zero); the port's masks alone: the keep share, the
# 1 / (1 - rate) scale and a seed's repeatability.

def _dropout_pair(kft, rate):
    jcfg, tcfg = _configs(kft, "gqa-rope-full")
    jcfg = dataclasses.replace(jcfg, dropout=rate)
    tcfg = dataclasses.replace(tcfg, dropout=rate)
    tokens = _tokens(6)
    model, params = _jax_params(kft, jcfg, tokens)
    return model, params, _port_model(params, tcfg), tokens


@pytest.mark.parametrize("rate", [0.1, 1.0])
def test_dropout_matches_flax_where_it_must(kft, rate):
    """train=False equals the flax model's default (no dropout); at rate
    1.0 with train=True both zero every branch, so logits and loss agree
    (2e-5, as above) whatever the bits."""
    jt, _ = kft
    model, params, tmodel, tokens = _dropout_pair(kft, rate)
    ttokens = torch.from_numpy(tokens).long()
    jtokens = jnp.asarray(tokens)
    want_eval = model.apply({"params": params}, jtokens)
    np.testing.assert_allclose(tmodel(ttokens).detach().numpy(), np.asarray(want_eval),
                               atol=2e-5)
    if rate == 1.0:
        want = model.apply({"params": params}, jtokens, train=True,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        got = tmodel(ttokens, train=True, generator=torch.Generator().manual_seed(1))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(tt.lm_loss(got, ttokens).item(),
                                   float(jt.lm_loss(want, jtokens)), atol=2e-5)


def test_dropout_keep_share_and_scale():
    """Each element kept with probability 1 - rate (100,000 draws: the
    share within 5 standard deviations, 0.0047), kept ones scaled by
    exactly 1 / (1 - rate) in the input's dtype, the rest zero."""
    rate, n = 0.1, 100_000
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((n,), 3.0, dtype=dtype)
        y = tt.dropout(x, rate, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - rate)) < 0.0047
        assert torch.equal(y[kept], (x / (1 - rate))[kept]) and y.dtype == dtype
    assert tt.dropout(x, rate, None) is x  # no generator: no dropout


def test_dropout_follows_the_generator(kft):
    """One seed gives one output, another seed another; train=True
    without a generator raises."""
    _, _, tmodel, tokens = _dropout_pair(kft, 0.1)
    ttokens = torch.from_numpy(tokens).long()

    def run(seed):
        return tmodel(ttokens, train=True, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), tmodel(ttokens))
    with pytest.raises(ValueError, match="generator"):
        tmodel(ttokens, train=True)
