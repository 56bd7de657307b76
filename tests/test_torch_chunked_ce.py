"""The port's chunked lm-head loss (ops/chunked_ce.py, models.transformer
lm_loss_chunked, tuner/footprint.py) against the JAX package's, on the
CPU.

Inputs come from a numpy seed and reach both packages as numpy.  The JAX
head weight is [D, V] and the port's [V, D]: the port gets the transpose
and its dW is compared transposed.

Tolerances: in f32, ll, log_z, dh and dW to 2e-5 relative plus 2e-6
absolute (the same f32 products and sums, the port's ragged last block a
shorter slice where the JAX package pads it with NEG_INF columns, whose
exact zeros leave only the order of the sums).  For h in bf16, dh comes
back in bf16 on both sides, rounded from f32 sums that agree to about
1e-6: one bf16 step (2^-8 relative) where the two sums straddle a
rounding boundary.  The model's loss to 2e-5 and its gradients to 1e-4
relative plus 1e-6 absolute, as tests/test_torch_transformer.py holds the
dense head.
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
from kungfu_tpu_torch.ops import chunked_ce
from kungfu_tpu_torch.tuner import footprint

N, D, V = 40, 24, 97
RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module")
def ref():
    with jax_reference():
        import flax.linen as nn

        from kungfu_tpu.models import transformer
        from kungfu_tpu.ops import chunked_ce as jce
        from kungfu_tpu.tuner import footprint as jfoot

        yield jce, jfoot, transformer, nn


def _head_inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, D), dtype=np.float32)
    w = (rng.standard_normal((D, V), dtype=np.float32) * 0.3).astype(np.float32)
    targets = rng.integers(0, V, N).astype(np.int32)
    d_ll = rng.standard_normal(N, dtype=np.float32)
    d_logz = rng.standard_normal(N, dtype=np.float32)
    return h, w, targets, d_ll, d_logz


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [16, 32, 97, 128])
def test_chunked_head_matches_jax(ref, block, dtype):
    """ll, log_z, dh and dW, with cotangents on both ll and log_z; blocks
    that divide V, that leave a ragged last block, that equal V and that
    are larger than V."""
    jce = ref[0]
    h, w, targets, d_ll, d_logz = _head_inputs()
    jh = jnp.asarray(h).astype(getattr(jnp, dtype))
    (ll_ref, lz_ref), vjp = jax.vjp(
        lambda h_, w_: jce.chunked_lm_head_ll(h_, w_, jnp.asarray(targets), block),
        jh, jnp.asarray(w))
    dh_ref, dw_ref = vjp((jnp.asarray(d_ll), jnp.asarray(d_logz)))

    th = torch.from_numpy(h).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    ll, lz = chunked_ce.chunked_lm_head_ll(th, tw, torch.from_numpy(targets), block)
    dh, dw = torch.autograd.grad((ll, lz), (th, tw),
                                 (torch.from_numpy(d_ll), torch.from_numpy(d_logz)))
    assert ll.dtype == lz.dtype == torch.float32
    assert dh.dtype == th.dtype and dw.dtype == tw.dtype
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lz.detach().numpy(), np.asarray(lz_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dw.numpy().T, np.asarray(dw_ref), rtol=RTOL, atol=ATOL)
    dh_ref = np.asarray(dh_ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(dh.numpy(), dh_ref, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(dh.float().numpy(), dh_ref, rtol=2 ** -8, atol=1e-6)


def test_nothing_of_n_by_v_is_saved():
    """No tensor saved for the backward has N x V elements (the dense
    head's logsumexp saves its [N, V] logits, which the hook does see)."""
    h, w, targets, _, _ = _head_inputs(1)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    tt_ = torch.from_numpy(targets).long()

    def saved(fn):
        sizes = []

        def pack(x):
            sizes.append(x.numel())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            fn()
        return sizes

    chunked = saved(lambda: chunked_ce.chunked_lm_head_ll(th, tw, tt_, 32))
    assert chunked and max(chunked) < N * V, chunked
    dense = saved(lambda: torch.logsumexp(th @ tw.T, dim=-1))
    assert N * V in dense


@pytest.mark.parametrize("vocab", [None, 40, 32000])
@pytest.mark.parametrize("n_tokens", [None, 0, 8, 16376, 65504])
def test_default_ce_block_matches_jax(ref, n_tokens, vocab):
    jfoot = ref[1]
    assert footprint.default_ce_block(n_tokens, vocab) == jfoot.default_ce_block(n_tokens, vocab)


@pytest.mark.parametrize("env", ["512", " 256 ", "abc", ""])
@pytest.mark.parametrize("n_tokens", [None, 0, 8, 16376, 65504])
def test_resolve_ce_block_matches_jax(ref, monkeypatch, env, n_tokens):
    """The explicit block wins, then KFT_CE_BLOCK (a malformed value falls
    through), then the footprint default."""
    jce = ref[0]
    monkeypatch.setenv("KFT_CE_BLOCK", env)
    for block in (None, 300):
        want = jce.resolve_ce_block(block, n_tokens, 32000)
        assert chunked_ce.resolve_ce_block(block, n_tokens, 32000) == want
    assert chunked_ce.resolve_ce_block(None, n_tokens, 32000) == (
        int(env) if env.strip().isdigit() else footprint.default_ce_block(n_tokens, 32000))


# ------------------------------------------------------------ the model --

VOCAB, B, L = 97, 2, 16


def _model_configs(jt, tied):
    common = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=L,
                  rope=True, attention="full", tie_embeddings=tied, head="hidden")
    return (jt.TransformerConfig(dtype=jnp.float32, **common),
            tt.TransformerConfig(dtype=torch.float32, **common))


def _grads_close(got_model, want_tree, cfg, what):
    grads = convert.params_to_flax({n: p.grad for n, p in got_model.named_parameters()}, cfg)
    flat = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(flat) == len(list(got_model.parameters()))
    for path, want in flat:
        got = grads
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_lm_loss_chunked_matches_jax(ref, tied, z_loss):
    """The port's head="hidden" model and lm_loss_chunked against the JAX
    package's on converted weights: the loss and every gradient; then the
    port's head="dense" model and lm_loss on the same weights."""
    _, _, jt, nn = ref
    jcfg, tcfg = _model_configs(jt, tied)
    tokens = np.random.default_rng(3).integers(0, VOCAB, (B, L)).astype(np.int32)
    model = jt.TransformerLM(jcfg)
    params = jax.tree.map(np.asarray, nn.meta.unbox(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]))
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss_chunked(model, p, jnp.asarray(tokens), block=32,
                                     z_loss=z_loss)))(params)

    ttokens = torch.from_numpy(tokens).long()
    tmodel = tt.TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(convert.params_from_flax(params, tcfg))
    loss = tt.lm_loss_chunked(tmodel, ttokens, block=32, z_loss=z_loss)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=2e-5)
    _grads_close(tmodel, grads_ref, tcfg, "chunked vs JAX")

    dcfg = dataclasses.replace(tcfg, head="dense")
    dense = tt.TransformerLM(dcfg, device="cpu")
    dense.load_state_dict(tmodel.state_dict())
    dloss = tt.lm_loss(dense(ttokens), ttokens, z_loss=z_loss)
    dloss.backward()
    np.testing.assert_allclose(loss.item(), dloss.item(), atol=2e-5)
    for (name, p), q in zip(tmodel.named_parameters(), dense.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-6, msg=name)


def test_lm_loss_chunked_needs_hidden_head():
    cfg = tt.TransformerConfig(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=4, d_ff=64,
                               max_len=L, dtype=torch.float32)
    with pytest.raises(ValueError, match="hidden"):
        tt.lm_loss_chunked(tt.TransformerLM(cfg, device="cpu"),
                           torch.zeros(1, L, dtype=torch.long))
