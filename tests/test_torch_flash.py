"""The port's flash attention (plain path, CPU) against the JAX package's
Pallas kernels run in interpret mode.

Inputs come from a numpy seed and reach both packages as numpy.  f32
throughout; the tolerance is 2e-5 absolute on values of order one: the
two sides sum the same f32 products in another order (blocked online
softmax on the JAX side, whole rows or other blocks on the port's).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _flash_faults import DKV_FAULTS, FAULTS, planted_dkv_faults, planted_faults
from _torch_reference import jax_reference
from kungfu_tpu_torch.ops import flash as tflash
from kungfu_tpu_torch.parallel.ring_attention import full_attention
from kungfu_tpu_torch.utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

ATOL = 2e-5


@pytest.fixture(scope="module")
def kflash():
    with jax_reference():
        from kungfu_tpu.ops import flash

        yield flash


def _inputs(l, h, hkv, d=64, b=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, d), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    g_o = rng.standard_normal((b, l, h, d), dtype=np.float32)
    g_lse = rng.standard_normal((b, h, l), dtype=np.float32)
    return q, k, v, g_o, g_lse


CASES = [
    # (L, H, Hkv, causal, window)
    (128, 2, 2, True, 0),
    (128, 2, 2, False, 0),
    (200, 2, 2, True, 0),
    (200, 2, 2, False, 0),
    (200, 2, 2, True, 64),
    (200, 4, 2, True, 0),  # GQA: the port's plain path vs the JAX GQA kernels
    (200, 4, 2, True, 64),
    (200, 4, 1, False, 0),
]


@pytest.mark.parametrize("l,h,hkv,causal,window", CASES)
def test_flash_with_lse_matches_pallas(kflash, l, h, hkv, causal, window):
    q, k, v, g_o, g_lse = _inputs(l, h, hkv)
    kw = dict(causal=causal, window=window or None, block_q=64, block_k=64)

    def jax_fn(q, k, v):
        return kflash.flash_attention_with_lse(q, k, v, interpret=True,
                                               backward="pallas", **kw)

    (o_ref, lse_ref), vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    grads_ref = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tflash.flash_attention_with_lse(tq, tk, tv, **kw)
    grads = torch.autograd.grad((o, lse), (tq, tk, tv),
                                (torch.from_numpy(g_o), torch.from_numpy(g_lse)))

    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_ref), atol=ATOL)
    for name, got, want in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(kflash, causal):
    """`flash_attention` (o only; no lse cotangent) and its gradients."""
    q, k, v, g_o, _ = _inputs(128, 2, 2, seed=1)
    kw = dict(causal=causal, block_q=64, block_k=64)

    def jax_fn(q, k, v):
        return kflash.flash_attention(q, k, v, interpret=True, backward="pallas", **kw)

    o_ref, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    grads_ref = vjp(jnp.asarray(g_o))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tflash.flash_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g_o))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=ATOL)
    for got, want in zip(grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("window", [0, 48])
def test_plain_wrappers_agree_with_autograd(window):
    """The CPU wrappers of B1-B3 (the kernels' plain versions) give what
    the autograd path gives, with a folded lse cotangent (same code, same
    order: exact)."""
    q, k, v, g_o, g_lse = (torch.from_numpy(x) for x in _inputs(136, 2, 2, seed=2))
    scale = 0.125
    o, lse = tflash.flash_fwd(q, k, v, scale, True, window)
    delta = ((o * g_o).sum(-1).transpose(1, 2) - g_lse).contiguous()
    dq = tflash.flash_bwd_dq(q, k, v, g_o, lse, delta, scale, True, window)
    dk, dv = tflash.flash_bwd_dkv(q, k, v, g_o, lse, delta, scale, True, window)

    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    o2, lse2 = tflash.flash_attention_with_lse(tq, tk, tv, causal=True, scale=scale,
                                               window=window or None)
    grads = torch.autograd.grad((o2, lse2), (tq, tk, tv), (g_o, g_lse))
    torch.testing.assert_close(o, o2.detach(), rtol=0, atol=0)
    torch.testing.assert_close(lse, lse2.detach(), rtol=0, atol=0)
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 64])
def test_gqa_backward_matches_pallas_gqa_kernel(kflash, window):
    """The GQA dk/dv of the port's plain path (the wrapper of B4 on the
    CPU) against the JAX package's `_bwd_dkv_gqa_kernel` in interpret
    mode, L=200, H=4, Hkv=2, from the same o and lse; 2e-5 as above."""
    q, k, v, g_o, _ = _inputs(200, 4, 2, seed=5)
    scale = 0.125
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g_o))
    o, lse = tflash.flash_fwd(tq, tk, tv, scale, True, window)
    delta = (o * tg).sum(-1).transpose(1, 2).contiguous()
    dk, dv = tflash.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, scale, True, window)

    def bhld(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])

    _, jdk, jdv = kflash._bwd_pallas(
        bhld(q), bhld(k), bhld(v), bhld(o.numpy()), jnp.asarray(lse.numpy()).reshape(4, 200),
        bhld(g_o), scale, True, 64, 64, True, h=4, hkv=2, window=window)
    for got, want in ((dk, jdk), (dv, jdv)):
        want = np.asarray(want).reshape(1, 2, 200, 64).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_flash_matches_full_attention_bf16():
    """bf16 on the plain path against full attention; 3e-2 absolute, the
    JAX package's own bf16 flash tolerance (tests/unit/test_flash.py)."""
    q, k, v, _, _ = _inputs(96, 4, 2, seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o = tflash.flash_attention(tq, tk, tv, causal=True)
    ref = full_attention(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), ref.float(), rtol=0, atol=3e-2)


def test_input_checks():
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs(64, 2, 2))
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="backward"):
        tflash.flash_attention(q, k, v, backward="fast")
    with pytest.raises(ValueError, match="heads"):
        tflash.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1), v)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="device"):
        tflash.flash_fwd(meta, meta, meta, 0.125, True)


# -- the card's kernel check: normwise relative error per 64-row block --

def _plain_results(q, k, v, do, scale):
    o, lse = tflash._plain_fwd_blhd(q, k, v, scale, True, 0)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    grads = tflash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0)
    return (o, lse, delta) + grads


@pytest.fixture(scope="module")
def plain_l512():
    """Plain causal results at L=512 on bf16-valued inputs: in f32, and in
    bf16, which rounds P and dS before their products as the kernels do."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(512, 2, 2, seed=4)[:4])
    f32 = [x.float() for x in (q, k, v, do)]
    return f32, _plain_results(*f32, 0.125), _plain_results(q, k, v, do, 0.125)


def test_kernel_check_accepts_bf16_rounding(plain_l512):
    """bf16 arithmetic of the same computation stays inside the bf16 limit
    that the card holds the kernels to."""
    _, want, got = plain_l512
    for name, g, w in zip(("o", "dq", "dk", "dv"), got[:1] + got[3:], want[:1] + want[3:]):
        whole, worst = rel_errs(g, w)
        assert worst <= REL_LIMIT[torch.bfloat16], f"{name}: worst block {worst:.3g}"
    assert (got[1] - want[1]).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("fault", DKV_FAULTS)
def test_kernel_check_rejects_planted_gqa_faults(fault):
    """The same check rejects a GQA dk/dv (B4) that leaves a key block's
    late query rows, or the last query block, out of one kv head's group."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).float()
                   for x in _inputs(512, 4, 2, seed=6)[:4])
    _, _, _, _, dk, dv = _plain_results(q, k, v, do, 0.125)
    lse = tflash._plain_fwd_blhd(q, k, v, 0.125, True, 0)[1]
    o = tflash._plain_fwd_blhd(q, k, v, 0.125, True, 0)[0]
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    name, bad = planted_dkv_faults(q, k, v, do, lse, delta, 0.125, dk, dv)[fault]
    worst = rel_errs(bad, dict(dk=dk, dv=dv)[name])[1]
    assert worst > 10 * REL_LIMIT[torch.bfloat16], f"{fault}: worst block {worst:.3g}"


@pytest.mark.parametrize("fault", FAULTS)
def test_kernel_check_rejects_planted_faults(plain_l512, fault):
    """A kernel that skips one 64-wide key or query block fails the bf16
    limit, though the terms it drops are small next to the largest entry."""
    (q, k, v, do), (o, lse, delta, dq, dk, dv), _ = plain_l512
    name, bad = planted_faults(q, k, v, do, lse, delta, 0.125, o, dq, dk, dv)[fault]
    want = dict(o=o, dq=dq, dk=dk, dv=dv)[name]
    whole, worst = rel_errs(bad, want)
    assert worst > 10 * REL_LIMIT[torch.bfloat16], f"{fault}: worst block {worst:.3g}"
