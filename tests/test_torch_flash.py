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


HEAD_DIM_CASES = [
    # (L, H, Hkv, causal, window)
    (200, 2, 2, True, 0),
    (200, 2, 2, True, 64),
    (136, 2, 2, False, 0),
    (200, 4, 2, True, 0),
    (200, 4, 2, True, 64),
]


@pytest.mark.parametrize("l,h,hkv,causal,window", HEAD_DIM_CASES)
@pytest.mark.parametrize("d", [16, 32, 128])
def test_head_dims_match_pallas(kflash, d, l, h, hkv, causal, window):
    """Head dims besides 64 (fault C.1): the port's flash path and its
    gradients against the interpreted Pallas kernels, MHA and GQA, causal,
    windowed and not; f32, 2e-5 as above."""
    q, k, v, g_o, g_lse = _inputs(l, h, hkv, d=d, seed=d)
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


# The CUDA forward's tile edges (64-row query blocks, 64-key tiles; the
# JAX kernel's key blocks of 64 and 128): ragged lengths on both sides of
# one and two tiles, windows of one key up to wider than L, and a GQA group
# of 8.  The port's plain forward, which the card holds B1 against, against
# the JAX `_fwd_kernel` under the Pallas interpreter; f32, 2e-5 as above.
FWD_EDGE_CASES = [
    # (L, H, Hkv, D, causal, window)
    (1, 2, 2, 64, True, 0),
    (1, 2, 2, 64, False, 0),
    (63, 2, 2, 64, True, 0),
    (63, 2, 2, 64, False, 0),
    (65, 2, 2, 128, True, 0),
    (65, 2, 2, 128, False, 0),
    (127, 2, 2, 32, True, 0),
    (127, 2, 2, 32, False, 0),
    (129, 2, 2, 64, True, 0),
    (129, 2, 2, 64, False, 0),
    (257, 2, 2, 128, True, 0),
    (257, 2, 2, 128, False, 0),
    (300, 2, 2, 64, True, 1),
    (300, 2, 2, 128, True, 64),
    (300, 2, 2, 64, True, 65),
    (300, 2, 2, 16, True, 128),
    (300, 2, 2, 128, True, 129),
    (300, 2, 2, 64, True, 400),  # wider than L
    (200, 8, 1, 64, True, 0),  # GQA, a group of 8
    (129, 8, 1, 128, False, 0),
    (257, 8, 1, 64, True, 65),
]


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("l,h,hkv,d,causal,window", FWD_EDGE_CASES)
def test_plain_forward_matches_pallas_fwd_kernel(kflash, block_k, l, h, hkv, d, causal,
                                                 window):
    q, k, v, _, _ = _inputs(l, h, hkv, d=d, seed=l + d + window)
    scale = d ** -0.5

    def bhld(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])

    o_ref, lse_ref = kflash._flash_fwd(bhld(q), bhld(k), bhld(v), scale, causal, 64, block_k,
                                       True, h=h, hkv=hkv, window=window)
    o, lse = tflash._plain_fwd_blhd(*map(torch.from_numpy, (q, k, v)), scale, causal, window)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(o_ref).reshape(1, h, l, d).transpose(0, 2, 1, 3), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref).reshape(1, h, l), atol=ATOL)


@pytest.mark.parametrize("d", list(range(16, 129, 16)))
def test_kernels_take_head_dims_16_to_128(d):
    assert d in tflash.HEAD_DIMS
    tflash.check_head_dim("flash_fwd", d)


@pytest.mark.parametrize("d", [129, 144, 256])
def test_other_head_dims_name_roadmap_c1(d):
    """Only a head wider than 128 is refused (fault C.1, narrowed)."""
    assert d not in tflash.HEAD_DIMS
    with pytest.raises(NotImplementedError, match="ROADMAP C.1"):
        tflash.check_head_dim("flash_fwd", d)


@pytest.mark.parametrize("d", list(range(1, 129)))
def test_check_head_dim_takes_1_to_128(d):
    """Every head dim up to 128 runs on the kernels: in place at a multiple
    of 8, else padded to the next one."""
    tflash.check_head_dim("flash_fwd", d)
    dp = tflash.kernel_head_dim(d)
    assert dp in tflash.HEAD_DIMS and d <= dp < d + 8
    assert (dp == d) == (d % 8 == 0)


# The padded route of a head dim that is not a multiple of 8: the plain
# forward and backward on the operands padded with zero columns, cut back
# to D, against the plain version at D.  The zero columns add exact zeros
# to every q.k sum and to rowsum(dO * O); only the order of the f32 sums
# in the products of other shapes may differ, so 1e-5 absolute on values
# of order one.
PAD_ATOL = 1e-5


@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("d", [12, 20, 100])
def test_padded_head_matches_plain(d, h, hkv):
    l, causal, window = 136, True, 48
    q, k, v, g_o, g_lse = map(torch.from_numpy, _inputs(l, h, hkv, d=d, seed=100 + d))
    scale = d ** -0.5
    dp = tflash.kernel_head_dim(d)
    assert dp % 8 == 0 and dp > d
    o, lse = tflash._plain_fwd_blhd(q, k, v, scale, causal, window)
    delta = (o * g_o).sum(-1).transpose(1, 2).contiguous() - g_lse
    want = tflash._plain_bwd_blhd(q, k, v, g_o, lse, delta, scale, causal, 64, window)

    qp, kp, vp, gp = (tflash.pad_head(x, dp) for x in (q, k, v, g_o))
    assert qp.shape[-1] == dp and torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    o_p, lse_p = tflash._plain_fwd_blhd(qp, kp, vp, scale, causal, window)
    delta_p = (o_p * gp).sum(-1).transpose(1, 2).contiguous() - g_lse
    got = tflash._plain_bwd_blhd(qp, kp, vp, gp, lse_p, delta_p, scale, causal, 64, window)

    np.testing.assert_allclose(tflash.cut_head(o_p, d).numpy(), o.numpy(), atol=PAD_ATOL)
    assert not o_p[..., d:].any()  # the padded columns of o are exact zeros
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), atol=PAD_ATOL)
    np.testing.assert_allclose(delta_p.numpy(), delta.numpy(), atol=PAD_ATOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(tflash.cut_head(g, d).numpy(), w.numpy(), atol=PAD_ATOL,
                                   err_msg=name)


def test_padded_head_matches_pallas(kflash):
    """A head of 12 through the padded route, forward and gradients,
    against the interpreted Pallas kernels, which take the whole head dim
    as one block; f32, 2e-5 as above."""
    d, l, h, hkv, causal, window = 12, 200, 4, 2, True, 64
    q, k, v, g_o, g_lse = _inputs(l, h, hkv, d=d, seed=12)
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)

    def jax_fn(q, k, v):
        return kflash.flash_attention_with_lse(q, k, v, interpret=True,
                                               backward="pallas", **kw)

    (o_ref, lse_ref), vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    grads_ref = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))

    dp = tflash.kernel_head_dim(d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o_p, lse = tflash.flash_attention_with_lse(
        *(tflash.pad_head(x, dp) for x in (tq, tk, tv)), scale=d ** -0.5, **kw)
    o = tflash.cut_head(o_p, d)
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
