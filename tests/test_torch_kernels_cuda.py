"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`; without a card every test skips (the check runs in a
fixture, so every worker collects the same tests).  Run them on a machine
with an H100 with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: the repo's conftest sets up JAX, which that machine need
not have; this file imports none of it).

Each output is judged by its normwise relative error over 64-row blocks,
worst block against kungfu_tpu_torch.utils.compare.REL_LIMIT (f32 1e-5,
fp16 2e-3, bf16 1e-2, set and explained there), and lse by LSE_ATOL.
The readings are printed (`-s` shows them).  One test plants faults, a
key or query block left out at L=2048, and shows the check rejects them.
"""
from __future__ import annotations

import pytest
import torch

from _flash_faults import FAULTS, planted_faults
from kungfu_tpu_torch.ops import flash
from kungfu_tpu_torch.utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, b, l, h, hkv, d, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    return rnd(b, l, h, d), rnd(b, l, hkv, d), rnd(b, l, hkv, d), rnd(b, l, h, d)


def _close(got, want, dtype, what):
    whole, worst = rel_errs(got, want)
    print(f"{what} {dtype}: normwise relative error {whole:.3g}, worst block {worst:.3g}")
    assert worst <= REL_LIMIT[dtype], f"{what}: worst block {worst:.3g} > {REL_LIMIT[dtype]}"


def _lse_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= LSE_ATOL, f"lse: max abs err {err:.3g} > {LSE_ATOL}"


CASES = [
    # (B, L, H, Hkv, D, causal, window)
    (2, 256, 4, 4, 64, True, 0),
    (2, 256, 4, 4, 64, False, 0),
    (1, 200, 2, 2, 64, True, 0),  # ragged tail
    (1, 333, 2, 2, 128, True, 0),
    (1, 300, 2, 2, 128, False, 0),
    (2, 256, 2, 2, 64, True, 96),  # sliding window
    (1, 200, 2, 2, 128, True, 50),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "f32"])
@pytest.mark.parametrize("b,l,h,hkv,d,causal,window", CASES)
def test_kernels_match_plain(card, dtype, b, l, h, hkv, d, causal, window):
    q, k, v, do = _inputs(card, b, l, h, hkv, d, dtype)
    scale = d ** -0.5
    o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, causal, window)
    _close(o, o_ref, dtype, "o")
    _lse_close(lse, lse_ref)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
    refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, causal, 128, window)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        _close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gqa_forward_and_dq_kernels(card, dtype):
    """B1 and B2 index-map GQA kv heads; B4 (GQA dk/dv) is not ported."""
    q, k, v, do = _inputs(card, 2, 192, 4, 2, 64, dtype, seed=1)
    o, lse = flash.flash_fwd(q, k, v, 0.125, True)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, 0.125, True, 0)
    _close(o, o_ref, dtype, "o")
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, 0.125, True)
    dq_ref = flash._plain_bwd_blhd(q, k, v, do, lse, delta, 0.125, True, 128, 0)[0]
    _close(dq, dq_ref, dtype, "dq")
    with pytest.raises(NotImplementedError, match="B4"):
        flash.flash_bwd_dkv(q, k, v, do, lse, delta, 0.125, True)
    with pytest.raises(NotImplementedError, match="B4"):
        flash.flash_attention(q.requires_grad_(), k, v, causal=True)


def test_check_rejects_planted_faults(card):
    """At the flagship length (L=2048, bf16), the kernels pass the check
    and every planted fault (a 64-wide key or query block left out, whose
    terms are small next to the largest entry) fails it."""
    q, k, v, do = _inputs(card, 1, 2048, 2, 2, 64, torch.bfloat16, seed=3)
    scale = 0.125
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    got = dict(o=o, dq=flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True))
    got["dk"], got["dv"] = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, 0)
    want = dict(zip(("dq", "dk", "dv"), flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale,
                                                              True, 128, 0)), o=o_ref)
    for name in want:
        _close(got[name], want[name], torch.bfloat16, name)
    limit = REL_LIMIT[torch.bfloat16]
    faults = planted_faults(q, k, v, do, lse, delta, scale, want["o"], want["dq"],
                            want["dk"], want["dv"])
    for fault in FAULTS:
        name, bad = faults[fault]
        worst = rel_errs(bad, want[name])[1]
        print(f"planted fault, {fault}: worst block {worst:.3g}")
        assert worst > limit, f"the check passed a planted fault: {fault} ({worst:.3g})"


def test_autograd_counts_launches(card):
    q, k, v, do = (x.requires_grad_() for x in _inputs(card, 1, 128, 2, 2, 64, torch.bfloat16))
    before = [kern.launches for kern in flash.KERNELS]
    o = flash.flash_attention(q, k, v, causal=True)
    o.backward(do)
    assert [kern.launches - n for kern, n in zip(flash.KERNELS, before)] == [1, 1, 1]


def test_xla_backward_takes_the_plain_arm(card):
    """backward="xla": the forward kernel, then the plain blocked backward
    on request (no dq/dk-dv launches), with the kernels' gradients."""
    q, k, v, do = _inputs(card, 1, 160, 2, 2, 64, torch.float32, seed=2)
    grads = {}
    for arm in ("xla", None):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = [kern.launches for kern in flash.KERNELS]
        flash.flash_attention(*leaves, causal=True, backward=arm).backward(do)
        launched = [kern.launches - n for kern, n in zip(flash.KERNELS, before)]
        assert launched == ([1, 0, 0] if arm == "xla" else [1, 1, 1])
        grads[arm] = [x.grad for x in leaves]
    for name, got, want in zip("qkv", grads["xla"], grads[None]):
        _close(got, want, torch.float32, f"d{name}")


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q, k, v, _ = _inputs(card, 1, 64, 2, 2, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_fwd(q, k, v, 0.1, True)
    q, k, v, _ = _inputs(card, 1, 64, 2, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 0.1, True)
    with pytest.raises(ValueError, match="dtype"):
        flash.flash_fwd(q.double(), k.double(), v.double(), 0.1, True)
    with pytest.raises(ValueError, match="on"):
        flash.flash_fwd(q, k.cpu(), v, 0.1, True)
