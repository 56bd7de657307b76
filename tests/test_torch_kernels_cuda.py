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
The wide family (head dims over 128) is held to the same plain versions;
its wgmma forward and backward (bf16, fp16, D <= 256) also to themselves,
bit for bit, across two calls.  The readings are printed (`-s` shows
them).  Four tests plant faults, a key or query block left out at L=2048
(MHA, and GQA for B4), a wide dk/dv partial left out of a key tile's sum,
and a wide forward warpgroup's rows left unwritten, and show the check
rejects them.  The error-feedback residual kernel is held to its
plain version bit for bit.
"""
from __future__ import annotations

import pytest
import torch

from _flash_faults import DKV_FAULTS, FAULTS, planted_dkv_faults, planted_faults
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


# With one key a row (L = 1, or window 1) P is 1 wherever a row attends,
# so dS = P (dP - delta) and with it dq and dk vanish in exact arithmetic:
# both sides hold only the rounding of dP - delta, so a relative error
# means nothing there.  A kernel that got P or dS wrong would leave entries
# of the size of dP itself (order one for these random inputs).
VANISH_ATOL = 1e-3


def _vanishes(got, want, what):
    err = max(got.float().abs().max().item(), want.float().abs().max().item())
    print(f"{what}: vanishes, largest entry {err:.3g}")
    assert err <= VANISH_ATOL, f"{what}: largest entry {err:.3g} > {VANISH_ATOL}"


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
    (1, 130, 2, 2, 64, True, 0),  # a last block whose second 64 rows are all past L
    (1, 200, 2, 2, 16, True, 0),  # narrow heads pad to 64 columns in shared memory
    (2, 256, 2, 2, 32, True, 96),
    (1, 333, 2, 2, 96, False, 0),  # and 96 to 128
    (1, 300, 2, 2, 96, True, 50),
    # the forward's tile edges: lengths on both sides of one and two
    # 64-row tiles, causal and not
    (2, 1, 2, 2, 64, True, 0),
    (2, 1, 2, 2, 64, False, 0),
    (1, 63, 2, 2, 64, True, 0),
    (1, 63, 2, 2, 64, False, 0),
    (1, 65, 2, 2, 128, True, 0),
    (1, 65, 2, 2, 128, False, 0),
    (1, 127, 2, 2, 32, True, 0),
    (1, 127, 2, 2, 32, False, 0),
    (1, 129, 2, 2, 64, True, 0),
    (1, 129, 2, 2, 64, False, 0),
    (1, 257, 2, 2, 128, True, 0),
    (1, 257, 2, 2, 128, False, 0),
    # windows of one key, one and two tiles either side, and wider than L
    (1, 300, 2, 2, 64, True, 1),
    (1, 300, 2, 2, 128, True, 64),
    (1, 300, 2, 2, 64, True, 65),
    (1, 300, 2, 2, 16, True, 128),
    (1, 300, 2, 2, 128, True, 129),
    (1, 300, 2, 2, 64, True, 400),
    # head dims that are multiples of 8 but not of 16, in the kernels
    # (fault C.1): a head of 8 is one 16-deep wgmma step, half of it zeros
    (1, 200, 2, 2, 8, True, 0),
    (2, 256, 2, 2, 24, True, 96),
    (1, 300, 2, 2, 40, False, 0),
    (1, 333, 2, 2, 72, True, 50),
    (1, 200, 2, 2, 120, True, 0),
    # and heads that are not, padded to the next multiple of 8 by the wrappers
    (1, 200, 2, 2, 12, True, 0),
    (1, 300, 2, 2, 100, True, 64),
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
    vanishing = ("dq", "dk") if l == 1 or window == 1 else ()
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        if name in vanishing:
            _vanishes(got, want, name)
        else:
            _close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "f32"])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_forward_kernel_takes_any_scale(card, dtype, scale):
    """The forward folds a positive scale into its exp and takes another
    path for a negative or zero one (uniform attention at 0)."""
    q, k, v, _ = _inputs(card, 1, 200, 2, 2, 64, dtype, seed=5)
    o, lse = flash.flash_fwd(q, k, v, scale, True, 0)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, 0)
    _close(o, o_ref, dtype, "o")
    _lse_close(lse, lse_ref)


GQA_CASES = [
    # (B, L, H, Hkv, D, causal, window)
    (2, 192, 4, 2, 64, True, 0),
    (1, 200, 4, 1, 64, True, 0),  # ragged, one kv head for four query heads
    (2, 256, 4, 2, 64, True, 96),  # sliding window
    (1, 333, 4, 2, 128, False, 0),
    (1, 200, 4, 2, 16, True, 0),
    (2, 256, 4, 2, 32, True, 96),
    (1, 333, 4, 1, 96, True, 0),
    (1, 200, 8, 1, 64, True, 0),  # a group of 8
    (1, 129, 8, 1, 128, False, 0),
    (2, 257, 8, 1, 64, True, 65),
    (1, 200, 4, 2, 8, True, 0),  # head dims of C.1, as in CASES
    (2, 256, 4, 2, 24, True, 96),
    (1, 300, 4, 1, 40, True, 50),
    (1, 333, 4, 2, 72, False, 0),
    (1, 200, 4, 2, 120, True, 64),
    (1, 200, 4, 2, 12, True, 0),
    (1, 300, 4, 1, 100, True, 50),
]


@pytest.mark.parametrize("d", [12, 100])
def test_padded_heads_launch_each_kernel_once(card, d):
    """A head dim that is not a multiple of 8 runs each kernel once, on
    copies padded to the next multiple, and returns the caller's width."""
    q, k, v, do = (x.requires_grad_() for x in _inputs(card, 1, 128, 2, 2, d, torch.bfloat16))
    before = [kern.launches for kern in flash.KERNELS]
    o = flash.flash_attention(q, k, v, causal=True)
    o.backward(do)
    assert o.shape == q.shape and o.is_contiguous()
    assert all(x.grad.shape == x.shape for x in (q, k, v))
    assert [kern.launches - n for kern, n in zip(flash.KERNELS, before)] == [1, 1, 1, 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "f32"])
@pytest.mark.parametrize("b,l,h,hkv,d,causal,window", GQA_CASES)
def test_gqa_forward_and_dq_kernels(card, dtype, b, l, h, hkv, d, causal, window):
    """B1 and B2 index-map the GQA kv heads; B4 sums each kv head's
    query-head group inside the block."""
    q, k, v, do = _inputs(card, b, l, h, hkv, d, dtype, seed=1)
    scale = d ** -0.5
    o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, causal, window)
    _close(o, o_ref, dtype, "o")
    _lse_close(lse, lse_ref)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    before = flash.FLASH_BWD_DKV_GQA.launches
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
    assert flash.FLASH_BWD_DKV_GQA.launches == before + 1
    refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, causal, 128, window)
    torch.cuda.synchronize()
    assert dk.shape == k.shape and dv.shape == v.shape
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        _close(got, want, dtype, name)


def test_check_rejects_planted_gqa_faults(card):
    """At the flagship length (L=2048, bf16, H=16, Hkv=8), B4 passes the
    check and every planted dk/dv fault fails it."""
    q, k, v, do = _inputs(card, 1, 2048, 16, 8, 64, torch.bfloat16, seed=4)
    scale = 0.125
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    got = dict(zip(("dk", "dv"), flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)))
    want = dict(zip(("dk", "dv"), flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True,
                                                        128, 0)[1:]))
    for name in want:
        _close(got[name], want[name], torch.bfloat16, name)
    limit = REL_LIMIT[torch.bfloat16]
    faults = planted_dkv_faults(q, k, v, do, lse, delta, scale, want["dk"], want["dv"])
    for fault in DKV_FAULTS:
        name, bad = faults[fault]
        worst = rel_errs(bad, want[name])[1]
        print(f"planted GQA fault, {fault}: worst block {worst:.3g}")
        assert worst > limit, f"the check passed a planted fault: {fault} ({worst:.3g})"


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


@pytest.mark.parametrize("hkv,want", [(2, [1, 1, 1, 0]), (1, [1, 1, 0, 1])], ids=["mha", "gqa"])
def test_autograd_counts_launches(card, hkv, want):
    q, k, v, do = (x.requires_grad_()
                   for x in _inputs(card, 1, 128, 2, hkv, 64, torch.bfloat16))
    before = [kern.launches for kern in flash.KERNELS]
    o = flash.flash_attention(q, k, v, causal=True)
    o.backward(do)
    assert [kern.launches - n for kern, n in zip(flash.KERNELS, before)] == want


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
        assert launched == ([1, 0, 0, 0] if arm == "xla" else [1, 1, 1, 0])
        grads[arm] = [x.grad for x in leaves]
    for name, got, want in zip("qkv", grads["xla"], grads[None]):
        _close(got, want, torch.float32, f"d{name}")


# The wide family (csrc/flash_wide.cu): head dims over 128; f32 and
# D > 256 on the slab body (an output slab of 128 columns a block, S and
# dP summed over 64-column chunks; 136 in f32 and 264 end in a narrow
# slab, 512 has four), bf16 and fp16 at D <= 256 on the wgmma forward and backward.  Against
# the plain versions in every dtype, causal or not, windowed, MHA
# (Hkv = H) and a group of all heads (Hkv = 1).
WIDE_CASES = [
    # (B, L, H, Hkv, D, causal, window)
    (1, 200, 2, 2, 136, True, 0),
    (1, 200, 4, 1, 136, False, 0),
    (2, 256, 2, 2, 192, True, 96),
    (1, 333, 4, 1, 192, True, 0),
    (1, 257, 2, 2, 256, False, 0),
    (1, 300, 4, 1, 256, True, 65),
    (1, 129, 2, 2, 264, True, 0),
    (1, 200, 4, 1, 264, True, 50),
    (1, 130, 2, 2, 512, True, 0),
    (1, 200, 4, 1, 512, False, 0),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "f32"])
@pytest.mark.parametrize("b,l,h,hkv,d,causal,window", WIDE_CASES)
def test_wide_kernels_match_plain(card, dtype, b, l, h, hkv, d, causal, window):
    q, k, v, do = _inputs(card, b, l, h, hkv, d, dtype, seed=d)
    scale = d ** -0.5
    assert flash.wide_head(d)
    before = [kern.launches for kern in flash.WIDE_KERNELS]
    rows = [kern.launches for kern in flash.KERNELS]
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
    # each wide kernel launched once, and counted for its B row
    assert [kern.launches - n for kern, n in zip(flash.WIDE_KERNELS, before)] == [1, 1, 1]
    assert [kern.launches - n for kern, n in zip(flash.KERNELS, rows)] == (
        [1, 1, 1, 0] if hkv == h else [1, 1, 0, 1])


# The wgmma backward of the wide family (bf16 and fp16 at head dims
# 136-256): a padded panel (136 in a 192-column tile), 192 (warpgroup 1
# owns one panel), 256; L not a multiple of 64; a window; non-causal; and
# Hkv = 1 under H = 8 at L >= 1024, where the dk/dv kernel splits the
# group over `parts` blocks whose partials meet in scratch.
WGMMA_CASES = [
    # (B, L, H, Hkv, D, causal, window)
    (1, 200, 2, 2, 136, True, 0),
    (1, 1000, 8, 1, 136, True, 100),
    (2, 333, 4, 4, 192, False, 0),
    (1, 1024, 8, 1, 192, True, 0),
    (1, 1090, 8, 2, 192, True, 257),
    (1, 257, 2, 2, 256, True, 65),
    (1, 1024, 8, 1, 256, True, 0),
    (1, 2000, 8, 1, 256, False, 0),
]


# The wgmma forward of the wide family (bf16 and fp16 at head dims
# 136-256: 128-row blocks, a warpgroup a 64-row half with its O across the
# head dim in registers, K/V by TMA) over the same cases.  L = 257 and 300
# with a window of 65 hold a block (q0 = 128) whose second warpgroup meets
# a first key tile wholly masked for its rows; L = 200, 333, 1090 end in a
# block whose second warpgroup's rows lie partly or wholly past L.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("b,l,h,hkv,d,causal,window", WGMMA_CASES)
def test_wide_wgmma_forward_matches_plain(card, dtype, b, l, h, hkv, d, causal, window):
    assert flash.wide_wgmma(d, dtype)
    q, k, v, _ = _inputs(card, b, l, h, hkv, d, dtype, seed=d + l + 1)
    scale = d ** -0.5
    before = [kern.launches for kern in flash.WIDE_KERNELS + flash.KERNELS]
    o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, causal, window)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _close(o, o_ref, dtype, "o")
    _lse_close(lse, lse_ref)
    launched = [kern.launches - n for kern, n in zip(flash.WIDE_KERNELS + flash.KERNELS, before)]
    assert launched == [1, 0, 0, 1, 0, 0, 0]  # flash_wide_fwd, counted for B1


@pytest.mark.parametrize("b,l,h,hkv,d,window", [(1, 1024, 8, 1, 256, 0), (1, 300, 4, 1, 256, 65),
                                                (2, 333, 4, 4, 192, 0)])
def test_wide_wgmma_forward_is_deterministic(card, b, l, h, hkv, d, window):
    """Two calls give the same bits: each block owns its rows, no atomics."""
    q, k, v, _ = _inputs(card, b, l, h, hkv, d, torch.bfloat16, seed=7)
    runs = [flash.flash_fwd(q, k, v, d ** -0.5, True, window) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b_ in zip(("o", "lse"), *runs):
        assert torch.equal(a, b_), f"{name} differs between two calls"


def test_wide_forward_check_rejects_a_missing_warpgroup(card):
    """A forward whose second warpgroup left its 64 rows of one block
    unwritten (zeros) fails the blockwise check."""
    b, l, h, hkv, d, dtype = 1, 1024, 8, 1, 256, torch.bfloat16
    q, k, v, _ = _inputs(card, b, l, h, hkv, d, dtype, seed=9)
    o, _ = flash.flash_fwd(q, k, v, d ** -0.5, True)
    o_ref, _ = flash._plain_fwd_blhd(q, k, v, d ** -0.5, True, 0)
    _close(o, o_ref, dtype, "o")
    for q0 in (0, 512, 896):  # the first, a middle and the last 128-row block
        bad = o.clone()
        bad[:, q0 + 64:q0 + 128] = 0
        worst = rel_errs(bad, o_ref)[1]
        print(f"planted fault, rows {q0 + 64}-{q0 + 127} unwritten: worst block {worst:.3g}")
        assert worst > REL_LIMIT[dtype], f"the check passed a missing warpgroup ({worst:.3g})"


def _wide_backward(q, k, v, do, causal, window):
    """(lse, delta, dq, dk, dv) of the wide kernels on these inputs, and
    the plain backward's (dq, dk, dv) from the same lse and delta."""
    scale = q.shape[-1] ** -0.5
    o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
    refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, causal, 128, window)
    torch.cuda.synchronize()
    return lse, delta, (dq, dk, dv), refs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("b,l,h,hkv,d,causal,window", WGMMA_CASES)
def test_wide_wgmma_backward_matches_plain(card, dtype, b, l, h, hkv, d, causal, window):
    assert flash.wide_wgmma(d, dtype)
    q, k, v, do = _inputs(card, b, l, h, hkv, d, dtype, seed=d + l)
    print(f"parts {flash.wide_dkv_parts(b, hkv, h // hkv, l)}")
    before = [kern.launches for kern in flash.WIDE_KERNELS]
    _, _, grads, refs = _wide_backward(q, k, v, do, causal, window)
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        _close(got, want, dtype, name)
    assert [kern.launches - n for kern, n in zip(flash.WIDE_KERNELS, before)] == [1, 1, 1]


@pytest.mark.parametrize("b,l,h,hkv,d", [(1, 1024, 8, 1, 256), (1, 1000, 8, 2, 136),
                                         (2, 333, 4, 4, 192)])
def test_wide_wgmma_backward_is_deterministic(card, b, l, h, hkv, d):
    """Two calls give the same bits: no atomics on an output, and the
    parts of a key tile summed in a fixed order whichever block is last."""
    q, k, v, do = _inputs(card, b, l, h, hkv, d, torch.bfloat16, seed=3)
    scale = d ** -0.5
    _, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = torch.randn(lse.shape, device=card)
    runs = [(flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True),
             *flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b_), f"{name} differs between two calls"


def test_wide_check_rejects_a_missing_partial(card):
    """A dk/dv that left one part's partial (here a query head: 8 parts of
    one at Hkv = 1, L = 1024) out of key tile 0's sum fails the blockwise
    check."""
    b, l, h, hkv, d, dtype = 1, 1024, 8, 1, 256, torch.bfloat16
    parts = flash.wide_dkv_parts(b, hkv, h // hkv, l)
    assert parts > 1
    q, k, v, do = _inputs(card, b, l, h, hkv, d, dtype, seed=5)
    lse, delta, (_, dk, dv), refs = _wide_backward(q, k, v, do, True, 0)
    for name, got, want in (("dk", dk, refs[1]), ("dv", dv, refs[2])):
        _close(got, want, dtype, name)
    part0 = slice(0, h // hkv // parts)  # the query heads of part 0
    do0, delta0 = do.clone(), delta.clone()
    do0[:, :, part0] = 0
    delta0[:, part0] = 0
    without = flash._plain_bwd_blhd(q, k, v, do0, lse, delta0, d ** -0.5, True, 128, 0)[1:]
    for name, want, rest in zip(("dk", "dv"), refs[1:], without):
        bad = want.float().clone()
        bad[:, :64] = rest[:, :64].float()
        worst = rel_errs(bad, want)[1]
        print(f"planted fault, {name} of key tile 0 without part 0: worst block {worst:.3g}")
        assert worst > REL_LIMIT[dtype], f"the check passed a missing partial ({worst:.3g})"


@pytest.mark.parametrize("d,wide", [(8, False), (64, False), (128, False), (120, False),
                                    (100, False), (129, True), (136, True), (256, True)])
def test_head_dim_takes_its_kernels(card, d, wide):
    """D <= 128 (padded to a multiple of 8 or not) keeps the four wgmma
    bodies; a wider head runs on the wide family, each kernel once a call."""
    q, k, v, do = (x.requires_grad_() for x in _inputs(card, 1, 128, 2, 1, d, torch.bfloat16))
    before = [kern.launches for kern in flash.WIDE_KERNELS + flash.KERNELS]
    o = flash.flash_attention(q, k, v, causal=True)
    o.backward(do)
    assert o.shape == q.shape and all(x.grad.shape == x.shape for x in (q, k, v))
    launched = [kern.launches - n for kern, n in zip(flash.WIDE_KERNELS + flash.KERNELS, before)]
    assert launched == ([1, 1, 1] if wide else [0, 0, 0]) + [1, 1, 0, 1]


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q, k, v, _ = _inputs(card, 1, 64, 2, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 0.1, True)
    with pytest.raises(ValueError, match="dtype"):
        flash.flash_fwd(q.double(), k.double(), v.double(), 0.1, True)
    with pytest.raises(ValueError, match="on"):
        flash.flash_fwd(q, k.cpu(), v, 0.1, True)
    unaligned = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)[1:].view_as(q)
    with pytest.raises(ValueError, match="aligned"):  # the kernels copy 16 bytes at a time
        flash.flash_fwd(unaligned, k, v, 0.1, True)


# The error-feedback residual kernel (csrc/ring.cu `ef_residual_kernel`)
# against its plain version, compression.quant.residual on the same card
# tensor: bit for bit, at sizes that end mid-block, with an all-zero block,
# values at the clamp and a start that is not 16-byte aligned.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("size", [1, 300, 65536, 1000003])
@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_ef_residual_kernel_matches_plain(card, scheme, block, size, offset):
    from kungfu_tpu_torch import compression as tc
    from kungfu_tpu_torch.compression import error_feedback as ef

    cfg = tc.CompressionConfig(scheme=scheme, block=block)
    g = torch.Generator(device=card).manual_seed(size + block)
    base = torch.randn(size + offset, generator=g, device=card)
    base *= torch.rand(size + offset, generator=g, device=card) * 50
    x = base[offset:]
    if size >= 4 * block:
        x[block:2 * block] = 0
        x[3 * block:4 * block] = 3.5
    want = tc.quant.residual(x, cfg)
    before = ef.EF_RESIDUAL.launches
    got = ef.residual_(x, cfg)
    assert got.data_ptr() == x.data_ptr() and ef.EF_RESIDUAL.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ef_residual_kernel_refuses_a_block_it_cannot_run(card):
    from kungfu_tpu_torch import compression as tc
    from kungfu_tpu_torch.compression import error_feedback as ef

    with pytest.raises(NotImplementedError, match="block 512"):
        ef.residual_(torch.ones(1024, device=card), tc.CompressionConfig(scheme="int8", block=512))


def _gqa_flagship_sizes():
    """The GQA flagship's 195 gradient sizes (FakeTensorMode: shapes only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from kungfu_tpu_torch.models import transformer as tt

    with FakeTensorMode():
        cfg = tt.TransformerConfig(**{**tt.FLAGSHIP_GPT, "dtype": torch.bfloat16,
                                      "attention": "flash", "n_kv_heads": 8})
        return [p.numel() for p in tt.TransformerLM(cfg, device="cpu").parameters()]


# The grouped residual (one launch over a table of tensors) against a
# launch per tensor, bit for bit: the GQA flagship's 195 gradients in one
# launch, and 600 small ragged tensors in the launches of `ef_plan`.
@pytest.mark.parametrize("sizes", ["flagship", "ragged"])
@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_ef_residual_grouped_matches_per_tensor(card, scheme, sizes):
    from kungfu_tpu_torch import compression as tc
    from kungfu_tpu_torch.compression import error_feedback as ef

    if sizes == "flagship":
        sizes = _gqa_flagship_sizes()
        assert len(sizes) == 195
    else:
        sizes = [1 + (97 * i) % 4099 for i in range(600)]
    cfg = tc.resolve(scheme)
    g = torch.Generator(device=card).manual_seed(len(sizes))
    xs = [torch.randn(n, generator=g, device=card) * 1e-2 for n in sizes]
    grouped = [x.clone() for x in xs]
    before = ef.EF_RESIDUAL.launches
    ef.residual_group_(grouped, cfg)
    assert ef.EF_RESIDUAL.launches - before == len(ef.ef_plan(sizes)) == -(-len(sizes) // 250)
    for x, got in zip(xs, grouped):
        one = ef.residual_(x.clone(), cfg)
        assert torch.equal(got.view(torch.int32), one.view(torch.int32))
