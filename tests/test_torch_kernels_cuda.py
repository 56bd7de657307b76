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
The readings are printed (`-s` shows them).  Two tests plant faults, a
key or query block left out at L=2048 (MHA, and GQA for B4), and show the
check rejects them.  The error-feedback residual kernel is held to its
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


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    for d in (129, 144):
        q, k, v, do = _inputs(card, 1, 64, 2, 2, d, torch.bfloat16)
        lse = torch.zeros(1, 2, 64, device=card)
        with pytest.raises(NotImplementedError, match="ROADMAP C.1"):
            flash.flash_fwd(q, k, v, 0.1, True)
        with pytest.raises(NotImplementedError, match="ROADMAP C.1"):
            flash.flash_bwd_dq(q, k, v, do, lse, lse, 0.1, True)
        with pytest.raises(NotImplementedError, match="ROADMAP C.1"):
            flash.flash_bwd_dkv(q, k, v, do, lse, lse, 0.1, True)
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
