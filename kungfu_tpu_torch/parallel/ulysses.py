"""Ulysses sequence parallelism: the head <-> sequence reshard by
all_to_all (counterpart of kungfu_tpu.parallel.ulysses; the
DeepSpeed-Ulysses pattern).

Ring attention (parallel/ring_attention.py) keeps the sequence split and
rotates K/V around the ring.  Ulysses instead reshards twice:

    [B, L/n, H, D]  --all_to_all-->  [B, L, H/n, D]
        attention over the whole sequence for this rank's head group
    [B, L, H/n, D]  --all_to_all-->  [B, L/n, H, D]

Inside the head group the attention is plain flash attention over the
full sequence, so a causal mask needs no offsets.  Each exchange moves
1/n of the tensor a rank; a rank holds L x H/n x D of each of q, k, v.

The all_to_all is XLA's `lax.all_to_all` in the JAX package, not a Pallas
kernel, so here it is `torch.distributed.all_to_all_single`: NCCL where
each rank has a card of its own, and for a card's tensors on a gloo group
(ranks that share one card) through host memory, as
`ops.collective._staged` moves the compressed legs.  It is a
`torch.autograd.Function` whose backward is the inverse all_to_all.  Call
it on every rank of the group with that rank's chunks:

    o = ulysses_attention(q, k, v, group=mesh.group("sp"))
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops.collective import _staged


def _group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all over dim 0 of x [n, ...]: row j goes to rank j, and row
    j of the result came from rank j."""
    def a2a(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    return _staged(a2a, x.contiguous(), group)


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, L/n, H, D] -> [B, L, H/n, D]: split the heads, gather the
    sequence (lax.all_to_all(split_axis=2, concat_axis=1, tiled=True))."""
    B, Ls, H, D = x.shape
    parts = x.reshape(B, Ls, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = _exchange(parts, group)  # [n (source rank = sequence chunk), B, Ls, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Ls, H // n, D)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, L, H/n, D] -> [B, L/n, H, D]: the inverse reshard."""
    B, L, Hn, D = x.shape
    parts = x.reshape(B, n, L // n, Hn, D).permute(1, 0, 2, 3, 4)
    got = _exchange(parts, group)  # [n (source rank = head group), B, L/n, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, L // n, n * Hn, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _seq_to_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group, ctx.n), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _heads_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group, ctx.n), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                      causal: bool = True, scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Sequence-parallel attention by the head-dimension all_to_all.

    q: [B, L/n, H, D] on each rank of `group` (n ranks, the sequence split
    in rank order); k, v: [B, L/n, Hkv, D] with Hkv dividing H (GQA).
    Returns [B, L/n, H, D].  n must divide H (ValueError).  When n also
    divides Hkv the K/V exchanges move the Hkv heads and rank i's query
    heads meet its own kv-head chunk (query head i H/n + j belongs to kv
    head i Hkv/n + j // G); otherwise k and v are repeated up to H first.
    `attn_fn(q, k, v, causal=, scale=)` attends the head group over the
    whole sequence: by default `ops.flash.flash_attention` (B1, B2 and B3,
    B4 under GQA; its plain version for CPU tensors)."""
    n = _group_size(group)
    H, Hkv = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(f"the sp group's {n} ranks must divide n_heads={H}")
    if attn_fn is None:
        from ..ops.flash import flash_attention as attn_fn
    if Hkv != H and Hkv % n:  # kv heads that do not split over the group: repeat them
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    if n == 1:
        return attn_fn(q, k, v, causal=causal, scale=scale)
    qh, kh, vh = (_SeqToHeads.apply(t, group, n) for t in (q, k, v))
    return _HeadsToSeq.apply(attn_fn(qh, kh, vh, causal=causal, scale=scale), group, n)
