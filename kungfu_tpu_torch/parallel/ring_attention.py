"""Ring attention: sequence parallelism over a process group
(counterpart of kungfu_tpu.parallel.ring_attention).

The sequence is split over the ranks of a group (the mesh's sp axis),
each rank holding one chunk of q, k and v.  K/V blocks rotate around the
ring, one hop at a time, through the hand-written shift kernel B11
(`ops/fused_matmul.ring_shift_pair`: K and V of a hop in one launch), and
each rank folds the block it holds into its running attention, so the
whole sequence is never on one rank.  Call it on every rank of the group
with that rank's chunks:

    o = ring_attention(q, k, v, group=mesh.group("sp"))

Two ways to fold a block, as in the JAX package (`impl`):

  einsum  an online softmax over f32 scores (`_block_attn`), masked by
          absolute position; the default for CPU tensors
  flash   each hop's block through the flash kernels (`ops/flash.py`,
          B1-B3) with its log-sum-exp, merged into the running (o, lse)
          (`_merge_blocks`), differentiated through lse (the kernels fold
          the lse cotangent into delta); the default for CUDA tensors

Under a causal mask every block is whole: on rank r the block that came
from rank src < r is fully visible (the non-causal kernel), its own block
is the diagonal (the causal kernel), and blocks from src > r are fully
masked and skipped: no kernel, no merge (merging a skipped block, lse =
-1e30, leaves (o, lse) bit for bit as they were, which the tests hold
against the JAX package's skip branch).  So rank r computes r + 1 blocks
of the n a layer holds; rank 0 then waits in the shifts for the others.
That is the JAX package's schedule (no load-balanced layout).

`full_attention` is the one-process reference over the whole sequence.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..compat import kernel_mode
from ..ops.fused_matmul import ring_shift_pair

NEG_INF = -1e30
SKIP, FULL, DIAG = 0, 1, 2  # how a hop's block is folded (`_block_attn_flash`)


def _group_rank(group):
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _rotate_kv(k, v, group):
    """One ring hop of the K/V blocks: one launch of B11 for the pair (the
    JAX package's two `ring_shift` calls); its backward shifts (dk, dv)
    back by one."""
    return ring_shift_pair(k, v, group, 1)


def _block_attn(q, k, v, m, l, o, q_off: int, k_off: int, causal: bool, scale: float):
    """Fold one K/V block into the online-softmax accumulator.

    q: [B, Lq, H, D]; k, v: [B, Lk, Hkv, D] (grouped-query products
    against the un-repeated k/v); m, l: [B, H, Lq]; o: [B, Lq, H, D] f32;
    q_off, k_off: absolute positions of the blocks' first rows."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Lq, Hkv, G, D)
    s = torch.einsum("bqkgd,bmkd->bkgqm", qg.float(), k.float()).reshape(B, H, Lq, Lk) * scale
    if causal:
        q_pos = q_off + torch.arange(Lq, device=q.device)
        k_pos = k_off + torch.arange(Lk, device=q.device)
        s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    # operands in v's dtype, f32 accumulation
    pv = torch.einsum("bkgqm,bmkd->bqkgd", p.reshape(B, Hkv, G, Lq, Lk).to(v.dtype).float(),
                      v.float()).reshape(B, Lq, H, D)
    return m_new, l_new, o * corr.transpose(1, 2)[..., None] + pv


def _merge_blocks(o1, lse1, o2, lse2):
    """Combine two normalized attention outputs by their log-sum-exps.
    o: [B, L, H, D] f32; lse: [B, H, L]."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - lse).transpose(1, 2)[..., None]
    return o1 * w1 + o2 * w2, lse


def _block_attn_flash(q, k, v, mode: int, scale: float):
    """One hop's block on the flash kernels: (o [B, Lq, H, D] f32
    normalized, lse [B, H, Lq]).  `mode` SKIP (fully masked: o = 0, lse =
    -1e30, no kernel), FULL (the non-causal kernel) or DIAG (causal)."""
    from ..ops.flash import flash_attention_with_lse

    if mode == SKIP:
        z = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        return z, z[..., 0].transpose(1, 2) + NEG_INF
    o, lse = flash_attention_with_lse(q, k, v, causal=mode == DIAG, scale=scale)
    return o.float(), lse


class _KeepInGraph(torch.autograd.Function):
    """o, unchanged, with an edge to the last hop's k and v.  A rank whose
    last blocks are all skipped would otherwise leave the hops' shifts out
    of its backward, while its peers' backwards shift their cotangents to
    it: every rank must run every shift's backward, in the same order."""

    @staticmethod
    def forward(ctx, o, k, v):
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   causal: bool = True, scale: Optional[float] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Exact attention over a sequence split over the ranks of `group`.

    Per rank: q [B, L_chunk, H, D]; k, v [B, L_chunk, Hkv, D] with Hkv
    dividing H (they rotate un-repeated); rank i holds positions i *
    L_chunk onwards.  Returns [B, L_chunk, H, D] in q's dtype.  `impl`:
    "flash" (the default for CUDA tensors) or "einsum" (for CPU tensors)."""
    if impl is None:
        impl = "flash" if kernel_mode(q.device) == "kernel" else "einsum"
    if impl not in ("flash", "einsum"):
        raise ValueError(f"impl must be 'flash' or 'einsum', got {impl!r}")
    B, Lc, H, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if impl == "flash":
        return _ring_attention_flash(q, k, v, group, causal, scale)
    n, idx = _group_rank(group)
    q_off = idx * Lc
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lc), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        if s:
            k_cur, v_cur = _rotate_kv(k_cur, v_cur, group)
        # the block held at hop s came from rank (idx - s) mod n
        k_off = ((idx - s) % n) * Lc
        m, l, o = _block_attn(q, k_cur, v_cur, m, l, o, q_off, k_off, causal, scale)
    l = torch.where(l == 0.0, 1.0, l)  # fully masked rows stay 0
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _ring_attention_flash(q, k, v, group, causal: bool, scale: float):
    """The flash kernels as per-block compute: each hop's (o, lse) merges
    into the running pair, so the accumulator math stays outside the
    kernels and differentiable through lse."""
    n, idx = _group_rank(group)

    def mode_for(s: int) -> int:
        if not causal:
            return FULL
        src = (idx - s) % n  # the rank the held block came from
        return FULL if src < idx else DIAG if src == idx else SKIP

    # hop 0 is this rank's own block, never skipped; merging it into the
    # empty accumulator (o = 0, lse = -1e30) would leave it as it is
    o, lse = _block_attn_flash(q, k, v, mode_for(0), scale)
    k_cur, v_cur = k, v
    for s in range(1, n):
        k_cur, v_cur = _rotate_kv(k_cur, v_cur, group)
        mode = mode_for(s)
        if mode != SKIP:
            o, lse = _merge_blocks(o, lse, *_block_attn_flash(q, k_cur, v_cur, mode, scale))
    if n > 1 and torch.is_grad_enabled():
        o = _KeepInGraph.apply(o, k_cur, v_cur)
    return o.to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Plain attention on [B, L, H, D], scores in f32.

    GQA-native: k/v may carry Hkv < H heads (H % Hkv == 0); the grouped
    products contract against the un-repeated k/v.  `window` (causal only)
    masks each query to the last `window` positions."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, L, Hkv, G, D)
    s = torch.einsum("bqkgd,bmkd->bkgqm", qg.float(), k.float()) * scale
    pos = torch.arange(L, device=q.device)
    if causal:
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    if window:
        if window < 0:
            raise ValueError("window must be positive (None/0 = unlimited)")
        if not causal:
            raise ValueError("sliding window requires causal attention")
        s = torch.where(pos[:, None] - pos[None, :] < window, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(
        "bkgqm,bmkd->bqkgd", p.to(v.dtype).float(), v.float()
    ).reshape(B, L, H, D).to(q.dtype)
