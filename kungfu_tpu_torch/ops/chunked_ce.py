"""Chunked lm-head cross-entropy: the loss without [N, V] logits
(counterpart of kungfu_tpu/ops/chunked_ce.py).

The head product and an online log-softmax stream over vocab blocks, the
running max and sum that flash attention keeps along the sequence axis
kept here along the vocab axis, and the backward recomputes each block's
logits instead of saving them.  At the flagship's shape (8 x 2047
positions, vocab 32000) the dense head's f32 logits are 2.1 GB, and the
dense backward makes a gradient of the same size; a block of 1024 columns
is 67 MB.  The weight gradient stays [V, D]: it is the gradient.

The head weight is [V, D] here, as `models.transformer._Head` and the
tied embedding store it (the JAX package's kernel is [D, V]): a block is
a slice of rows, and the products take its transposed view, never a copy.
The last block is the remainder of V rows, where the JAX package pads the
weight to whole blocks and masks the padded columns with NEG_INF: those
columns add exact zeros to the sums, so the two agree up to the order of
f32 sums.  The block products are plain torch.matmul, as the JAX package
leaves them to XLA; no TPU kernel computes this.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..tuner.footprint import default_ce_block

NEG_INF = -1e30


def resolve_ce_block(block: Optional[int], n_tokens: Optional[int] = None,
                     vocab: Optional[int] = None) -> int:
    """The vocab block the streaming head runs with: an explicit int wins;
    else the KFT_CE_BLOCK environment variable (a malformed value falls
    through); else the footprint default (`tuner.footprint.default_ce_block`:
    about 64 MiB of f32 logits a block, in [512, 8192])."""
    if block:
        return int(block)
    env = os.environ.get("KFT_CE_BLOCK", "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return default_ce_block(n_tokens, vocab)


class _ChunkedLMHeadLL(torch.autograd.Function):
    """(ll, log_z) of `chunked_lm_head_ll`; saves h, w, targets and log_z,
    nothing of size N x V."""

    @staticmethod
    def forward(ctx, h, w, targets, block: int):
        hf = h.float()
        n, vocab = hf.shape[0], w.shape[0]
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=h.device)
        s = torch.zeros(n, dtype=torch.float32, device=h.device)
        tl = torch.full((n,), NEG_INF, dtype=torch.float32, device=h.device)
        for j0 in range(0, vocab, block):
            w_j = w[j0:j0 + block].float()
            logits = hf @ w_j.T  # [N, block] f32
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
            m = m_new
            in_blk = (targets >= j0) & (targets < j0 + w_j.shape[0])
            idx = (targets - j0).clamp(0, w_j.shape[0] - 1)
            tl = torch.where(in_blk, logits.gather(1, idx[:, None])[:, 0], tl)
        log_z = m + torch.log(s)
        ctx.save_for_backward(h, w, targets, log_z)
        ctx.block = block
        return tl - log_z, log_z

    @staticmethod
    def backward(ctx, d_ll, d_logz):
        # ll = tl - log_z:  d ll / d logits = onehot - p, d log_z / d logits = p,
        # so dlogits = d_ll * onehot + (d_logz - d_ll) * p, a block at a time
        h, w, targets, log_z = ctx.saved_tensors
        hf = h.float()
        dh = torch.zeros(hf.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        coef = (d_logz - d_ll)[:, None]
        for j0 in range(0, w.shape[0], ctx.block):
            w_j = w[j0:j0 + ctx.block].float()
            p = torch.exp(hf @ w_j.T - log_z[:, None])  # [N, block]
            in_blk = (targets >= j0) & (targets < j0 + w_j.shape[0])
            idx = (targets - j0).clamp(0, w_j.shape[0] - 1)
            dlogits = (coef * p).scatter_add_(1, idx[:, None], (d_ll * in_blk)[:, None])
            dh += dlogits @ w_j
            dw[j0:j0 + w_j.shape[0]] = dlogits.T @ hf
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def chunked_lm_head_ll(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                       block: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming log-likelihood of `targets` under softmax(h @ w^T).

    h: [N, D] of any float dtype (the products run in f32, as the dense
    head's), w: [V, D], targets: [N] integers.  `block=None` resolves the
    vocab block through `resolve_ce_block`.  Returns (ll [N] f32, log_z
    [N] f32): the target's log-probability and the log normalizer (for the
    z-loss), as the dense `_token_ll` does.  The gradient of h comes back
    in h's dtype and that of w in w's."""
    block = resolve_ce_block(block, int(h.shape[0]), int(w.shape[0]))
    return _ChunkedLMHeadLL.apply(h, w, targets.long(), block)
