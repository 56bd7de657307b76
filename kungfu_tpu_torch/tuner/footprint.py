"""Footprint defaults (counterpart of kungfu_tpu/tuner/footprint.py).

Only `default_ce_block` is ported: the shape rule that sizes the vocab
block of the chunked lm-head loss (`ops.chunked_ce`).  The rest of the
module (the HBM footprint model, peak specs, bucket sizes) is ROADMAP A.8.
"""
from __future__ import annotations

from typing import Optional


def default_ce_block(n_tokens: Optional[int] = None,
                     vocab: Optional[int] = None) -> int:
    """The chunked-CE vocab block: stream about 64 MiB of f32 logits a
    block, a power of two clamped to [512, 8192] and halved (not below
    512) while it exceeds the vocab.  With no token count known, 2048."""
    if not n_tokens or n_tokens <= 0:
        return 2048
    target = (64 << 20) // (4 * n_tokens)
    block = 512
    while block * 2 <= target and block < 8192:
        block *= 2
    if vocab:
        while block > vocab and block > 512:
            block //= 2
    return block
