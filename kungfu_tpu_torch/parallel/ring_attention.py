"""Attention without kernels (counterpart of kungfu_tpu.parallel.ring_attention).

Only `full_attention`, the `attention="full"` path, ports in this slice;
ring attention itself (sequence parallelism over ranks) waits for the ring
shift kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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
