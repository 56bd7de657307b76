"""Ulysses attention against flash attention over the gathered sequence.

Every rank of the group makes the same q, k, v and output cotangent over
the whole sequence from one seed, so each holds what a gather of the
ranks' chunks would give it.  It runs `parallel.ulysses_attention` on its
chunk of the sequence and `ops.flash.flash_attention` on the whole; the
output and dq, dk, dv of its chunk are held against the whole run's rows
of that chunk by `utils.compare.rel_errs` (normwise relative error, worst
over 64-row blocks) to `utils.compare.REL_LIMIT` of the dtype, the flash
kernels' own gate against their plain versions.  Both sides run the same
kernels on each head over the whole sequence, so the readings are near 0
(exactly 0 in f32 on the CPU); a query head paired with the wrong kv head,
or the output put back a chunk late, reads above 1 there
(tests/test_torch_ulysses.py plants both).

    errs = against_flash(group, 2, 8192, 16, 8, 64)  # on every rank of group
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..ops.flash import flash_attention
from ..parallel.ulysses import ulysses_attention
from ..utils.compare import rel_errs

OUTS = ("o", "dq", "dk", "dv")


def _run(attn: Callable, q, k, v, w):
    """attn's output and the gradients of sum(out * w) by q, k and v."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = attn(q, k, v)
    out.backward(w)
    return out.detach(), q.grad, k.grad, v.grad


def against_flash(group, batch: int, seq_len: int, n_heads: int, kv_heads: int, head_dim: int,
                  seed: int = 0, dtype: torch.dtype = torch.bfloat16, device="cuda",
                  causal: bool = True,
                  attn_fn: Optional[Callable] = None) -> Dict[str, float]:
    """The worst-block normwise relative error of this rank's output, dq,
    dk and dv under `ulysses_attention(..., group, attn_fn=attn_fn)`
    against `flash_attention` over the whole sequence.  Call it on every
    rank of `group`; seq_len is the whole sequence."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(heads):
        return torch.randn(batch, seq_len, heads, head_dim, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    q, k, v, w = make(n_heads), make(kv_heads), make(kv_heads), make(n_heads)
    rows = slice(r * seq_len // n, (r + 1) * seq_len // n)
    whole = _run(lambda a, b, c: flash_attention(a, b, c, causal=causal), q, k, v, w)
    mine = _run(lambda a, b, c: ulysses_attention(a, b, c, group=group, causal=causal,
                                                  attn_fn=attn_fn),
                *(t[:, rows] for t in (q, k, v, w)))
    return {name: rel_errs(got, want[:, rows])[1] for name, got, want in zip(OUTS, mine, whole)}
