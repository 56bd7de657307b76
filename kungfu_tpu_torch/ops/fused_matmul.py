"""The one-hop ring shift on a hand-written CUDA kernel (counterpart of
kungfu_tpu/ops/fused_matmul.py `ring_shift`, whose kernel is
kungfu_tpu/ops/ring_kernels.py `make_shift_kernel`).

  ring_shift       csrc/ring.cu `ring_shift_kernel` replaces `make_shift_kernel` (B11)
  ring_shift_pair  the same kernel, two payloads in one launch

`ring_shift(x, group, shift)` is `lax.ppermute(x, axis, [(i, (i + shift)
% n)])` over a process group: rank d returns what rank (d - shift) mod n
passed.  It is differentiable: the backward shifts the cotangent by
-shift, as the JAX VJP does.  `ring_shift_pair(k, v, group, shift)` shifts
two tensors as one call and one autograd node, and its backward shifts
(dk, dv) as one launch: ring attention's K/V hop
(`parallel/ring_attention.py`).  Every rank must make the same calls in
the same order, forward and backward; a pair cannot be issued as k then v
on one rank and v then k on another.

A CUDA tensor goes to the kernel, which stores into rank + shift's
workspace (`peer_memory`, the "shift" kind) and reads its own; a CPU
tensor goes to the rank-local plain version, `dist.batch_isend_irecv` in
the group.  `_plain_ring_shift` is the stacked plain version (every rank's
payload in one process, `torch.roll`) that the card checks hold the kernel
against, bit for bit.  The payload moves as bytes, so every dtype and size
takes the kernel: the JAX package's fallback to `ppermute` (past its VMEM
budget, for other dtypes) has no counterpart.  n == 1, or a shift that is
a multiple of n, returns the input unchanged and launches nothing.

all_gather_matmul, matmul_reduce_scatter and the dma_* pair (B9, B10) are
not ported yet (ROADMAP B9/B10, A.6).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..compat import kernel_mode
from . import peer_memory
from .collective import _world
from .flash import Kernel
from .ring_collectives import _launch

SHIFT = Kernel("ring_shift", "kungfu_tpu_torch/ops/csrc/ring.cu",
               "kungfu_tpu/ops/ring_kernels.py:453")  # make_shift_kernel
KERNELS = (SHIFT,)

_THREADS, _UNROLL, _VEC = 512, 4, 16  # csrc/ring.cu kThreads, kUnroll, 16-byte vectors


def _plain_ring_shift(stacked: torch.Tensor, shift: int) -> torch.Tensor:
    """Every rank's result at once: stacked[r] is rank r's payload, row d
    of the result what rank d receives."""
    return torch.roll(stacked, shift, dims=0)


def _exchange(xs: Sequence[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    """The rank-local plain version: send each payload to rank + shift,
    receive each from rank - shift, over the group."""
    n, d = dist.get_world_size(group), dist.get_rank(group)

    def glob(r):
        return dist.get_global_rank(group, r) if group is not None else r

    dst, src = glob((d + shift) % n), glob((d - shift) % n)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for tag, (x, out) in enumerate(zip(xs, outs)):
        ops += [dist.P2POp(dist.isend, x, dst, group, tag),
                dist.P2POp(dist.irecv, out, src, group, tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % _VEC == 0 else x.clone()


def _kernel_shift(xs: Sequence[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    """B11 on one or two CUDA payloads (any dtypes and sizes)."""
    device = xs[0].device
    if any(x.device != device for x in xs):
        raise ValueError(f"ring_shift: every payload must be on {device}")
    xs = [_aligned(x) for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    nbytes = [x.numel() * x.element_size() for x in xs] + [0]
    off1 = -(-nbytes[0] // _VEC) * _VEC
    total = off1 + nbytes[1]
    ws = peer_memory.workspace(group, device)
    ws.raise_if_failed()
    ws.reserve(shift_slot_bytes=total)
    blocks = max(1, min(ws.max_blocks, -(-total // (_VEC * _THREADS * _UNROLL))))
    ptrs = [(x.data_ptr(), o.data_ptr()) for x, o in zip(xs, outs)] + [(None, None)]
    shift %= ws.n
    _launch(SHIFT, "kft_ring_shift", ws, "shift", device, total, blocks,
            (*ptrs[0], nbytes[0], *ptrs[1], nbytes[1], shift), peer=shift)
    return outs


def _shift(xs: Sequence[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    if kernel_mode(xs[0].device) == "plain":
        return _exchange(xs, group, shift)
    return _kernel_shift(xs, group, shift)


class _RingShift(torch.autograd.Function):
    """One shift of one or two payloads; the backward shifts the
    cotangents by -shift, as one call."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return tuple(_shift(xs, group, shift))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_shift(gs, ctx.group, -ctx.shift))


def _apply(xs: Tuple[torch.Tensor, ...], group, shift: int) -> Tuple[torch.Tensor, ...]:
    n = _world(group)
    if n == 1 or shift % n == 0:
        return xs
    return _RingShift.apply(group, shift, *xs)


def ring_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Rank d returns x of rank (d - shift) mod n (B11 on a card)."""
    return _apply((x,), group, shift)[0]


def ring_shift_pair(x: torch.Tensor, y: torch.Tensor, group=None, shift: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ring_shift` of two tensors as one call (one launch of B11 forward,
    one backward): the same result as two calls."""
    return _apply((x, y), group, shift)
