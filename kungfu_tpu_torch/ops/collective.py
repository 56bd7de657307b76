"""Plain ring collectives over torch.distributed point-to-point
(counterpart of kungfu_tpu/ops/collective.py `ring_all_reduce` and
`rs_ag_all_reduce`).

Rank-local rings, for CPU tensors over gloo: each hop sends one chunk to
the right neighbour and receives one from the left, and the partial that
travels is `own chunk + received`, as in the JAX package.  Two chunk
schedules exist there and both are kept:

  owner 0   rank d ends the reduce-scatter with chunk d: the Pallas ring
            kernels' schedule (`ring_kernels.make_rs_kernel`), whose plain
            version this is (`ring_collectives` runs it for CPU tensors)
  owner 1   rank d ends with chunk d+1: the lax ring of
            `collective.ring_all_reduce` (impl="ring")

The association of each element's sum follows from the schedule (chunk c
summed as ((x_{c+o} + x_{c+o+1}) + ...) around the ring), so the two give
different roundings for n > 2 and each matches its JAX counterpart bit for
bit.

The fused-codec ring (`fused_ring_all_reduce_chunks`) is the plain
version of the ring kernels B7/B8: the same schedule, but each hop carries
int8/fp8 codes plus one f32 scale per quantization block, requantized at
every reduce-scatter hop (own chunk + received codes * scales, one fused
multiply-add per element, as XLA computes the reference kernels), and the
all-gather forwards the codes of each reduced chunk, quantized once.

The stacked versions at the bottom (`_plain_ring_*`,
`_plain_fused_ring_all_reduce`) take every rank's input in one process and
return every rank's output, with the kernels' association and codec; the
card checks hold each rank's kernel result against them.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..compression.config import CompressionConfig
from ..compression.quant import (QTensor, add_dequantized, dequantize, from_wire, quantize,
                                 to_wire)

TILE = 1024  # chunk padding unit of the Pallas ring (8 x 128 lanes)


def host_staged(fn, out: torch.Tensor, x: torch.Tensor, group) -> None:
    """The torch.distributed collective `fn(out, x, group=group)`, through
    host memory for a card's tensors on gloo (ranks that share a card,
    where NCCL refuses the group)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = out.cpu()
        fn(host, x.cpu(), group=group)
        out.copy_(host)
    else:
        fn(out, x, group=group)


def _chunk_elems(total: int, n: int, multiple: int = TILE) -> int:
    """Per-chunk element count: ceil(total/n) padded up to `multiple`
    (pallas_collectives._chunk_elems)."""
    per = -(-total // n)
    return -(-per // multiple) * multiple


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _neighbours(group):
    n, d = dist.get_world_size(group), dist.get_rank(group)

    def glob(r):
        return dist.get_global_rank(group, r) if group is not None else r

    return n, d, glob((d + 1) % n), glob((d - 1) % n)


def _exchange(send: torch.Tensor, recv: torch.Tensor, right: int, left: int, group) -> None:
    reqs = [dist.isend(send.contiguous(), right, group=group),
            dist.irecv(recv, left, group=group)]
    for r in reqs:
        r.wait()


def ring_reduce_scatter_chunks(chunks: Sequence[torch.Tensor], group=None,
                               owner: int = 0) -> torch.Tensor:
    """Rank d's n same-shaped contributions -> the ring sum of chunk
    (d + owner) mod n, in n-1 hops."""
    n, d, right, left = _neighbours(group)
    recv = None
    for s in range(n - 1):
        c = (d - s - 1 + owner) % n
        payload = chunks[c] if recv is None else chunks[c] + recv
        recv = torch.empty_like(payload)
        _exchange(payload, recv, right, left, group)
    return chunks[(d + owner) % n] + recv


def ring_all_gather_chunks(mine: torch.Tensor, group=None, owner: int = 0
                           ) -> List[torch.Tensor]:
    """Rank d holds chunk (d + owner) mod n; returns all n chunks in order,
    forwarding chunk (d + owner - s) mod n at hop s."""
    n, d, right, left = _neighbours(group)
    out: List[Optional[torch.Tensor]] = [None] * n
    out[(d + owner) % n] = mine
    for s in range(n - 1):
        recv = torch.empty_like(mine)
        _exchange(out[(d + owner - s) % n], recv, right, left, group)
        out[(d + owner - s - 1) % n] = recv
    return out


def fused_chunk_elems(total: int, n: int, cfg: CompressionConfig) -> int:
    """Chunk of the fused-codec ring: ceil(total/n) padded to a multiple of
    lcm(block, 1024), so every chunk holds whole quantization blocks."""
    return _chunk_elems(total, n, math.lcm(cfg.block, TILE))


def fused_ring_all_reduce_chunks(chunks: torch.Tensor, group, cfg: CompressionConfig,
                                 op: str = "sum") -> torch.Tensor:
    """Rank d's (n, chunk) f32 contributions -> every chunk's reduced f32
    values (n * chunk), through the fused-codec ring of the kernels B7/B8:
    rank d ends the reduce-scatter with chunk d; op "mean" multiplies it
    by 1/n before the all-gather quantizes it."""
    n, d, right, left = _neighbours(group)
    recv = None
    for s in range(n - 1):
        c = (d - s - 1) % n
        payload = chunks[c] if recv is None else add_dequantized(chunks[c], recv)
        sent = quantize(payload, cfg)
        codes, scale = torch.empty_like(to_wire(sent.data)), torch.empty_like(sent.scale)
        _exchange(to_wire(sent.data), codes, right, left, group)
        _exchange(sent.scale, scale, right, left, group)
        recv = QTensor(from_wire(codes, cfg), scale)
    mine = add_dequantized(chunks[d], recv)
    if op == "mean":
        mine = mine * (1.0 / n)
    q = quantize(mine, cfg)
    codes = ring_all_gather_chunks(to_wire(q.data).contiguous(), group)
    scales = ring_all_gather_chunks(q.scale.contiguous(), group)
    return torch.cat([dequantize(QTensor(from_wire(c, cfg), s)) for c, s in zip(codes, scales)])


def _padded_chunks(x: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, n * chunk - flat.numel())).view(n, chunk)


def _ring(x: torch.Tensor, group, chunk: int, owner: int) -> torch.Tensor:
    n = _world(group)
    if n == 1:
        return x
    chunks = _padded_chunks(x, n, chunk)
    mine = ring_reduce_scatter_chunks(chunks, group, owner)
    full = torch.cat(ring_all_gather_chunks(mine, group, owner))
    return full[:x.numel()].view(x.shape)


def ring_all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The lax ring (impl="ring"): pad to a multiple of n, reduce-scatter
    then all-gather in 2(n-1) hops, rank d owning chunk d+1."""
    if op != "sum":
        raise NotImplementedError(f"ring_all_reduce op={op!r}: only 'sum' is ported "
                                  "(other ops wait for the Session collectives, ROADMAP A4)")
    n = _world(group)
    return _ring(x, group, -(-x.numel() // n), owner=1)


def rs_ag_all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Reduce-scatter then all-gather (impl="rs_ag"): the same padding to a
    multiple of n, rank d owning chunk d as psum_scatter does; the sum runs
    around the ring, where XLA picks its own order."""
    if op != "sum":
        raise NotImplementedError(f"rs_ag_all_reduce op={op!r}: only 'sum' is ported "
                                  "(other ops wait for the Session collectives, ROADMAP A4)")
    n = _world(group)
    return _ring(x, group, -(-x.numel() // n), owner=0)


# ------------------------------------------------- stacked plain versions --
# All n ranks' inputs in, all n ranks' outputs out, in one process: the
# ring kernels' schedule written as sums (no communication).

def _ring_sum(parts: Sequence[torch.Tensor], chunk: int) -> torch.Tensor:
    """The ring's sum of chunk `chunk` from every rank's part, in the order
    the reduce-scatter adds them: ((p[c+1] + p[c+2]) + ...) + p[c]."""
    n = len(parts)
    acc = parts[(chunk + 1) % n]
    for k in range(2, n + 1):
        acc = acc + parts[(chunk + k) % n]
    return acc


def _plain_ring_reduce_scatter(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """xs[r]: rank r's input (n, ...); returns rank d's x.shape[1:] sums."""
    n = len(xs)
    return [_ring_sum([x[d] for x in xs], d) for d in range(n)]


def _plain_ring_all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """xs[r]: rank r's input; every rank returns (n, *x.shape)."""
    full = torch.stack(list(xs))
    return [full] * len(xs)


def _plain_ring_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum"
                           ) -> List[torch.Tensor]:
    """The Pallas-chunked ring all-reduce of every rank's x (op "sum" or
    "mean"); every rank returns the same tensor."""
    n, x0 = len(xs), xs[0]
    size = x0.numel()
    chunk = _chunk_elems(size, n)
    flats = [x.reshape(-1) for x in xs]
    out = torch.empty(size, dtype=x0.dtype, device=x0.device)
    for c in range(n):  # the padding adds zeros past the end: leave it out
        part = slice(c * chunk, min(size, (c + 1) * chunk))
        if part.start < part.stop:
            out[part] = _ring_sum([f[part] for f in flats], c)
    out = out.view(x0.shape)
    if op == "mean":
        out = out * (1.0 / n)
    return [out] * n


def _plain_fused_ring_all_reduce(xs: Sequence[torch.Tensor], cfg: CompressionConfig,
                                 op: str = "sum") -> List[torch.Tensor]:
    """The fused-codec ring all-reduce (B7 then B8) of every rank's x, in
    x's dtype; every rank returns the same tensor.  Chunk c is quantized
    first by rank c+1, requantized with each later rank's part added, and
    completed in f32 by rank c; the mean times 1/n; then quantized once."""
    n, x0 = len(xs), xs[0]
    size = x0.numel()
    chunk = fused_chunk_elems(size, n, cfg)
    flats = [x.reshape(-1) for x in xs]
    out = torch.empty(size, dtype=x0.dtype, device=x0.device)
    for c in range(n):  # one chunk of every rank's payload at a time
        part = slice(c * chunk, min(size, (c + 1) * chunk))
        if part.start >= part.stop:
            continue
        parts = [F.pad(f[part].float(), (0, chunk - (part.stop - part.start))) for f in flats]
        q = quantize(parts[(c + 1) % n], cfg)
        for k in range(2, n):
            q = quantize(add_dequantized(parts[(c + k) % n], q), cfg)
        mine = add_dequantized(parts[c], q)
        if op == "mean":
            mine = mine * (1.0 / n)
        out[part] = dequantize(quantize(mine, cfg))[:part.stop - part.start].to(x0.dtype)
    return [out.view(x0.shape)] * n
