"""Collectives over a torch.distributed process group (counterpart of
kungfu_tpu/ops/collective.py).

The JAX module's primitives run inside shard_map over a mesh axis; here
each takes this rank's tensor and a process group (None: the world) and
returns this rank's result, with the JAX semantics:

  all_reduce               one-shot: torch.distributed's all_reduce for
                           sum/min/max (its backend picks the order); mean
                           is the sum times 1/n; prod an all_gather, then
                           the product in rank order
  ring_all_reduce          the lax ring (RING): sum only, other ops one-shot
  rs_ag_all_reduce         reduce-scatter + all-gather (CLIQUE, MULTI_STAR):
                           sum only, other ops one-shot
  hierarchical_all_reduce  (BINARY_TREE_STAR) ici reduce-scatter, dcn
                           all-reduce, ici all-gather; other ops one-shot
                           over ici, then over dcn
  cross_all_reduce         the one-shot over the dcn group alone
  broadcast, all_gather, reduce, gather, barrier, consensus

A list of tensors is reduced by `Session.group_all_reduce`.

`broadcast` is the root's tensor plus zero: the JAX package's mask and sum
(`psum(where(idx == root, x, 0))`), which turns a root's -0.0 into +0.0
and keeps every other value, bit for bit.  `reduce` and `gather` compute
on every rank, as the JAX ones do, and return zeros off the root.

gloo has no point-to-point for a card's tensors, and its collectives on
them are not all there on every release: a card's tensor on a gloo group
(ranks that share one card) goes through host memory (`host_staged`,
`_staged`).

The rings are rank-local: each hop sends one chunk to the right
neighbour and receives one from the left, and the partial that travels
is `own chunk + received`, as in the JAX package.  Two chunk schedules
exist there and both are kept:

  owner 0   rank d ends the reduce-scatter with chunk d: the Pallas ring
            kernels' schedule (`ring_kernels.make_rs_kernel`), whose plain
            version this is (`ring_collectives` runs it for CPU tensors),
            and rs_ag_all_reduce's (psum_scatter gives rank d chunk d)
  owner 1   rank d ends with chunk d+1: the lax ring of
            `collective.ring_all_reduce` (impl="ring")

The association of each element's sum follows from the schedule (chunk c
summed as ((x_{c+o} + x_{c+o+1}) + ...) around the ring), so the two give
different roundings for n > 2 and each matches its JAX counterpart bit for
bit (rs_ag's: where XLA's order is the ring's).

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
from typing import Callable, List, Optional, Sequence

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
    if _gloo_card(x, group):
        host = out.cpu()
        fn(host, x.cpu(), group=group)
        out.copy_(host)
    else:
        fn(out, x, group=group)


def _gloo_card(x: torch.Tensor, group) -> bool:
    """A card's tensor on a gloo group: it goes through host memory."""
    return x.is_cuda and dist.is_initialized() and dist.get_backend(group) == "gloo"


def _staged(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
            *groups) -> torch.Tensor:
    """fn(x), or for a card's tensor on a gloo group fn of its host copy,
    the result moved back to the card."""
    if any(_gloo_card(x, g) for g in groups):
        return fn(x.cpu()).to(x.device)
    return fn(x)


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
    then all-gather in 2(n-1) hops, rank d owning chunk d+1.  Ops other
    than sum take the one-shot `all_reduce`, as in the JAX package."""
    if op != "sum":
        return all_reduce(x, group, op)
    n = _world(group)
    if n == 1:
        return x
    return _staged(lambda t: _ring(t, group, -(-t.numel() // n), owner=1), x, group)


def rs_ag_all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Reduce-scatter then all-gather (impl="rs_ag"): the same padding to a
    multiple of n, rank d owning chunk d as psum_scatter does; the sum runs
    around the ring, where XLA picks its own order.  Ops other than sum
    take the one-shot `all_reduce`."""
    if op != "sum":
        return all_reduce(x, group, op)
    n = _world(group)
    if n == 1:
        return x
    return _staged(lambda t: _ring(t, group, -(-t.numel() // n), owner=0), x, group)


# --------------------------------------------------- one-shot collectives --
# Reference op set: srcs/go/kungfu/base/op.go:20-37 (SUM/MIN/MAX/PROD).

OPS = ("sum", "min", "max", "mean", "prod")
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _staged_inplace(fn, t: torch.Tensor, group, **kw) -> None:
    """fn(t, group=group, **kw) in place, through host memory for a card's
    tensor on a gloo group."""
    if _gloo_card(t, group):
        host = t.cpu()
        fn(host, group=group, **kw)
        t.copy_(host)
    else:
        fn(t, group=group, **kw)


def _times_recip(x: torch.Tensor, n: int) -> torch.Tensor:
    """x times 1/n (the mean of a sum; an integer sum becomes floating, as
    the JAX package's `psum / n` does)."""
    return x.mul_(1.0 / n) if x.is_floating_point() else x * (1.0 / n)


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """One-shot all-reduce; op in sum, min, max, mean, prod.  The mean is
    the sum times 1/n; prod gathers every rank's tensor and multiplies
    them in rank order (the JAX package has no pprod either)."""
    if op not in OPS:
        raise ValueError(f"unknown reduce op {op!r}; one of {OPS}")
    n = _world(group)
    if n == 1:
        return x
    if op == "prod":
        return torch.prod(all_gather(x, group), dim=0, dtype=x.dtype)
    out = x.clone()
    _staged_inplace(dist.all_reduce, out, group, op=_REDUCE_OPS.get(op, dist.ReduceOp.SUM))
    return _times_recip(out, n) if op == "mean" else out



def hierarchical_all_reduce(x: torch.Tensor, ici_group, dcn_group, op: str = "sum"
                            ) -> torch.Tensor:
    """Two-level all-reduce: reduce-scatter within the host (ici), the
    all-reduce of this rank's shard across hosts (dcn), all-gather within
    the host.  Every local rank carries 1/L of the cross-host traffic
    (reference: local NCCL reduce, cross-host all-reduce, local broadcast,
    nccl/controller.cpp:8-40).  Ops other than sum: the one-shot over ici,
    then over dcn."""
    if op != "sum":
        return all_reduce(all_reduce(x, ici_group, op), dcn_group, op)

    def run(t: torch.Tensor) -> torch.Tensor:
        n = _world(ici_group)
        chunks = _padded_chunks(t, n, -(-t.numel() // n))
        mine = chunks[0] if n == 1 else ring_reduce_scatter_chunks(chunks, ici_group)
        cross = all_reduce(mine, dcn_group, "sum")
        full = cross if n == 1 else torch.cat(ring_all_gather_chunks(cross, ici_group))
        return full[:t.numel()].view(t.shape)

    return _staged(run, x, ici_group, dcn_group)


def cross_all_reduce(x: torch.Tensor, dcn_group, op: str = "sum") -> torch.Tensor:
    """Cross-host-only all-reduce (reference session/allreduce.go:38
    CrossAllReduce): the reduction over the dcn group alone, leaving the
    ranks of a host unmixed; each local rank reduces with its counterparts
    on the other hosts."""
    return all_reduce(x, dcn_group, op)


def _global_rank(group, r: int) -> int:
    return dist.get_global_rank(group, r) if group is not None else r


def broadcast(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """The root's tensor on every rank (`root` a rank of the group), plus
    zero: the JAX package's mask and sum, so a root's -0.0 arrives as +0.0
    (see the module docstring)."""
    if _world(group) == 1:
        return x + 0 if x.dtype != torch.bool else x.clone()
    out = x.clone()
    _staged_inplace(dist.broadcast, out, group, src=_global_rank(group, root))
    return out + 0 if out.dtype != torch.bool else out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's tensor stacked on a new leading dim: (n, *x.shape) in
    rank order (reference session/allgather.go:17-45)."""
    n = _world(group)
    if n == 1:
        return x[None]
    flat = x.reshape(-1).contiguous()
    out = flat.new_empty(n * flat.numel())
    host_staged(dist.all_gather_into_tensor, out, flat, group)
    return out.view((n,) + tuple(x.shape))


def _rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def reduce(x: torch.Tensor, group=None, root: int = 0, op: str = "sum") -> torch.Tensor:
    """Reduce-to-root: the one-shot all-reduce on the root, zeros
    elsewhere (the JAX programs are symmetric)."""
    s = all_reduce(x, group, op)
    return s if _rank(group) == root else torch.zeros_like(s)


def gather(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """Gather-to-root: (n, *x.shape) on the root, zeros elsewhere
    (reference root-gather, session/session.go:185-207)."""
    g = all_gather(x, group)
    return g if _rank(group) == root else torch.zeros_like(g)


def barrier(group=None, device=None) -> torch.Tensor:
    """A tiny all-reduce as a rendezvous (reference session/session.go:
    98-109); returns the group's size, as the JAX one's psum of ones."""
    return all_reduce(torch.ones((), dtype=torch.int32, device=device), group, "sum")


def consensus(x: torch.Tensor, group=None) -> torch.Tensor:
    """True (a 0-d bool tensor) iff every rank holds the same values: the
    minimum equals the maximum everywhere (reference session/session.go:
    120-151); bool through f32, as the JAX one does."""
    xf = x.float() if x.dtype == torch.bool else x
    return torch.all(all_reduce(xf, group, "min") == all_reduce(xf, group, "max"))


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
