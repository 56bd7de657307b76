"""Fused computation-collective ops on hand-written CUDA kernels
(counterpart of kungfu_tpu/ops/fused_matmul.py, whose kernels are
kungfu_tpu/ops/ring_kernels.py).

  all_gather_matmul      csrc/fused_matmul.cu replaces `make_ag_matmul_kernel` (B9)
  matmul_reduce_scatter  csrc/fused_matmul.cu replaces `make_matmul_rs_kernel` (B10)
  dma_all_gather         the tiled all-gather on B6 (a group of one of
                         dma_all_gather_group); its VJP is dma_reduce_scatter
  dma_reduce_scatter     the tiled reduce-scatter on B5 (ring_reduce_scatter); its VJP
                         is dma_all_gather
  dma_all_gather_group   dma_all_gather of a bucket of tensors in one grouped B6 call,
                         their gradients in one grouped B5 call (FSDPTrainer)
  ring_shift             csrc/ring.cu `ring_shift_kernel` replaces `make_shift_kernel` (B11)
  ring_shift_pair        the same kernel, two payloads in one launch

Every function runs over a process group where the JAX one runs over a
mesh axis, with the JAX layouts:

  all_gather_matmul(x, w_shard)      x [M, K], w_shard [K/n, N]: x @
                                     concat_rows(every rank's shard), the
                                     product in f32, returned in x's dtype
  matmul_reduce_scatter(x, w)        x [M, K] (n divides M), w [K, N]: rank
                                     d's rows [d M/n, (d+1) M/n) of the sum
                                     over the ranks of x @ w, the partials
                                     in f32, returned in x's dtype
  dma_all_gather(x)                  (d0, ...) -> (n d0, ...), rank-major
  dma_reduce_scatter(x)              (n d0, ...) -> this rank's d0 rows, summed

The matmul-reduce-scatter adds the partials in the TPU kernel's order:
chunk c's sum is P_c(c) + (P_c(c-1) + (... + P_c(c+1))) with P_c(r) the
f32 product of rank r, as the ring reduce-scatter B5 adds its chunks.  The
all-gather-matmul sums the shards' products from the own shard down the
ring, c = (d - s) mod n at hop s.  Neither has a gradient: the JAX ones
have none on their kernel path either.

`ring_shift(x, group, shift)` is `lax.ppermute(x, axis, [(i, (i + shift)
% n)])` over a process group: rank d returns what rank (d - shift) mod n
passed.  It is differentiable: the backward shifts the cotangent by
-shift, as the JAX VJP does.  `ring_shift_pair(k, v, group, shift)` shifts
two tensors as one call and one autograd node, and its backward shifts
(dk, dv) as one launch: ring attention's K/V hop
(`parallel/ring_attention.py`).  Every rank must make the same calls in
the same order, forward and backward; a pair cannot be issued as k then v
on one rank and v then k on another.

A CUDA tensor goes to the kernel, which stores into a peer's workspace
(`peer_memory`: the kinds "agmm", "mmrs" and "shift"); a CPU tensor goes
to the rank-local plain version over the group (the shards gathered, or
the partials reduce-scattered, by the plain ring of `ops/collective.py`;
the shift by `dist.batch_isend_irecv`).  `_plain_all_gather_matmul`,
`_plain_matmul_reduce_scatter` and `_plain_ring_shift` are the stacked
plain versions (every rank's operands in one process) that the card
checks hold the kernels against.  Every size takes the kernels: the JAX
wrappers' fallbacks (past their VMEM budget, for other dtypes, off a sole
named axis) have no counterpart.  B9 and B10 take f32 and bf16 (x and w of
one dtype) and raise NotImplementedError for another; the shift moves
bytes, so every dtype goes through it.  In bf16 the kernels read their
operands through the copy engine, which wants rows of whole 16 bytes: the
wrappers pad a shard's rows, K and N to multiples of 8 with zeros, as the
JAX wrappers pad to their tiles (`_pad2`), and slice the result.
`mm_product` runs B9's or B10's product body alone, without peers, for
measuring it on one card.  n == 1 computes the unfused
product (B9, B10) or returns the input (the shift, or a shift that is a
multiple of n) and launches nothing, as the JAX wrappers do.

    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.fused_check
    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.benchmarks --bench fused

check B9 and B10 on 4 ranks and run the fused benchmark (`--device cpu`
on gloo ranks without a card).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..compat import kernel_mode
from . import collective as C
from . import peer_memory
from . import ring_collectives as RC
from .collective import _world
from .flash import Kernel
from .ring_collectives import _launch

SHIFT = Kernel("ring_shift", "kungfu_tpu_torch/ops/csrc/ring.cu",
               "kungfu_tpu/ops/ring_kernels.py:453")  # make_shift_kernel
AG_MATMUL = Kernel("all_gather_matmul", "kungfu_tpu_torch/ops/csrc/fused_matmul.cu",
                   "kungfu_tpu/ops/ring_kernels.py:347")  # make_ag_matmul_kernel
MATMUL_RS = Kernel("matmul_reduce_scatter", "kungfu_tpu_torch/ops/csrc/fused_matmul.cu",
                   "kungfu_tpu/ops/ring_kernels.py:396")  # make_matmul_rs_kernel
KERNELS = (SHIFT, AG_MATMUL, MATMUL_RS)
# B9's and B10's product body alone (`mm_product`): replaces no TPU kernel
MM_PRODUCT = Kernel("mm_product", "kungfu_tpu_torch/ops/csrc/fused_matmul.cu", "")

_THREADS, _UNROLL, _VEC = 512, 4, 16  # csrc/ring.cu kThreads, kUnroll, 16-byte vectors
_MM_DTYPES = {torch.float32: 0, torch.bfloat16: 2}  # csrc/fused_matmul.cu MmDType
# A block's output tile (rows, columns): bf16 on csrc/mm_sm90.cuh's tilings
# kAg and kRs, f32 on the FMA body's 128 x 128
_TILES = {("b9", torch.bfloat16): (128, 256), ("b10", torch.bfloat16): (64, 128),
          ("b9", torch.float32): (128, 128), ("b10", torch.float32): (128, 128)}
_TILINGS = {"b9": 0, "b10": 1}  # csrc/mm_sm90.cuh kAg, kRs: kft_mm_product's `tiling`
_ALIGN = 8  # bf16 values in 16 bytes: the copy engine's alignment of bases and rows


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
    ws.reserve(total, "shift")
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


# ------------------------------------------- all-gather-matmul (B9) ----

def _check_mm(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"{name}: x and w must be matrices, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype not in _MM_DTYPES or w.dtype != x.dtype:
        raise NotImplementedError(
            f"{name}: dtypes {x.dtype} x {w.dtype} have no kernel (f32 or bf16, one dtype "
            "for both operands)")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")


def _unfused(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product in f32, in x's dtype: what n == 1 computes."""
    return (x.float() @ w.float()).to(x.dtype)


def _hop_sum(x: torch.Tensor, shards, d: int) -> torch.Tensor:
    """Rank d's all-gather-matmul from every rank's shard: the products of
    the shards, in f32, summed from the own shard down the ring."""
    n, ks = len(shards), shards[0].shape[0]
    acc = None
    for s in range(n):
        c = (d - s) % n
        part = x[:, c * ks:(c + 1) * ks].float() @ shards[c].float()
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def _plain_all_gather_matmul(xs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Every rank's result at once: xs [n, M, K] and ws [n, K/n, N] hold
    rank r's x and shard at row r; row d of the result is rank d's [M, N]."""
    return torch.stack([_hop_sum(xs[d], ws, d) for d in range(xs.shape[0])])


def _plan(kind: str, dtype: torch.dtype, rows: int, cols: int, max_blocks: int):
    """(output tiles, blocks) of one launch of B9 (`rows` of x) or B10
    (`rows` of a chunk, every hop) with `cols` columns: one block an SM at
    most, each taking every G-th tile."""
    bm, bn = _TILES[(kind, dtype)]
    tiles = -(-rows // bm) * -(-cols // bn)
    return tiles, max(1, min(max_blocks, tiles))


def _round_up(v: int, a: int = _ALIGN) -> int:
    return -(-v // a) * a


def _pad_ag(x: torch.Tensor, w: torch.Tensor, n: int):
    """B9's bf16 operands for the copy engine: a shard's rows ks and the
    columns N padded with zeros to multiples of 8 (x's columns shard by
    shard).  Zero rows and columns add nothing to any product."""
    (m, _), (ks, nn) = x.shape, w.shape
    kp, np_ = _round_up(ks), _round_up(nn)
    if kp != ks:
        x = F.pad(x.reshape(m, n, ks), (0, kp - ks)).reshape(m, n * kp)
        w = F.pad(w, (0, 0, 0, kp - ks))
    if np_ != nn:
        w = F.pad(w, (0, np_ - nn))
    return _aligned(x), _aligned(w)


def _pad_rs(x: torch.Tensor, w: torch.Tensor):
    """B10's (and the product's) bf16 operands for the copy engine: K and N
    padded with zeros to multiples of 8."""
    k, nn = w.shape
    kp, np_ = _round_up(k), _round_up(nn)
    if kp != k:
        x, w = F.pad(x, (0, kp - k)), F.pad(w, (0, 0, 0, kp - k))
    if np_ != nn:
        w = F.pad(w, (0, np_ - nn))
    return _aligned(x), _aligned(w)


def _kernel_ag_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    m, nn = x.shape[0], w.shape[1]
    if x.dtype == torch.bfloat16:
        x, w = _pad_ag(x, w, _world(group))
    else:
        x, w = x.contiguous(), _aligned(w)
    ks, np_ = w.shape
    out = torch.empty(m, np_, dtype=x.dtype, device=x.device)
    ws = peer_memory.workspace(group, x.device)
    ws.raise_if_failed()
    ws.reserve(ks * np_ * w.element_size(), "agmm")
    _, blocks = _plan("b9", x.dtype, m, np_, ws.max_blocks)
    _launch(AG_MATMUL, "kft_ag_matmul", ws, "agmm", x.device, ks * np_, blocks,
            (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, np_, ks, _MM_DTYPES[x.dtype]))
    return out if np_ == nn else out[:, :nn].contiguous()


def all_gather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group=None) -> torch.Tensor:
    """x [M, K] @ concat_rows(every rank's w_shard [K/n, N]), in x's dtype
    (B9 on a card); the shards are never gathered into one tensor."""
    _check_mm("all_gather_matmul", x, w_shard)
    n = _world(group)
    if x.shape[1] != n * w_shard.shape[0]:
        raise ValueError(f"all_gather_matmul: x contraction dim {x.shape[1]} != n*shard rows "
                         f"{n}*{w_shard.shape[0]}")
    x, w_shard = x.detach(), w_shard.detach()
    if n == 1:
        return _unfused(x, w_shard)
    if kernel_mode(x.device) == "plain":
        shards = C.ring_all_gather_chunks(w_shard.contiguous(), group)
        return _hop_sum(x, shards, dist.get_rank(group))
    return _kernel_ag_matmul(x, w_shard, group)


# ---------------------------------------- matmul-reduce-scatter (B10) ----

def _chunk_products(x: torch.Tensor, w: torch.Tensor, n: int):
    """The f32 products of x's n row chunks with w: one rank's partials."""
    mc = x.shape[0] // n
    return [x[c * mc:(c + 1) * mc].float() @ w.float() for c in range(n)]


def _plain_matmul_reduce_scatter(xs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Every rank's result at once: xs [n, M, K] and ws [n, K, N] hold rank
    r's operands at row r; row d of the result is rank d's [M/n, N], its
    partials summed in the ring's order."""
    n = xs.shape[0]
    parts = [_chunk_products(xs[r], ws[r], n) for r in range(n)]
    return torch.stack([C._ring_sum([p[d] for p in parts], d).to(xs.dtype) for d in range(n)])


def _kernel_matmul_rs(x: torch.Tensor, w: torch.Tensor, group, n: int) -> torch.Tensor:
    mc, nn = x.shape[0] // n, w.shape[1]
    if x.dtype == torch.bfloat16:
        x, w = _pad_rs(x, w)
    else:
        x, w = x.contiguous(), w.contiguous()
    k, np_ = w.shape
    out = torch.empty(mc, np_, dtype=x.dtype, device=x.device)
    ws = peer_memory.workspace(group, x.device)
    ws.raise_if_failed()
    ws.reserve(mc * np_ * 4, "mmrs")
    _, blocks = _plan("b10", x.dtype, mc, np_, ws.max_blocks)
    _launch(MATMUL_RS, "kft_matmul_rs", ws, "mmrs", x.device, mc * np_, blocks,
            (x.data_ptr(), w.data_ptr(), out.data_ptr(), mc, np_, k, _MM_DTYPES[x.dtype]))
    return out if np_ == nn else out[:, :nn].contiguous()


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """Rank d's rows [d M/n, (d+1) M/n) of the sum over the ranks of x [M,
    K] @ w [K, N], in x's dtype (B10 on a card; the partials travel in
    f32)."""
    _check_mm("matmul_reduce_scatter", x, w)
    n = _world(group)
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_reduce_scatter: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "do not multiply")
    if x.shape[0] % n:
        raise ValueError(f"matmul_reduce_scatter: rows {x.shape[0]} not divisible by n={n}")
    x, w = x.detach(), w.detach()
    if n == 1:
        return _unfused(x, w)
    if kernel_mode(x.device) == "plain":
        return C.ring_reduce_scatter_chunks(_chunk_products(x, w, n), group).to(x.dtype)
    return _kernel_matmul_rs(x, w, group, n)


# ------------------------------------------------- the product alone ----

@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mm_product(x: torch.Tensor, w: torch.Tensor, kind: str = "b9",
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, K] @ w [K, N] of bf16 operands on B9's (`kind` "b9") or B10's
    ("b10") product body alone, with no peers: one hop's product, in
    `out_dtype` (f32 or bf16).  For measuring and checking the body on one
    card (tools/fused_time.py); nothing on a training path calls it.  A
    CPU tensor takes the product in f32."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(f"mm_product: bf16 operands only, got {x.dtype} x {w.dtype}")
    if out_dtype not in _MM_DTYPES:
        raise NotImplementedError(f"mm_product: out_dtype {out_dtype} (f32 or bf16)")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"mm_product: x {tuple(x.shape)} and w {tuple(w.shape)} do not multiply")
    if kernel_mode(x.device) == "plain":
        return (x.float() @ w.float()).to(out_dtype)
    from . import _build

    m, nn = x.shape[0], w.shape[1]
    x, w = _pad_rs(x, w)
    np_ = w.shape[1]
    out = torch.empty(m, np_, dtype=out_dtype, device=x.device)
    _, blocks = _plan(kind, torch.bfloat16, m, np_, _sm_count(x.device.index))
    with torch.cuda.device(x.device):
        err = _build.function("kft_mm_product")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, np_, w.shape[0], _TILINGS[kind],
            _MM_DTYPES[out_dtype], blocks, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{MM_PRODUCT.name}: kernel launch failed with CUDA error {err}")
    MM_PRODUCT.launches += 1
    return out if np_ == nn else out[:, :nn].contiguous()


# ------------------------------------------- the DMA gather/scatter pair ----

def _ag_tiled(x: torch.Tensor, group) -> torch.Tensor:
    n = _world(group)
    return RC.ring_all_gather(x, group).reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def _rs_tiled(x: torch.Tensor, group) -> torch.Tensor:
    n = _world(group)
    if x.ndim < 1 or x.shape[0] % n:
        raise ValueError(f"dma_reduce_scatter: leading dim of {tuple(x.shape)} not divisible "
                         f"by n={n}")
    return RC.ring_reduce_scatter(x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])), group)


class _DmaReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rs_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ag_tiled(g.contiguous(), ctx.group), None


def _split_rows(g: torch.Tensor, n: int) -> torch.Tensor:
    """A tiled gather's cotangent (n d0, ...) as the ring's (n, d0, ...)."""
    return g.contiguous().reshape((n, g.shape[0] // n) + tuple(g.shape[1:]))


class _DmaAllGatherGroup(torch.autograd.Function):
    """The tiled gather of a bucket of tensors as one node: the forward
    gathers them in one grouped B6 call, the backward reduce-scatters every
    output's gradient in one grouped B5 call once all of them are ready
    (an unused output's gradient arrives as zeros: materialized)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        n = _world(group)
        outs = RC.ring_all_gather_group(xs, group)
        return tuple(o.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
                     for o, x in zip(outs, xs))

    @staticmethod
    def backward(ctx, *gs):
        n = _world(ctx.group)
        return (None, *RC.ring_reduce_scatter_group([_split_rows(g, n) for g in gs], ctx.group))


def dma_all_gather_group(xs: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """`dma_all_gather` of every tensor of xs (one dtype) in one grouped
    call of B6 (`ring_all_gather_group`), and their gradients in one
    grouped call of B5: the same values as a call each."""
    xs = list(xs)
    if any(x.ndim < 1 for x in xs):
        raise ValueError("dma_all_gather: x needs a leading dimension")
    if _world(group) == 1 or not xs:
        return xs
    return list(_DmaAllGatherGroup.apply(group, *xs))


def dma_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """`lax.all_gather(x, axis, tiled=True)` on the ring all-gather B6:
    (d0, ...) -> (n d0, ...).  Its gradient is `dma_reduce_scatter` (on B5),
    so an FSDP step whose unshard runs here reduce-scatters its gradients
    on the ring kernels too.  A group of one (`dma_all_gather_group`)."""
    return dma_all_gather_group([x], group)[0]


def dma_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """`lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)` on the
    ring reduce-scatter B5: (n d0, ...) -> this rank's summed d0 rows; its
    gradient is `dma_all_gather`."""
    return _DmaReduceScatter.apply(x, group)
