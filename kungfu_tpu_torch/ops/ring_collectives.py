"""Ring reduce-scatter, all-gather and all-reduce on hand-written CUDA
kernels (counterpart of kungfu_tpu/ops/pallas_collectives.py, whose
kernels are kungfu_tpu/ops/ring_kernels.py).

  ring_reduce_scatter    csrc/ring.cu  replaces `make_rs_kernel` (B5)
  ring_all_gather        csrc/ring.cu  replaces `make_ag_kernel` (B6)
  ring_all_reduce        B5 then B6
  fused_ring_all_reduce  int8/fp8 codes on the wire: csrc/ring.cu replaces
                         `make_fused_rs_kernel` (B7) then
                         `make_fused_ag_kernel` (B8)

Same public names and layouts as the JAX wrappers, over a process group
instead of a mesh axis:

  ring_reduce_scatter(x)  x is (n, ...) on every rank; rank d returns row d
                          summed over the ranks (`psum_scatter`,
                          scatter_dimension=0, tiled=False)
  ring_all_gather(x)      every rank returns (n, *x.shape) (`all_gather`,
                          tiled=False)
  ring_all_reduce(x, op)  the sum ("sum") or the mean ("mean") of x over
                          the ranks; the mean is the sum times 1/n, once
                          per element, which is how XLA's CPU backend
                          lowers the JAX wrapper's `out / n` and how
                          torch divides a CUDA tensor by a number

with the same chunking (`_chunk_elems`: ceil(size/n) rounded up to 1024
elements; a row of the reduce-scatter padded to 1024), so every element is
summed in the Pallas kernels' order and the results are bit-equal to
theirs.  The padding is never copied: the kernels read past the payload as
zeros and write only the payload.

A CUDA tensor goes to the kernels, which store into the neighbour's
workspace (`peer_memory`); a CPU tensor goes to the plain ring of
`collective.py` over the process group.  There is no other path: the JAX
wrappers' fallbacks to the lax ring (payload above the VMEM budget, a dtype
other than f32/bf16, an op other than sum/mean) do not exist here.  Every
payload size runs through the kernels, and another dtype or op raises.
n == 1 returns the input, as the lax lowering does (so does an empty
all-reduce).

`fused_ring_all_reduce(x, group, config, op)` keeps the JAX wrapper's
semantics: "none" is `ring_all_reduce`; "bf16" casts, runs B5/B6 on bf16
and casts back; int8/fp8 take x in f32, pad each chunk to a multiple of
lcm(block, 1024) (`collective.fused_chunk_elems`), run B7, the mean (times
1/n), then B8, and cast back to x's dtype.  Where the JAX wrapper hands a
stochastic or sparse config, another op or an oversized payload to
`compression.all_reduce`, this one raises for the first three (that path
is `synchronous_sgd(impl="pmean", compression=...)`) and runs every
payload size through the kernels.

Kernels run on the current stream without a host sync.  A kernel that
waited too long for a peer records where; the next ring call on the rank
raises it, and `peer_memory.check_all()` waits for the kernels and raises
it (synchronous_sgd calls it once per step).
"""
from __future__ import annotations

import math
from typing import Union

import torch

from ..compat import kernel_mode
from ..compression.config import CompressionConfig, resolve
from ..compression.quant import CODE_RECIP
from . import collective as C
from . import peer_memory
from .flash import Kernel

RING_RS = Kernel("ring_reduce_scatter", "kungfu_tpu_torch/ops/csrc/ring.cu",
                 "kungfu_tpu/ops/ring_kernels.py:72")  # make_rs_kernel
RING_AG = Kernel("ring_all_gather", "kungfu_tpu_torch/ops/csrc/ring.cu",
                 "kungfu_tpu/ops/ring_kernels.py:115")  # make_ag_kernel
FUSED_RS = Kernel("ring_fused_reduce_scatter", "kungfu_tpu_torch/ops/csrc/ring.cu",
                  "kungfu_tpu/ops/ring_kernels.py:181")  # make_fused_rs_kernel
FUSED_AG = Kernel("ring_fused_all_gather", "kungfu_tpu_torch/ops/csrc/ring.cu",
                  "kungfu_tpu/ops/ring_kernels.py:249")  # make_fused_ag_kernel
KERNELS = (RING_RS, RING_AG, FUSED_RS, FUSED_AG)

TILE = C.TILE
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_THREADS, _VEC_BYTES, _UNROLL = 512, 16, 4  # csrc/ring.cu kThreads, 16-byte vectors, kUnroll
_SEG, _SEGS_PER_BLOCK = 256, 64  # fused kernels: values a warp quantizes at once; 16 warps x 4
_SCHEMES = {"int8": 0, "fp8": 1}
_chunk_elems = C._chunk_elems
_world = C._world


def _check(name: str, x: torch.Tensor, op: str = "sum") -> None:
    if x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"{name}: dtype {x.dtype} has no ring kernel (f32 and bf16 only; other "
            "types wait for the Session collectives, ROADMAP A4)")
    if op not in ("sum", "mean"):
        raise NotImplementedError(
            f"{name}: op {op!r} has no ring kernel (sum and mean only; other ops "
            "wait for the Session collectives, ROADMAP A4)")


def _blocks(chunk: int, itemsize: int, max_blocks: int) -> int:
    """Grid of a ring kernel: one block per 4 x 512 vectors of the chunk,
    at most one block per SM (blocks spin on peer blocks)."""
    nvec = chunk * itemsize // _VEC_BYTES
    return max(1, min(max_blocks, -(-nvec // (_THREADS * _UNROLL))))


def _launch(kernel: Kernel, fn_name: str, ws: peer_memory.Workspace, kind: str,
            device: torch.device, chunk: int, blocks: int, head, peer: int = 1) -> None:
    """One launch of a ring kernel on the workspace (already reserved),
    storing into the workspace of rank + `peer`; `head` holds the kernel's
    own arguments (operands, views, codec)."""
    from . import _build

    fn = _build.function(fn_name)
    seq, ack_want = ws.next_call(kind, blocks)
    with torch.cuda.device(device):
        err = fn(*head, ws.own, ws.peer(peer), ws.n, ws.rank, ws.max_blocks, *ws.slots(kind),
                 chunk, blocks, seq, ack_want, peer_memory._timeout_ns(), ws.err_ptr,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: kernel launch failed with CUDA error {err}")
    kernel.launches += 1


def _plain_launch(kernel: Kernel, fn_name: str, kind: str, x: torch.Tensor, chunk: int,
                  group, head) -> None:
    """B5 or B6: reserve plain slots for `chunk` elements of x's dtype, launch."""
    ws = peer_memory.workspace(group, x.device)
    ws.raise_if_failed()
    ws.reserve(chunk * x.element_size(), "rs", "ag")
    _launch(kernel, fn_name, ws, kind, x.device, chunk,
            _blocks(chunk, x.element_size(), ws.max_blocks), (*head, _DTYPE_CODES[x.dtype]))


def _rs_kernel(x, row: int, stride: int, chunk: int, out_len: int, group):
    """B5 on x holding n rows of `row` valid elements `stride` apart."""
    out = torch.empty(out_len, dtype=x.dtype, device=x.device)
    _plain_launch(RING_RS, "kft_ring_rs", "rs", x, chunk, group,
                  (x.data_ptr(), stride, row, x.numel(), out.data_ptr(), out_len))
    return out


def _ag_kernel(mine, row: int, stride: int, size: int, chunk: int, group):
    """B6: chunk c of the result lands at out[c * stride + j], j < row."""
    out = torch.empty(size, dtype=mine.dtype, device=mine.device)
    _plain_launch(RING_AG, "kft_ring_ag", "ag", mine, chunk, group,
                  (mine.data_ptr(), mine.numel(), out.data_ptr(), stride, row, size))
    return out


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring reduce-scatter (B5): x is (n, ...) per rank, rank d returns
    row d summed across the ranks."""
    n = _world(group)
    if x.ndim < 1 or x.shape[0] != n:
        raise ValueError(f"ring_reduce_scatter: x must be (n={n}, ...), got {tuple(x.shape)}")
    _check("ring_reduce_scatter", x)
    if n == 1:
        return x[0]
    row = int(math.prod(x.shape[1:]))
    if kernel_mode(x.device) == "plain":
        return C.ring_reduce_scatter_chunks(list(x.reshape(n, row)), group).view(x.shape[1:])
    x = x.contiguous()
    chunk = -(-max(row, 1) // TILE) * TILE
    return _rs_kernel(x, row, row, chunk, row, group).view(x.shape[1:])


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring all-gather (B6): every rank returns (n, *x.shape)."""
    n = _world(group)
    _check("ring_all_gather", x)
    if n == 1:
        return x[None]
    if kernel_mode(x.device) == "plain":
        return torch.stack(C.ring_all_gather_chunks(x.contiguous(), group))
    x = x.contiguous()
    elems = x.numel()
    chunk = -(-max(elems, 1) // TILE) * TILE
    return _ag_kernel(x, elems, elems, n * elems, chunk, group).view((n,) + x.shape)


def ring_all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Ring all-reduce: B5 then B6, chunk ownership as the Pallas kernels'
    (rank d reduces chunk d); op "mean" multiplies the sum by 1/n."""
    n = _world(group)
    _check("ring_all_reduce", x, op)
    if n == 1 or x.numel() == 0:
        return x
    size = x.numel()
    chunk = _chunk_elems(size, n)
    if kernel_mode(x.device) == "plain":
        chunks = C._padded_chunks(x, n, chunk)
        mine = C.ring_reduce_scatter_chunks(chunks, group)
        out = torch.cat(C.ring_all_gather_chunks(mine, group))[:size].view(x.shape)
    else:
        x = x.contiguous()
        mine = _rs_kernel(x, chunk, chunk, chunk, chunk, group)
        out = _ag_kernel(mine, chunk, chunk, size, chunk, group).view(x.shape)
    return out.mul_(1.0 / n) if op == "mean" else out


# --------------------------------------------------- fused-codec ring ----

def require_fused_kernel(cfg: CompressionConfig, op: str) -> None:
    """Raise NotImplementedError for what B7/B8 do not run: a stochastic or
    sparse config, or an op other than sum and mean."""
    why = ("a stochastic config" if cfg.stochastic else f"the sparse config {cfg.scheme!r}"
           if cfg.is_sparse else f"op {op!r}" if op not in ("sum", "mean") else None)
    if why:
        raise NotImplementedError(
            f"fused_ring_all_reduce: {why} has no ring kernel (B7/B8 run deterministic "
            "int8/fp8 sums and means); impl='pmean' with this compression takes it "
            "(compression.all_reduce)")


def _fused_launch(kernel: Kernel, fn_name: str, kind: str, x: torch.Tensor,
                  cfg: CompressionConfig, chunk: int, group, head) -> None:
    """B7 or B8: reserve fused slots for `chunk` codes and their scales, launch."""
    if cfg.block % 8 or _SEG % cfg.block:
        raise NotImplementedError(
            f"fused_ring_all_reduce: block {cfg.block} has no ring kernel (B7/B8 take "
            "blocks of 8 to 256 values that divide 256)")
    ws = peer_memory.workspace(group, x.device)
    ws.raise_if_failed()
    ws.reserve(chunk + chunk // cfg.block * 4, "frs", "fag")
    blocks = max(1, min(ws.max_blocks, -(-(chunk // _SEG) // _SEGS_PER_BLOCK)))
    codec = (_SCHEMES[cfg.scheme], cfg.block, float(CODE_RECIP[cfg.scheme]))
    _launch(kernel, fn_name, ws, kind, x.device, chunk, blocks, (*head, *codec))


def _fused_rs(flat: torch.Tensor, cfg: CompressionConfig, chunk: int, group) -> torch.Tensor:
    """B7 on the contiguous f32 payload `flat`: this rank's reduced chunk."""
    mine = torch.empty(chunk, dtype=torch.float32, device=flat.device)
    _fused_launch(FUSED_RS, "kft_ring_frs", "frs", flat, cfg, chunk, group,
                  (flat.data_ptr(), flat.numel(), mine.data_ptr()))
    return mine


def _fused_ag(mine: torch.Tensor, cfg: CompressionConfig, chunk: int, size: int,
              group) -> torch.Tensor:
    """B8: every rank's chunk, quantized once by its owner, as `size` f32 values."""
    out = torch.empty(size, dtype=torch.float32, device=mine.device)
    _fused_launch(FUSED_AG, "kft_ring_fag", "fag", mine, cfg, chunk, group,
                  (mine.data_ptr(), out.data_ptr(), size))
    return out


def fused_ring_all_reduce(x: torch.Tensor, group=None,
                          config: Union[None, str, CompressionConfig] = None,
                          op: str = "sum") -> torch.Tensor:
    """All-reduce with the int8/fp8 codec inside the ring kernels (B7 then
    B8); "none" and "bf16" run the plain ring kernels (see the module
    docstring).  Returns x's shape and dtype."""
    cfg = resolve(config)
    if cfg.scheme == "none":
        return ring_all_reduce(x, group, op)
    require_fused_kernel(cfg, op)
    n = _world(group)
    if cfg.scheme == "bf16":
        out = ring_all_reduce(x.to(torch.bfloat16), group, "sum").to(x.dtype)
        return out * (1.0 / n) if op == "mean" else out
    if n == 1 or x.numel() == 0:
        return x
    size = x.numel()
    chunk = C.fused_chunk_elems(size, n, cfg)
    flat = x.reshape(-1).float().contiguous()
    if kernel_mode(x.device) == "plain":
        out = C.fused_ring_all_reduce_chunks(C._padded_chunks(flat, n, chunk), group, cfg,
                                             op)[:size]
    else:
        mine = _fused_rs(flat, cfg, chunk, group)
        if op == "mean":
            mine.mul_(1.0 / n)
        out = _fused_ag(mine, cfg, chunk, size, group)
    return out.view(x.shape).to(x.dtype)
