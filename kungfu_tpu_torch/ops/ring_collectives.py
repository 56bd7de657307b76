"""Ring reduce-scatter, all-gather and all-reduce on hand-written CUDA
kernels (counterpart of kungfu_tpu/ops/pallas_collectives.py, whose
kernels are kungfu_tpu/ops/ring_kernels.py).

  ring_reduce_scatter    csrc/ring.cu  replaces `make_rs_kernel` (B5)
  ring_all_gather        csrc/ring.cu  replaces `make_ag_kernel` (B6)
  ring_reduce_scatter_group, ring_all_gather_group
                         B5, B6 on many tensors at once (FSDP's buckets)
  ring_all_reduce        B5 then B6
  ring_all_reduce_group  B5 then B6 on many tensors at once (the Session's
                         grouped all-reduce)
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
elements), so every element is summed in the Pallas kernels' order and the
results are bit-equal to theirs.  The padding is never copied: the kernels
read past the payload as zeros and write only the payload.

The group forms take a list of tensors of one dtype and return one result
per tensor, each as the single call returns it.  A launch of B5 or B6
carries a table of segments (at most MAX_SEGMENTS): each tensor is read
and written in place, and travels at its offset, rounded up to 16 bytes,
in one concatenated chunk.  An element's sum depends only on n and the
rank that owns its chunk, so a group is bit-equal to a call per tensor.
`segment_plan` cuts a group into launches that fit the workspace's slots,
which the group first grows to its largest tensor (as a call each would);
a single tensor is a table of one.  On the CPU the group's chunks are
packed at the same offsets and go through the plain ring once.

A CUDA tensor goes to the kernels, which store into the neighbour's
workspace (`peer_memory`); a CPU tensor goes to the plain ring of
`collective.py` over the process group.  There is no other path: the JAX
wrappers' fallbacks to the lax ring (payload above the VMEM budget, a dtype
other than f32/bf16, an op other than sum/mean) do not exist here.  Every
payload size runs through the kernels, and another dtype or op raises; the
Session (`session.py`) routes those, by op and dtype before the call, to
the routes the JAX wrapper falls back to.
n == 1 returns the input, as the lax lowering does (so does an empty
all-reduce).

`fused_ring_all_reduce(x, group, config, op)` keeps the JAX wrapper's
semantics: "none" is `ring_all_reduce`; "bf16" casts, runs B5/B6 on bf16
and casts back; int8/fp8 take x in f32, pad each chunk to a multiple of
lcm(block, 1024) (`collective.fused_chunk_elems`), run B7, the mean (times
1/n), then B8, and cast back to x's dtype.  B7 and B8 run their hops as a
wavefront of stages of FRS_STAGE_VALUES values (`fused_rs_plan`,
`fused_ag_plan`: whole stages a block on at most FRS_GRID and FAG_GRID
blocks; `frs_counts`, `fag_counts`: the stage counts their flags carry).
Where the JAX wrapper hands a
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

import ctypes
import math
from typing import List, NamedTuple, Sequence, Tuple, Union

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
MAX_SEGMENTS = 32  # csrc/ring.cu kMaxSegs: segments in one launch of B5/B6
_SEG = 256  # fused kernels: values a warp quantizes at once
_SCHEMES = {"int8": 0, "fp8": 1}
# B7 (csrc/ring.cu, the fused reduce-scatter's section): values of a stage
# (kFStageVals), stages a count of its flag covers and the stores left in
# flight while one is raised (kFCount, kFCountLag), the bits of a flag's
# count (kStageBits)
FRS_STAGE_VALUES, FRS_COUNT, FRS_COUNT_LAG, STAGE_BITS = 8192, 8, 5, 20
FRS_GRID = 132  # B7's blocks at most (and at most one an SM); chosen by a grid sweep
# B8 (csrc/ring.cu, the fused all-gather's section): B7's stages and
# records; stages a count of its flag covers (kAgCount)
FAG_COUNT = 4
FAG_GRID = 132  # B8's blocks at most (and at most one an SM)
_chunk_elems = C._chunk_elems
_world = C._world


def _check(name: str, x: torch.Tensor, op: str = "sum") -> None:
    if x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"{name}: dtype {x.dtype} has no ring kernel (f32 and bf16 only; the Session "
            "routes other dtypes to the ring of ops/collective.py: session.Session.all_reduce)")
    if op not in ("sum", "mean"):
        raise NotImplementedError(
            f"{name}: op {op!r} has no ring kernel (sum and mean only; the Session "
            "routes other ops to the one-shot all-reduce: session.Session.all_reduce)")


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


def _seg_bytes(row: int, itemsize: int) -> int:
    """Bytes a segment of `row` values takes in a launch's concatenated
    chunk: whole 16-byte vectors (csrc/ring.cu `make_table`)."""
    return -(-row * itemsize // _VEC_BYTES) * _VEC_BYTES


def segment_plan(segments: Sequence[Tuple[int, torch.dtype]], cap: int
                 ) -> List[Tuple[int, int]]:
    """Split consecutive segments (row values, dtype) into runs [start,
    stop), one launch of B5 or B6 each: one dtype a run, at most
    MAX_SEGMENTS segments, and at most `cap` bytes of concatenated chunk
    (`_seg_bytes` each) unless the run is a single segment.  Greedy, in
    order, so every rank that plans the same segments makes the same
    runs."""
    runs: List[Tuple[int, int]] = []
    start, total = 0, 0
    for i, (row, dtype) in enumerate(segments):
        nbytes = _seg_bytes(row, dtype.itemsize)
        if i > start and (dtype != segments[start][1] or i - start == MAX_SEGMENTS
                          or total + nbytes > cap):
            runs.append((start, i))
            start, total = i, 0
        total += nbytes
    if segments:
        runs.append((start, len(segments)))
    return runs


def _table_launch(kernel: Kernel, fn_name: str, kind: str, xs: Sequence[torch.Tensor],
                  entries: Sequence[Tuple[int, int, int, int, int]], group) -> None:
    """B5 or B6 over segments of xs' dtype, `entries` their table rows (x,
    x_size, out, out_size, row; csrc/ring.cu `kft_ring_rs`): the plain
    slots grown to the largest segment, as a call per tensor would grow
    them, then one launch per run of `segment_plan` within those slots."""
    dtype, device = xs[0].dtype, xs[0].device
    ws = peer_memory.workspace(group, device)
    ws.raise_if_failed()
    itemsize = dtype.itemsize
    ws.reserve(max([_VEC_BYTES] + [_seg_bytes(e[4], itemsize) for e in entries]), "rs", "ag")
    for start, stop in segment_plan([(e[4], dtype) for e in entries], ws.slot_bytes[kind]):
        part = entries[start:stop]
        chunk = sum(_seg_bytes(e[4], itemsize) for e in part) // itemsize
        table = (ctypes.c_longlong * (len(part) * len(part[0])))(*(v for e in part for v in e))
        _launch(kernel, fn_name, ws, kind, device, chunk, _blocks(chunk, itemsize, ws.max_blocks),
                (table, len(part), _DTYPE_CODES[dtype]))


def _rs_kernel(xs: Sequence[torch.Tensor], rows: Sequence[int], group) -> List[torch.Tensor]:
    """B5: xs[i] holds n chunks of rows[i] values, chunk c at xs[i][c *
    rows[i]:] (zero past its end); returns each one's reduced chunk."""
    outs = [torch.empty(row, dtype=x.dtype, device=x.device) for x, row in zip(xs, rows)]
    _table_launch(RING_RS, "kft_ring_rs", "rs", xs,
                  [(x.data_ptr(), x.numel(), o.data_ptr(), row, row)
                   for x, o, row in zip(xs, outs, rows)], group)
    return outs


def _ag_kernel(mines: Sequence[torch.Tensor], sizes: Sequence[int], group
               ) -> List[torch.Tensor]:
    """B6: mines[i] is this rank's chunk; chunk c of result i lands at
    out[c * row + j] (row = mines[i].numel()) for flat indices below
    sizes[i]."""
    outs = [torch.empty(size, dtype=m.dtype, device=m.device) for m, size in zip(mines, sizes)]
    _table_launch(RING_AG, "kft_ring_ag", "ag", mines,
                  [(m.data_ptr(), m.numel(), o.data_ptr(), size, m.numel())
                   for m, o, size in zip(mines, outs, sizes)], group)
    return outs


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring reduce-scatter (B5): x is (n, ...) per rank, rank d returns
    row d summed across the ranks."""
    return ring_reduce_scatter_group([x], group)[0]


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring all-gather (B6): every rank returns (n, *x.shape)."""
    return ring_all_gather_group([x], group)[0]


def _check_group(name: str, xs: Sequence[torch.Tensor]) -> None:
    for x in xs:
        _check(name, x)
        if x.dtype != xs[0].dtype or x.device != xs[0].device:
            raise ValueError(f"{name}: every tensor must be {xs[0].dtype} on {xs[0].device}, "
                             f"got {x.dtype} on {x.device}")


def _offsets(rows: Sequence[int], itemsize: int) -> List[int]:
    """Each segment's first value in the concatenated chunk, then its end."""
    out = [0]
    for row in rows:
        out.append(out[-1] + _seg_bytes(row, itemsize) // itemsize)
    return out


def ring_reduce_scatter_group(xs: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """`ring_reduce_scatter` of every tensor of xs (one dtype, each (n,
    ...)) as one ring: one launch of B5 for as many as its table and slots
    hold, the results bit-equal to a call each."""
    n = _world(group)
    for x in xs:
        if x.ndim < 1 or x.shape[0] != n:
            raise ValueError(f"ring_reduce_scatter: x must be (n={n}, ...), got {tuple(x.shape)}")
    _check_group("ring_reduce_scatter", xs)
    if n == 1 or not xs:
        return [x[0] for x in xs]
    rows = [int(math.prod(x.shape[1:])) for x in xs]
    if kernel_mode(xs[0].device) == "plain":
        # the chunks side by side at the kernel's offsets, one plain ring
        off = _offsets(rows, xs[0].element_size())
        packed = xs[0].new_zeros(n, off[-1])
        for i, x in enumerate(xs):
            packed[:, off[i]:off[i] + rows[i]] = x.reshape(n, rows[i])
        mine = C.ring_reduce_scatter_chunks(list(packed), group)
        return [mine[off[i]:off[i] + rows[i]].view(x.shape[1:]) for i, x in enumerate(xs)]
    xs = [x.contiguous() for x in xs]
    return [o.view(x.shape[1:]) for o, x in zip(_rs_kernel(xs, rows, group), xs)]


def ring_all_gather_group(xs: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """`ring_all_gather` of every tensor of xs (one dtype) as one ring: one
    launch of B6 for as many as its table and slots hold."""
    n = _world(group)
    _check_group("ring_all_gather", xs)
    if n == 1 or not xs:
        return [x[None] for x in xs]
    rows = [x.numel() for x in xs]
    if kernel_mode(xs[0].device) == "plain":
        off = _offsets(rows, xs[0].element_size())
        packed = xs[0].new_zeros(off[-1])
        for i, x in enumerate(xs):
            packed[off[i]:off[i] + rows[i]] = x.reshape(-1)
        full = torch.stack(C.ring_all_gather_chunks(packed, group))
        return [full[:, off[i]:off[i] + rows[i]].reshape((n,) + x.shape)
                for i, x in enumerate(xs)]
    xs = [x.contiguous() for x in xs]
    outs = _ag_kernel(xs, [n * row for row in rows], group)
    return [o.view((n,) + x.shape) for o, x in zip(outs, xs)]


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
        mine = _rs_kernel([x.contiguous()], [chunk], group)[0]
        out = _ag_kernel([mine], [size], group)[0].view(x.shape)
    return out.mul_(1.0 / n) if op == "mean" else out


def ring_all_reduce_group(xs: Sequence[torch.Tensor], group=None, op: str = "sum"
                          ) -> List[torch.Tensor]:
    """`ring_all_reduce` of every tensor of xs (one dtype, one device) as
    one ring: B5 over every tensor's chunks, then B6, one launch each per
    run of `segment_plan` (the Session's grouped all-reduce); each result
    bit-equal to a call per tensor.  Empty tensors are returned as given."""
    n = _world(group)
    _check_group("ring_all_reduce", xs)
    if xs:
        _check("ring_all_reduce", xs[0], op)
    full = [x for x in xs if x.numel()]
    if n == 1 or not full:
        return list(xs)
    sizes = [x.numel() for x in full]
    chunks = [_chunk_elems(size, n) for size in sizes]
    if kernel_mode(full[0].device) == "plain":
        mines = ring_reduce_scatter_group(
            [C._padded_chunks(x, n, c) for x, c in zip(full, chunks)], group)
        outs = [g.reshape(-1)[:size] for g, size in zip(ring_all_gather_group(mines, group),
                                                         sizes)]
    else:
        mines = _rs_kernel([x.reshape(-1).contiguous() for x in full], chunks, group)
        outs = _ag_kernel(mines, sizes, group)
    it = iter(o.view(x.shape).mul_(1.0 / n) if op == "mean" else o.view(x.shape)
              for o, x in zip(outs, full))
    return [next(it) if x.numel() else x for x in xs]


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


class FusedPlan(NamedTuple):
    """B7's or B8's launch for one chunk: `stages` of FRS_STAGE_VALUES
    values (the last one shorter), `per_block` of them a block over
    `blocks` blocks (`block_range`, none empty); a stage's record (its
    codes, then its scales) at `record` bytes a stage into a slot of
    `slot` bytes."""
    stages: int
    blocks: int
    per_block: int
    record: int
    slot: int


def _fused_plan(chunk: int, block: int, max_blocks: int, grid: int) -> FusedPlan:
    stages = -(-chunk // FRS_STAGE_VALUES)
    cap = max(1, min(max_blocks, grid, stages))
    per = -(-stages // cap)
    return FusedPlan(stages, -(-stages // per), per,
                     FRS_STAGE_VALUES + FRS_STAGE_VALUES // block * 4, chunk + chunk // block * 4)


def fused_rs_plan(chunk: int, block: int, max_blocks: int) -> FusedPlan:
    """B7's plan for a chunk of `chunk` values (a multiple of 1024) and
    quantization blocks of `block` values, on at most FRS_GRID and
    `max_blocks` blocks."""
    return _fused_plan(chunk, block, max_blocks, FRS_GRID)


def fused_ag_plan(chunk: int, block: int, max_blocks: int) -> FusedPlan:
    """B8's plan: B7's stages and records, on at most FAG_GRID and
    `max_blocks` blocks."""
    return _fused_plan(chunk, block, max_blocks, FAG_GRID)


def frs_counts(stages: int) -> List[int]:
    """The counts a block of B7 with `stages` stages raises in its flag of
    a hop, in order (csrc/ring.cu `frs_consume`): every FRS_COUNT stages,
    those complete while FRS_COUNT_LAG newer stores are in flight, and all
    of them at the hop's last stage."""
    counts = []
    for k in range(stages):
        lag = k - FRS_COUNT_LAG
        if k == stages - 1:
            counts.append(stages)
        elif lag >= 0 and (lag + 1) % FRS_COUNT == 0:
            counts.append(lag + 1)
    return counts


def fag_counts(stages: int) -> List[int]:
    """The counts a block of B8 with `stages` stages raises in its flag of
    a hop that sends, in order (csrc/ring.cu `fag_signal`): after every
    FAG_COUNT stages and after the last."""
    return [min(stages, k + FAG_COUNT) for k in range(0, stages, FAG_COUNT)]


def _fused_launch(kernel: Kernel, fn_name: str, kind: str, x: torch.Tensor,
                  cfg: CompressionConfig, chunk: int, group, head, grid) -> None:
    """B7 or B8: reserve fused slots for `chunk` codes and their scales,
    launch on `grid(max_blocks)` blocks."""
    if cfg.block % 8 or _SEG % cfg.block:
        raise NotImplementedError(
            f"fused_ring_all_reduce: block {cfg.block} has no ring kernel (B7/B8 take "
            "blocks of 8 to 256 values that divide 256)")
    ws = peer_memory.workspace(group, x.device)
    ws.raise_if_failed()
    ws.reserve(chunk + chunk // cfg.block * 4, "frs", "fag")
    codec = (_SCHEMES[cfg.scheme], cfg.block, float(CODE_RECIP[cfg.scheme]))
    _launch(kernel, fn_name, ws, kind, x.device, chunk, grid(ws.max_blocks), (*head, *codec))


def _fused_rs(flat: torch.Tensor, cfg: CompressionConfig, chunk: int, group) -> torch.Tensor:
    """B7 on the contiguous f32 payload `flat`: this rank's reduced chunk."""
    if flat.data_ptr() % 16:  # its stages leave by 16-byte bulk copies
        flat = flat.clone()
    mine = torch.empty(chunk, dtype=torch.float32, device=flat.device)
    _fused_launch(FUSED_RS, "kft_ring_frs", "frs", flat, cfg, chunk, group,
                  (flat.data_ptr(), flat.numel(), mine.data_ptr()),
                  lambda max_blocks: fused_rs_plan(chunk, cfg.block, max_blocks).blocks)
    return mine


def _fused_ag(mine: torch.Tensor, cfg: CompressionConfig, chunk: int, size: int,
              group) -> torch.Tensor:
    """B8: every rank's chunk, quantized once by its owner, as `size` f32 values."""
    if mine.data_ptr() % 16:  # its stages come in by 16-byte cp.async
        mine = mine.clone()
    out = torch.empty(size, dtype=torch.float32, device=mine.device)
    _fused_launch(FUSED_AG, "kft_ring_fag", "fag", mine, cfg, chunk, group,
                  (mine.data_ptr(), out.data_ptr(), size),
                  lambda max_blocks: fused_ag_plan(chunk, cfg.block, max_blocks).blocks)
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
