"""The ring kernels against their stacked plain versions, run as one rank.

    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.ring_check \\
        [--cases f32:1000003,bf16:4099] [--groups f32:256+262144+1000] [--grid 16,32]
        [--iters 5] [--seed 0] [--faults] [--device cpu]

Each case is `dtype:size`.  Every rank makes every rank's input from the
seed on its own device (rank r's is `size` normal values), so the check
needs no communication.  For dtype f32 or bf16 (the plain kernels B5/B6):

  ring_reduce_scatter  rank r's x is its first n * (size // n) values as
                       (n, size // n)
  ring_all_gather      rank r's x is its first size // n values
  ring_all_reduce      the whole input, op "sum" and op "mean"

For int8 or fp8 (the fused-codec kernels B7/B8, f32 inputs):

  fused_ring_all_reduce  the whole input, op "sum" and op "mean"

Each rank holds its own result against the stacked plain version of
`ops/collective.py` (`_plain_ring_*`, `_plain_fused_ring_all_reduce`),
bit for bit; a fused result must also lie within `fused_tolerance` of the
exact sum (the bound the JAX package's own tests put on its fused ring).
`--faults` also plants the faults of `planted_faults` (or
`planted_fused_faults`) in the cases of at most 16M values and shows that
the comparison rejects each.

On a card each kernel is then timed: the median of `--iters` calls, each
between two CUDA events, on every rank at once, and the median host time
of a call (the wrapper's work up to the launch, `host_ms`) (for a fused case "rs" is
B7 alone on the payload, "ag" B8 alone on its result).  Rank 0 alone,
while the others wait, times the stacked plain version (which computes
every rank's result in one process).  Where every rank has a card of its
own (an NCCL group), every rank also times NCCL's reduce_scatter_tensor,
all_gather_into_tensor and all_reduce on the same payload, a yardstick the
port never calls; NCCL has no quantized all-reduce, so for a fused case
these f32 times are context, not a library time of the same function.
The bound is the larger of two times: the bytes a rank sends, (n - 1)
chunks per kernel (of values, or of codes and scales), over 450 GB/s of
NVLink each way (only between cards), and the bytes the ranks of one card
read and write (each input read once, each output written once) over its
3.35 TB/s.

`--groups` adds groups of tensors (`dtype:row+row+...`, each tensor
`row` values of a rank's chunk, groups separated by `;`) through
ring_reduce_scatter_group and ring_all_gather_group: rank r's tensor i is
(n, row) for the reduce-scatter and its first row for the all-gather.
Each tensor must equal its stacked plain version bit for bit, each call
must take the launches of `segment_plan`, and with `--faults` a tensor
shifted by a vector, a last value wrong and a hop left out must be
rejected.  On a card each group is timed like a case; NCCL's yardstick
runs on the group's chunks packed into one tensor; `--grid 16,32` also
times the group with the grid capped at those block counts.

Prints one line `RING_CHECK {json}` and exits non-zero when a check
failed.  `launch` starts the ranks through the launcher and collects
their lines.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import distributed
from ..compression import config as comp_config
from ..compression.quant import QTensor, add_dequantized, dequantize, quantize
from ..ops import collective as C
from ..ops import ring_collectives as RC

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SCHEMES = ("int8", "fp8")  # fused cases: f32 payloads through B7/B8
NVLINK_BYTES_PER_S = 450e9  # one direction, H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
LINE = "RING_CHECK "
FAULT_CASE_MAX = 1 << 24  # planted faults copy the result twice: small cases only


def parse_cases(spec: str) -> List[Tuple[str, int]]:
    cases = []
    for item in spec.split(","):
        name, size = item.split(":")
        if name not in DTYPES and name not in SCHEMES:
            raise ValueError(f"unknown dtype {name!r} in case {item!r}")
        cases.append((name, int(size)))
    return cases


def make_inputs(n: int, size: int, dtype: torch.dtype, seed: int, device) -> List[torch.Tensor]:
    """Every rank's input: `size` normal values from (seed, rank)."""
    xs = []
    for r in range(n):
        gen = torch.Generator(device=device).manual_seed(seed * 1009 + r)
        xs.append(torch.randn(size, generator=gen, device=device).to(dtype))
    return xs


def planted_faults(xs: Sequence[torch.Tensor], good: torch.Tensor
                   ) -> List[Tuple[str, torch.Tensor]]:
    """The plain all-reduce sum `good` of `xs` with one fault each: chunk
    0 without the last rank's part (the hop that brings it left out) and,
    where the payload reaches past chunk 0, chunks 0 and 1 swapped (a
    chunk misrouted).  A check that accepts either is too weak."""
    n, size = len(xs), xs[0].numel()
    chunk = C._chunk_elems(size, n)
    good = good.reshape(-1)
    first = slice(0, min(chunk, size))
    dropped = good.clone()
    parts = [x.reshape(-1)[first] for x in xs]
    parts[-1] = torch.zeros_like(parts[-1])
    dropped[first] = C._ring_sum(parts, 0)
    faults = [("hop left out", dropped)]
    width = min(chunk, size - chunk)
    if width > 0:
        misrouted = good.clone()
        misrouted[:width] = good[chunk:chunk + width]
        misrouted[chunk:chunk + width] = good[:width]
        faults.insert(0, ("chunk misrouted", misrouted))
    return faults


def _slices(size: int, step: int = 1 << 24):
    """Slices of 2^24 values, so f64 temporaries of a large payload stay small."""
    return [slice(i, min(size, i + step)) for i in range(0, size, step)]


def fused_tolerance(xs: Sequence[torch.Tensor], scheme: str) -> float:
    """Largest error a fused-codec ring sum of `xs` may show against the
    exact sum: the bound of the JAX package's tests
    (tests/unit/test_pallas_collectives.py `_fused_tolerance` for int8:
    every hop rounds the travelling partial by at most its absmax over
    2 * 127, plus one all-gather quantization, times 2; for fp8, 2 * n *
    the largest partial * 2^-3)."""
    flats = [x.reshape(-1) for x in xs]
    n, partial_max, sum_max = len(xs), 0.0, 0.0
    for s in _slices(flats[0].numel()):
        partial = flats[0][s].double()
        partial_max = max(partial_max, partial.abs().max().item())
        for f in flats[1:]:
            partial_max = max(partial_max, partial.add_(f[s]).abs().max().item())
        sum_max = max(sum_max, partial.abs().max().item())
    if scheme == "fp8":
        return 2.0 * n * partial_max * 2 ** -3
    return 2.0 * ((n - 1) * partial_max + sum_max) / (2 * 127.0)


def _max_err(got: torch.Tensor, xs: Sequence[torch.Tensor], scale: float) -> float:
    """max |got - scale * (exact sum of xs)|, the sum taken in f64."""
    flats, g = [x.reshape(-1) for x in xs], got.reshape(-1)
    worst = 0.0
    for s in _slices(g.numel()):
        exact = flats[0][s].double()
        for f in flats[1:]:
            exact.add_(f[s])
        worst = max(worst, (g[s].double() - exact.mul_(scale)).abs().max().item())
    return worst


def planted_fused_faults(xs: Sequence[torch.Tensor], cfg, good: torch.Tensor
                         ) -> List[Tuple[str, torch.Tensor]]:
    """The plain fused-ring sum `good` of `xs` with one fault each, in
    chunk 0: the first hop's scales dropped (read as zero: the payload of
    rank 1 decodes to nothing) and the codes of one 256-value block of the
    last reduce-scatter hop zeroed.  A check that accepts either is too
    weak."""
    n, size = len(xs), xs[0].numel()
    chunk = C.fused_chunk_elems(size, n, cfg)
    parts = [C._padded_chunks(x.float(), n, chunk)[0] for x in xs]

    def chunk0(fault: str) -> torch.Tensor:
        q = quantize(parts[1 % n], cfg)
        if fault == "scales":
            q = QTensor(q.data, torch.zeros_like(q.scale))
        for k in range(2, n):
            q = quantize(add_dequantized(parts[k], q), cfg)
        if fault == "codes":
            data = q.data.clone()
            data.view(-1)[:256] = 0
            q = QTensor(data, q.scale)
        return dequantize(quantize(add_dequantized(parts[0], q), cfg))

    faults = []
    for name, fault in (("scales of a hop dropped", "scales"),
                        ("codes of a 256-value block zeroed", "codes")):
        bad = good.clone().reshape(-1)
        width = min(chunk, size)
        bad[:width] = chunk0(fault)[:width].to(bad.dtype)
        faults.append((name, bad.view(good.shape)))
    return faults


def _median_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, iters: int) -> float:
    """Median host time of one call (the wrapper's issue, up to the
    kernel's launch), the card idle between calls."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _bound_ms(n: int, sends: Dict[str, float], memory: Dict[str, float],
              own_cards: bool) -> Dict[str, float]:
    """Least time of each function in ms: max(NVLink bytes a rank sends,
    device-memory bytes of one card's ranks)."""
    ranks_per_card = 1 if own_cards else n
    out = {}
    for k in ("rs", "ag", "ar"):
        t_link = sends[k] / NVLINK_BYTES_PER_S if own_cards else 0.0
        t_mem = ranks_per_card * memory[k] / HBM_BYTES_PER_S
        out[k] = max(t_link, t_mem) * 1e3
    return out


def _bounds(n: int, size: int, row: int, itemsize: int, own_cards: bool) -> Dict[str, float]:
    """Bounds of B5, B6 and their all-reduce: a rank sends (n - 1) chunks
    per kernel and reads and writes its input and output once."""
    chunk = -(-row // C.TILE) * C.TILE
    per_kernel = (n - 1) * itemsize
    sends = {"rs": per_kernel * chunk, "ag": per_kernel * chunk,
             "ar": 2 * per_kernel * C._chunk_elems(size, n)}
    memory = {"rs": (n * row + row) * itemsize, "ag": (row + n * row) * itemsize,
              "ar": 2 * size * itemsize}
    return _bound_ms(n, sends, memory, own_cards)


def fused_bounds(n: int, size: int, cfg, own_cards: bool) -> Dict[str, float]:
    """Bounds of B7, B8 and their all-reduce on `size` f32 values: a rank
    sends (n - 1) chunks of codes and scales per kernel; B7 reads the
    payload and writes its chunk, B8 reads the chunk and writes the result,
    in f32."""
    chunk = C.fused_chunk_elems(size, n, cfg)
    wire = (n - 1) * (chunk + chunk // cfg.block * 4)
    sends = {"rs": wire, "ag": wire, "ar": 2 * wire}
    memory = {"rs": 4 * (size + chunk), "ag": 4 * (chunk + size), "ar": 4 * 2 * size}
    return _bound_ms(n, sends, memory, own_cards)


def check_fused_case(scheme: str, size: int, n: int, d: int, seed: int, device, iters: int,
                     faults: bool, own_cards: bool) -> Dict:
    cfg = comp_config.resolve(scheme)
    xs = make_inputs(n, size, torch.float32, seed, device)
    chunk = C.fused_chunk_elems(size, n, cfg)
    res: Dict = {"dtype": scheme, "size": size, "chunk": chunk}
    ok, err = {}, {}
    tol = fused_tolerance(xs, scheme)
    for op in ("sum", "mean"):
        got = RC.fused_ring_all_reduce(xs[d], None, cfg, op)
        want = C._plain_fused_ring_all_reduce(xs, cfg, op)[d]
        ok[f"fused_{op}"] = bool(torch.equal(got, want))
        err[f"fused_{op}"] = max((got[s] - want[s]).abs().max().item()
                                 for s in _slices(size))
        scale = 1.0 / n if op == "mean" else 1.0
        err[f"fused_{op} vs exact"] = _max_err(got, xs, scale)
        ok[f"fused_{op} within tolerance"] = err[f"fused_{op} vs exact"] <= tol * scale
        if op == "sum" and faults and size <= FAULT_CASE_MAX:
            for fault, bad in planted_fused_faults(xs, cfg, want):
                ok[f"rejects {fault}"] = not torch.equal(got, bad)
        del got, want
    res.update(ok=ok, max_abs_err=err, tolerance=tol)
    if device.type == "cuda":
        flat = xs[d]
        mine = RC._fused_rs(flat, cfg, chunk, None)
        calls = {"rs": lambda: RC._fused_rs(flat, cfg, chunk, None),
                 "ag": lambda: RC._fused_ag(mine, cfg, chunk, size, None),
                 "ar": lambda: RC.fused_ring_all_reduce(flat, None, cfg, "mean")}
        dist.barrier()
        res["ms"] = {k: _median_ms(fn, iters) for k, fn in calls.items()}
        dist.barrier()
        if d == 0:
            res["plain_ms"] = {"ar": _median_ms(
                lambda: C._plain_fused_ring_all_reduce(xs, cfg, "mean"), iters)}
        dist.barrier()
        res["library_ms"] = None
        res["library_note"] = "NCCL has no quantized all-reduce"
        if own_cards:
            row = size // n
            rs_out = torch.empty(row, device=device)
            ag_out = torch.empty(n * row, device=device)
            x_rs = flat[:n * row].view(n, row)
            ctx = {"rs": lambda: dist.reduce_scatter_tensor(rs_out, x_rs),
                   "ag": lambda: dist.all_gather_into_tensor(ag_out, flat[:row])}
            res["nccl_f32_ms"] = {k: _median_ms(fn, iters) for k, fn in ctx.items()}
        res["bound_ms"] = fused_bounds(n, size, cfg, own_cards)
        res["bound_note"] = ("NVLink bytes of codes and scales each rank sends vs device "
                             "bytes of its card" if own_cards
                             else f"device bytes of all {n} ranks on one card")
    return res


def check_case(name: str, size: int, n: int, d: int, seed: int, device, iters: int,
               faults: bool, own_cards: bool) -> Dict:
    if name in SCHEMES:
        return check_fused_case(name, size, n, d, seed, device, iters, faults, own_cards)
    dtype = DTYPES[name]
    xs = make_inputs(n, size, dtype, seed, device)
    row = size // n
    x_rs = [x[:n * row].view(n, row) for x in xs]
    x_ag = [x[:row] for x in xs]
    res: Dict = {"dtype": name, "size": size, "row": row, "chunk": C._chunk_elems(size, n)}
    ok, err = {}, {}

    def record(key, got, want):
        ok[key] = bool(torch.equal(got, want))
        err[key] = (got.float() - want.float()).abs().max().item() if got.shape == want.shape \
            else float("inf")

    record("rs", RC.ring_reduce_scatter(x_rs[d]), C._plain_ring_reduce_scatter(x_rs)[d])
    record("ag", RC.ring_all_gather(x_ag[d]), C._plain_ring_all_gather(x_ag)[d])
    got = RC.ring_all_reduce(xs[d])
    want = C._plain_ring_all_reduce(xs)[d]
    record("ar_sum", got, want)
    if faults and size <= FAULT_CASE_MAX:
        for fault, bad in planted_faults(xs, want):
            ok[f"rejects {fault}"] = not torch.equal(got, bad)
    del got
    record("ar_mean", RC.ring_all_reduce(xs[d], op="mean"), want * (1.0 / n))
    del want
    res.update(ok=ok, max_abs_err=err)
    if device.type == "cuda":
        calls = {"rs": lambda: RC.ring_reduce_scatter(x_rs[d]),
                 "ag": lambda: RC.ring_all_gather(x_ag[d]),
                 "ar": lambda: RC.ring_all_reduce(xs[d], op="mean")}
        dist.barrier()
        res["ms"] = {k: _median_ms(fn, iters) for k, fn in calls.items()}
        res["host_ms"] = {k: _host_ms(fn, iters) for k, fn in calls.items()}
        dist.barrier()
        if d == 0:
            plain = {"rs": lambda: C._plain_ring_reduce_scatter(x_rs),
                     "ag": lambda: C._plain_ring_all_gather(x_ag),
                     "ar": lambda: C._plain_ring_all_reduce(xs, op="mean")}
            res["plain_ms"] = {k: _median_ms(fn, iters) for k, fn in plain.items()}
        dist.barrier()
        if own_cards:
            rs_out = torch.empty(row, dtype=dtype, device=device)
            ag_out = torch.empty(n * row, dtype=dtype, device=device)
            ar_buf = xs[d].clone()
            lib = {"rs": lambda: dist.reduce_scatter_tensor(rs_out, x_rs[d]),
                   "ag": lambda: dist.all_gather_into_tensor(ag_out, x_ag[d]),
                   "ar": lambda: dist.all_reduce(ar_buf)}
            res["library_ms"] = {k: _median_ms(fn, iters) for k, fn in lib.items()}
        else:
            res["library_ms"] = None
            res["library_note"] = ("NCCL refuses two ranks of one communicator on one card: "
                                   "no library time with ranks sharing a card")
        res["bound_ms"] = _bounds(n, size, row, xs[0].element_size(), own_cards)
        res["bound_note"] = ("NVLink bytes each rank sends vs device bytes of its card"
                             if own_cards else f"device bytes of all {n} ranks on one card")
    return res


def parse_groups(spec: str) -> List[Tuple[str, List[int]]]:
    """`dtype:row+row+...;...` -> [(dtype, rows)]: each a group of tensors
    of `row` values a rank's chunk (f32 or bf16)."""
    groups = []
    for item in filter(None, spec.split(";")):
        name, rows = item.split(":")
        if name not in DTYPES:
            raise ValueError(f"group {item!r}: dtype must be one of {sorted(DTYPES)}")
        groups.append((name, [int(r) for r in rows.split("+")]))
    return groups


def planted_group_faults(xs: Sequence[Sequence[torch.Tensor]], good: Sequence[torch.Tensor],
                         op: str, d: int) -> List[Tuple[str, List[torch.Tensor]]]:
    """The plain per-tensor results `good` of a group on rank d with one
    fault each: the largest tensor shifted by one 16-byte vector (an
    offset off by one), the last tensor's last value changed (a partial
    vector dropped), and for the reduce-scatter the first tensor summed
    without the last rank's part (a hop left out).  xs[i] is every rank's
    input of tensor i.  A check that accepts any of them is too weak."""
    vec = 16 // good[0].element_size()
    big = max(range(len(good)), key=lambda i: good[i].numel())
    shifted = list(good)
    shifted[big] = torch.roll(good[big], vec, dims=-1)
    tail = list(good)
    tail[-1] = good[-1].clone()
    tail[-1].view(-1)[-1] = good[-1].view(-1)[-1] + 1
    faults = [("a tensor shifted by a vector", shifted), ("a last value wrong", tail)]
    if op == "rs":
        parts = [x[d] for x in xs[0]]
        parts[-1] = torch.zeros_like(parts[-1])
        dropped = list(good)
        dropped[0] = C._ring_sum(parts, d)
        faults.append(("a hop left out", dropped))
    return faults


def _grid_ms(calls, cap: int, iters: int) -> Dict[str, float]:
    """Each call's median time with the ring kernels' grid capped at `cap`
    blocks (every rank the same cap)."""
    blocks = RC._blocks
    RC._blocks = lambda chunk, itemsize, max_blocks: blocks(chunk, itemsize,
                                                            min(cap, max_blocks))
    try:
        dist.barrier()
        return {k: _median_ms(fn, iters) for k, fn in calls.items()}
    finally:
        RC._blocks = blocks


def check_group(name: str, rows: Sequence[int], n: int, d: int, seed: int, device, iters: int,
                faults: bool, own_cards: bool, grids: Sequence[int] = ()) -> Dict:
    """One group through ring_reduce_scatter_group and
    ring_all_gather_group: every tensor bit-equal to its stacked plain
    version, the launches those of `segment_plan` within the slots; on a
    card their times (also at each grid cap of `grids`), the stacked plain
    versions', NCCL's on the packed chunks where every rank has a card,
    and the bound."""
    dtype = DTYPES[name]
    xs = [[x.view(n, row) for x in make_inputs(n, n * row, dtype, seed + 7919 * i, device)]
          for i, row in enumerate(rows)]  # xs[i][r]: rank r's (n, row) of tensor i
    mine = [[x[0] for x in per_rank] for per_rank in xs]  # rank r's chunk of tensor i
    want = {"rs": [C._plain_ring_reduce_scatter(x)[d] for x in xs],
            "ag": [C._plain_ring_all_gather(x)[d] for x in mine]}
    calls = {"rs": lambda: RC.ring_reduce_scatter_group([x[d] for x in xs]),
             "ag": lambda: RC.ring_all_gather_group([x[d] for x in mine])}
    kernels = {"rs": RC.RING_RS, "ag": RC.RING_AG}
    itemsize = dtype.itemsize
    total = sum(RC._seg_bytes(row, itemsize) for row in rows)
    res: Dict = {"dtype": name, "group": list(rows), "segments": len(rows),
                 "chunk_bytes": total}
    ok, err, launches = {}, {}, {}
    for op, call in calls.items():
        before = kernels[op].launches
        got = call()
        launches[op] = kernels[op].launches - before
        ok[op] = all(torch.equal(g, w) for g, w in zip(got, want[op]))
        err[op] = max((g.float() - w.float()).abs().max().item() if g.numel() else 0.0
                      for g, w in zip(got, want[op]))
        if faults:
            for fault, bad in planted_group_faults(xs if op == "rs" else [mine], want[op], op, d):
                ok[f"{op} rejects {fault}"] = not all(torch.equal(g, b) for g, b in zip(got, bad))
        del got
    if device.type == "cuda":
        ws = RC.peer_memory.workspace(None, device)
        runs = len(RC.segment_plan([(row, dtype) for row in rows], ws.slot_bytes["rs"]))
        ok["launches"] = launches == {"rs": runs, "ag": runs}
        res["expected_launches"] = runs
    res.update(ok=ok, max_abs_err=err, launches=launches)
    if device.type == "cuda":
        dist.barrier()
        res["ms"] = {k: _median_ms(fn, iters) for k, fn in calls.items()}
        res["host_ms"] = {k: _host_ms(fn, iters) for k, fn in calls.items()}
        res["grid_ms"] = {str(cap): _grid_ms(calls, cap, iters) for cap in grids}
        dist.barrier()
        if d == 0:
            plain = {"rs": lambda: [C._plain_ring_reduce_scatter(x) for x in xs],
                     "ag": lambda: [C._plain_ring_all_gather(x) for x in mine]}
            res["plain_ms"] = {k: _median_ms(fn, iters) for k, fn in plain.items()}
        dist.barrier()
        if own_cards:  # NCCL on the same payload: the group's chunks packed
            width = total // itemsize
            packed = torch.zeros(n, width, dtype=dtype, device=device)
            rs_out = torch.empty(width, dtype=dtype, device=device)
            ag_out = torch.empty(n * width, dtype=dtype, device=device)
            lib = {"rs": lambda: dist.reduce_scatter_tensor(rs_out, packed),
                   "ag": lambda: dist.all_gather_into_tensor(ag_out, packed[0])}
            res["library_ms"] = {k: _median_ms(fn, iters) for k, fn in lib.items()}
            res["library_note"] = "NCCL on the group's chunks packed into one tensor"
        else:
            res["library_ms"] = None
            res["library_note"] = ("NCCL refuses two ranks of one communicator on one card: "
                                   "no library time with ranks sharing a card")
        sends = {k: (n - 1) * total for k in ("rs", "ag", "ar")}
        memory = {k: sum((n * row + row) * itemsize for row in rows) for k in ("rs", "ag", "ar")}
        bounds = _bound_ms(n, sends, memory, own_cards)
        res["bound_ms"] = {k: bounds[k] for k in ("rs", "ag")}
        res["bound_note"] = ("NVLink bytes each rank sends vs device bytes of its card"
                             if own_cards else f"device bytes of all {n} ranks on one card")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="f32:1000003,bf16:4099")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--groups", default="",
                    help="groups through the grouped B5/B6: dtype:row+row+... separated by ;")
    ap.add_argument("--grid", default="",
                    help="also time each group with the grid capped at each of these block "
                    "counts, comma-separated (a measurement: the wrappers take one block an SM)")
    args = ap.parse_args(argv)
    n = distributed.init_distributed(device=args.device)
    if n < 2:
        print("ring_check: needs a group of 2 or more ranks (start it with "
              "python -m kungfu_tpu_torch.run -np N)", file=sys.stderr)
        return 2
    d = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    own_cards = dist.get_backend() == "nccl"
    for k in RC.KERNELS:
        k.launches = 0
    cases = []
    for name, size in parse_cases(args.cases):
        cases.append(check_case(name, size, n, d, args.seed, device, args.iters, args.faults,
                                own_cards))
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the ranks of one card share its memory
    for name, rows in parse_groups(args.groups):
        cases.append(check_group(name, rows, n, d, args.seed, device, args.iters, args.faults,
                                 own_cards, [int(g) for g in args.grid.split(",") if g]))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {"rank": d, "n": n, "device": str(device), "backend": dist.get_backend(),
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "cases": cases, "launches": {k.name: k.launches for k in RC.KERNELS},
           "ok": all(all(c["ok"].values()) for c in cases)}
    print(LINE + json.dumps(out), flush=True)
    distributed.shutdown_distributed()
    return 0 if out["ok"] else 1


def launch(n: int, worker: Sequence[str], env: Optional[Dict[str, str]] = None,
           timeout: float = 600, tag: str = LINE) -> Tuple[int, str, Dict[int, Dict]]:
    """Run `worker` on n ranks through `python -m kungfu_tpu_torch.run`;
    returns (exit code, the launcher's output, {rank: the JSON of its line
    that starts with `tag`})."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    e = dict(os.environ if env is None else env)
    e["PYTHONPATH"] = repo + (os.pathsep + e["PYTHONPATH"] if e.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.run", "-np", str(n),
                           *worker], cwd=repo, env=e, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=timeout)
    results = {}
    for line in proc.stdout.splitlines():
        m = re.match(r"^\[(\d+)\] " + re.escape(tag) + r"(.*)$", line)
        if m:
            results[int(m.group(1))] = json.loads(m.group(2))
    return proc.returncode, proc.stdout, results


if __name__ == "__main__":
    sys.exit(main())
