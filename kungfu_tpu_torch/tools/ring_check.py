"""The ring kernels against their stacked plain versions, run as one rank.

    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.ring_check \\
        [--cases f32:1000003,bf16:4099] [--iters 5] [--seed 0] [--faults] [--device cpu]

Each case is `dtype:size`.  Every rank makes every rank's input from the
seed on its own device (rank r's is `size` normal values), so the check
needs no communication:

  ring_reduce_scatter  rank r's x is its first n * (size // n) values as
                       (n, size // n)
  ring_all_gather      rank r's x is its first size // n values
  ring_all_reduce      the whole input, op "sum" and op "mean"

and holds its own result against the stacked plain version of
`ops/collective.py` (`_plain_ring_*`), bit for bit.  `--faults` also
plants the faults of `planted_faults` in the cases of at most 16M values
and shows that the comparison rejects each.

On a card each kernel is then timed: the median of `--iters` calls, each
between two CUDA events, on every rank at once.  Rank 0 alone, while the
others wait, times the stacked plain version (which computes every rank's
result in one process).  Where every rank has a card of its own (an NCCL
group), every rank also times NCCL's reduce_scatter_tensor,
all_gather_into_tensor and all_reduce on the same payload, a yardstick the
port never calls.  The bound is the larger of two times: the bytes a rank
sends, (n - 1) * chunk * itemsize per kernel, over 450 GB/s of NVLink each
way (only between cards), and the bytes the ranks of one card read and
write (each input read once, each output written once) over its
3.35 TB/s.

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
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import distributed
from ..ops import collective as C
from ..ops import ring_collectives as RC

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
NVLINK_BYTES_PER_S = 450e9  # one direction, H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
LINE = "RING_CHECK "
FAULT_CASE_MAX = 1 << 24  # planted faults copy the result twice: small cases only


def parse_cases(spec: str) -> List[Tuple[str, int]]:
    cases = []
    for item in spec.split(","):
        name, size = item.split(":")
        if name not in DTYPES:
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


def _bounds(n: int, size: int, row: int, itemsize: int, own_cards: bool) -> Dict[str, float]:
    """Least time of each function in ms: max(NVLink bytes a rank sends,
    device-memory bytes of one card's ranks)."""
    ranks_per_card = 1 if own_cards else n
    chunks = {"rs": -(-row // C.TILE) * C.TILE, "ag": -(-row // C.TILE) * C.TILE,
              "ar": C._chunk_elems(size, n)}
    memory = {"rs": (n * row + row), "ag": (row + n * row), "ar": 2 * size}
    out = {}
    for k in ("rs", "ag", "ar"):
        sends = (n - 1) * chunks[k] * itemsize * (2 if k == "ar" else 1)
        t_link = sends / NVLINK_BYTES_PER_S if own_cards else 0.0
        t_mem = ranks_per_card * memory[k] * itemsize / HBM_BYTES_PER_S
        out[k] = max(t_link, t_mem) * 1e3
    return out


def check_case(name: str, size: int, n: int, d: int, seed: int, device, iters: int,
               faults: bool, own_cards: bool) -> Dict:
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="f32:1000003,bf16:4099")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
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
    cases = [check_case(name, size, n, d, args.seed, device, args.iters, args.faults, own_cards)
             for name, size in parse_cases(args.cases)]
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
