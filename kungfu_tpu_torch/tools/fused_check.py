"""The all-gather-matmul (B9) and matmul-reduce-scatter (B10) kernels
against their stacked plain versions, run as one rank.

    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.fused_check \\
        [--mlp 4096,1024,4096] [--faults] [--iters 5] [--seed 0] [--device cpu]

The shapes are those of the flagship's MLP up projection in an FSDP step
with `--mlp T,D,F` (tokens a rank, d_model, d_ff; by default 2 x 2048
tokens, 1024, 4096), in bf16:

  b9   the forward: x [T, D] @ the gathered W_in [D, F], each rank holding
       a shard [D/n, F]
  b10  the gradient of W_in: x = activations^T [D, T], w = dy [T, F]; rank
       d gets rows [d D/n, (d+1) D/n) of the sum over the ranks

plus one f32 case of each at the JAX tests' shapes that tile nothing
(tests/unit/test_fused_matmul.py: B9 x [24, n*40] with shards [40, 72],
B10 x [24, 40] @ [40, 72]).  Every rank makes every rank's operands from
the seed with numpy, so the check needs no communication, and holds its
own result against its row of the stacked plain version (`ops.
fused_matmul._plain_all_gather_matmul`, `_plain_matmul_reduce_scatter`):

  int   integer-valued operands (-3 .. 3): every f32 product and partial
        is exact, so the result must match bit for bit, and a shard routed
        to the wrong place or a hop added twice cannot hide in a tolerance
  rand  normal operands: the normwise relative error over 64-row blocks
        within `utils.compare.REL_LIMIT` of the dtype (bf16 1e-2: the output
        rounded to bf16 on both sides after f32 sums in other orders)

`--faults` plants two faults in the plain version and shows that both
comparisons reject each: B9 consuming one hop's shard twice (hop 2's
products taken with hop 1's shard), and B10 dropping one incoming partial
(the one from hop 0).

On a card each kernel is then timed on the random bf16 operands.  With a
card per rank, the median of `--iters` calls between CUDA events; with
ranks sharing a card, which runs them in turn, the wall time of `--iters`
calls of all ranks between barriers taken after a device sync, per call.
Rank 0 alone times the stacked plain version (every rank's result in one
process).  Where every rank has a card of its own (an NCCL group), every
rank also times the unfused library arm, a yardstick the port never calls:
`all_gather_into_tensor` of the shard then `torch.matmul` (B9), and
`torch.matmul` then `reduce_scatter_tensor` of the f32 partial (B10).  The
bound is the larger of two times: the operations of a rank's product
(2 T D F) over the card's peak for the dtype (all ranks' products where
they share a card), and the bytes a rank sends over 450 GB/s of NVLink
each way (between cards: (n - 1) shards for B9, (n - 1) f32 partials for
B10).

Prints one line `FUSED_CHECK {json}` and exits non-zero when a check
failed.  Start it with `ring_check.launch`.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import distributed
from ..ops import fused_matmul as FM
from ..utils.compare import REL_LIMIT, rel_errs
from .ring_check import NVLINK_BYTES_PER_S, _median_ms
from .shift_check import _span_ms

LINE = "FUSED_CHECK "
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
SMALL = (24, 40, 72)  # tests/unit/test_fused_matmul.py: M, K (B9: a shard's rows), N


def operands(kind: str, n: int, shapes, dtype: torch.dtype, seed: int, integer: bool,
             device):
    """Every rank's (x, w) of case `kind` (b9: w is the rank's shard),
    rank-major, from numpy's generator."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        a = (rng.integers(-3, 4, size=shape) if integer
             else rng.standard_normal(shape, dtype=np.float32))
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    if kind == "b9":
        m, k, nn = shapes
        return draw((n, m, k)), draw((n, k // n, nn))
    m, k, nn = shapes
    return draw((n, m, k)), draw((n, k, nn))


def fused(kind: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (FM.all_gather_matmul(x, w) if kind == "b9" else FM.matmul_reduce_scatter(x, w))


def plain(kind: str, xs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    return (FM._plain_all_gather_matmul(xs, ws) if kind == "b9"
            else FM._plain_matmul_reduce_scatter(xs, ws))


def planted_fault(kind: str, xs: torch.Tensor, ws: torch.Tensor, d: int) -> torch.Tensor:
    """Rank d's result of a faulty kernel: B9 taking hop min(2, n-1)'s
    products with the previous hop's shard; B10 without hop 0's partial."""
    n = xs.shape[0]
    if kind == "b9":
        k = min(2, n - 1)
        shards = list(ws)
        shards[(d - k) % n] = ws[(d - k + 1) % n]
        return FM._hop_sum(xs[d], shards, d)
    parts = [FM._chunk_products(xs[r], ws[r], n)[d] for r in range(n)]
    parts[(d + 1) % n] = torch.zeros_like(parts[0])
    return FM.C._ring_sum(parts, d).to(xs.dtype)


def _rel(got: torch.Tensor, want: torch.Tensor):
    return rel_errs(got[None, :, None, :], want[None, :, None, :])


def check(kind: str, n: int, d: int, shapes, dtype, seed: int, device, faults: bool) -> Dict:
    """Both payloads of one case on rank d: {check: passed}, max abs errors."""
    ok, err, rel = {}, {}, {}
    for integer in (True, False):
        key = f"{kind} {str(dtype).split('.')[-1]} {'int' if integer else 'rand'}"
        xs, ws = operands(kind, n, shapes, dtype, seed + integer, integer, device)
        got = fused(kind, xs[d], ws[d])
        want = plain(kind, xs, ws)[d]
        err[key] = (got.float() - want.float()).abs().max().item()
        whole, worst = _rel(got, want)
        rel[key] = worst
        ok[key] = (torch.equal(got, want) if integer else worst <= REL_LIMIT[dtype])
        if faults:
            bad = planted_fault(kind, xs, ws, d)
            name = "a shard consumed twice" if kind == "b9" else "a partial dropped"
            ok[f"{key} rejects {name}"] = not (
                torch.equal(bad, want) if integer else _rel(bad, want)[1] <= REL_LIMIT[dtype])
    return {"ok": ok, "max_abs_err": err, "worst_block_rel_err": rel}


def bound(kind: str, n: int, shapes, dtype, own_cards: bool):
    """(ms, what bounds it) of one call on every rank."""
    m, k, nn = shapes
    flops = 2.0 * m * k * nn * (1 if own_cards else n)
    sent = (n - 1) * (k // n * nn * torch.finfo(dtype).bits // 8 if kind == "b9"
                      else m // n * nn * 4)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_link = sent / NVLINK_BYTES_PER_S if own_cards else 0.0
    return max(t_ops, t_link) * 1e3, ("operations" if t_ops >= t_link else "bytes")


def library(kind: str, x: torch.Tensor, w: torch.Tensor, n: int):
    """The unfused NCCL arm of one rank (a card per rank)."""
    if kind == "b9":
        full = torch.empty((n * w.shape[0], w.shape[1]), dtype=w.dtype, device=w.device)

        def run():
            dist.all_gather_into_tensor(full, w)
            return torch.matmul(x, full)
        return run
    out = torch.empty((x.shape[0] // n, w.shape[1]), dtype=torch.float32, device=x.device)

    def run():
        dist.reduce_scatter_tensor(out, torch.matmul(x, w).float())
        return out.to(x.dtype)
    return run


def time_case(kind: str, n: int, d: int, shapes, dtype, seed: int, device, iters: int,
              own_cards: bool) -> Dict:
    xs, ws = operands(kind, n, shapes, dtype, seed, False, device)
    x, w = xs[d], ws[d]
    dist.barrier()
    res = {"ms": (_median_ms(lambda: fused(kind, x, w), iters) if own_cards
                  else _span_ms(lambda: fused(kind, x, w), iters, device)),
           "how": (f"median of {iters} calls between CUDA events" if own_cards else
                   f"wall time of {iters} calls of all ranks between barriers, per call")}
    dist.barrier()
    if d == 0:
        res["plain_ms"] = _median_ms(lambda: plain(kind, xs, ws), max(2, iters // 2))
    dist.barrier()
    if own_cards:
        res["library_ms"] = _median_ms(library(kind, x, w, n), iters)
    else:
        res["library_ms"] = None
        res["library_note"] = ("NCCL refuses two ranks of one communicator on one card: no "
                               "library time with ranks sharing a card")
    res["bound_ms"], res["bound_by"] = bound(kind, n, shapes, dtype, own_cards)
    res["shapes"] = list(shapes)
    return res


def mlp_shapes(mlp: Sequence[int], n: int):
    """{case: (M, K, N)} of B9 and B10 at the MLP of T tokens, d_model D,
    d_ff F; and the f32 cases at the non-tiling shape."""
    t, dm, ff = mlp
    m, k, nn = SMALL
    return {("b9", torch.bfloat16): (t, dm, ff), ("b10", torch.bfloat16): (dm, t, ff),
            ("b9", torch.float32): (m, n * k, nn), ("b10", torch.float32): (m, k, nn)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mlp", default="4096,1024,4096",
                    help="tokens a rank, d_model, d_ff of the bf16 cases")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = distributed.init_distributed(device=args.device)
    if n < 2:
        print("fused_check: needs a group of 2 or more ranks (start it with "
              "python -m kungfu_tpu_torch.run -np N)", file=sys.stderr)
        return 2
    d = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    own_cards = dist.get_backend() == "nccl"
    cases = mlp_shapes([int(v) for v in args.mlp.split(",")], n)
    for k in FM.KERNELS:
        k.launches = 0
    res: Dict = {"ok": {}, "max_abs_err": {}, "worst_block_rel_err": {}}
    for i, ((kind, dtype), shapes) in enumerate(cases.items()):
        got = check(kind, n, d, shapes, dtype, args.seed + 10 * i, device, args.faults)
        for key in res:
            res[key].update(got[key])
    launches = {k.name: k.launches for k in FM.KERNELS}
    if device.type == "cuda":
        res["timing"] = {kind: time_case(kind, n, d, cases[(kind, torch.bfloat16)],
                                         torch.bfloat16, args.seed + 100, device, args.iters,
                                         own_cards)
                         for kind in ("b9", "b10")}
    out = {"rank": d, "n": n, "device": str(device), "backend": dist.get_backend(),
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "shapes": {f"{kind} {str(dt).split('.')[-1]}": list(s)
                      for (kind, dt), s in cases.items()},
           "launches": launches, **res, "ok_all": all(res["ok"].values())}
    print(LINE + json.dumps(out), flush=True)
    distributed.shutdown_distributed()
    return 0 if out["ok_all"] else 1


if __name__ == "__main__":
    sys.exit(main())
