"""Check and time B9's and B10's product body alone on one card.

    python -m kungfu_tpu_torch.tools.fused_time [--mlp 4096,1024,4096] [--ranks 4]
        [--iters 20] [--repeats 3] [--seed 0]

The body (csrc/mm_sm90.cuh, through `ops.fused_matmul.mm_product`: the
fused kernels with no peers) runs at the shapes the flagship FSDP step's
MLP gives it with `--mlp T,D,F` over `--ranks` n ranks, in bf16:

  b9 hop    x [T, D/n] @ a shard [D/n, F]       B9's tiling, one hop
  b9 rank   x [T, D] @ W_in [D, F]              B9's tiling, a rank's n hops
  b10 hop   a chunk [D/n, T] @ dy [T, F]        B10's tiling, one hop
  b10 rank  activations^T [D, T] @ dy [T, F]    B10's tiling, a rank's n hops

Each is first held against the product in f32 (`x.float() @ w.float()`,
TF32 off) on the same inputs: integer-valued operands (-3 .. 3) with f32
out bit for bit (every product and sum is exact), normal ones with bf16 out
within `utils.compare.REL_LIMIT` (the output rounded to bf16 on both sides
after f32 sums in other orders).  Then the bf16-out product is timed beside
`torch.matmul` of the same operands (bf16 out: one PyTorch call, a
yardstick the port never calls) and the bound (the larger of 2 M N K over
989 TFLOP/s and the bytes of x, w and out over 3.35 TB/s).  Each reading
is the mean of `--iters` back-to-back calls between CUDA events (host time
included where the host issues slower than the card runs); every function
is read `--repeats` times, in turn, then once more under torch.profiler
for its kernels' device time alone.  A checkout without the
product entry (before it existed) reports the kernel as null and times the
rest.  Prints the card's name and power limit, then one line
`FUSED_TIME {json}`; exits non-zero when a check failed.  To compare two
versions of the body, run it from both checkouts in one call to the card,
old, new, new, old.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import _build
from ..ops import fused_matmul as FM
from ..utils.compare import REL_LIMIT, rel_errs
from .flash_time import time_ms

LINE = "FUSED_TIME "
PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
PEAK_BYTES_PER_S = 3.35e12


def shapes(mlp: Sequence[int], n: int) -> Dict[str, tuple]:
    """{case: (kind, M, K, N)} of the body at the MLP of T tokens, d_model
    D, d_ff F over n ranks."""
    t, dm, ff = mlp
    return {"b9 hop": ("b9", t, dm // n, ff), "b9 rank": ("b9", t, dm, ff),
            "b10 hop": ("b10", dm // n, t, ff), "b10 rank": ("b10", dm, t, ff)}


def bound_ms(m: int, k: int, nn: int) -> float:
    return max(2.0 * m * k * nn / PEAK_FLOPS,
               2.0 * (m * k + k * nn + m * nn) / PEAK_BYTES_PER_S) * 1e3


def operands(m: int, k: int, nn: int, seed: int, integer: bool, device):
    rng = np.random.default_rng(seed)

    def draw(shape):
        a = (rng.integers(-3, 4, size=shape) if integer
             else rng.standard_normal(shape, dtype=np.float32))
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=torch.bfloat16)

    return draw((m, k)), draw((k, nn))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return rel_errs(got[None, :, None, :], want[None, :, None, :])[1]


def check(kind: str, m: int, k: int, nn: int, seed: int, device) -> Dict:
    """The body against the f32 product: {"int": exact?, "rand": worst
    block, "ok": both passed}."""
    x, w = operands(m, k, nn, seed, True, device)
    exact = torch.equal(FM.mm_product(x, w, kind, torch.float32), x.float() @ w.float())
    x, w = operands(m, k, nn, seed + 1, False, device)
    worst = _rel(FM.mm_product(x, w, kind, torch.bfloat16),
                 (x.float() @ w.float()).to(torch.bfloat16))
    return {"int_exact": exact, "rand_worst_block": worst,
            "ok": exact and worst <= REL_LIMIT[torch.bfloat16]}


def device_ms(fn, iters: int) -> Optional[float]:
    """Device time per call of fn() from torch.profiler: the sum of the
    device time of every kernel it ran over `iters` calls, per call (host
    time between launches left out); None where the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / iters / 1e3 if total_us > 0 else None


def measure(cases: Dict[str, tuple], iters: int, repeats: int, seed: int,
            device) -> Dict[str, Dict]:
    """Each case's check and readings (ms): the body ("kernel", null
    without the entry), torch.matmul ("library"), each one's device time
    from the profiler ("*_device_ms") and the bound."""
    has_entry = "kft_mm_product" in _build.SIGNATURES
    out = {}
    for i, (name, (kind, m, k, nn)) in enumerate(cases.items()):
        res = {"kind": kind, "shape": [m, k, nn], "bound_ms": bound_ms(m, k, nn),
               "bound_by": ("operations" if 2.0 * m * k * nn / PEAK_FLOPS >=
                            2.0 * (m * k + k * nn + m * nn) / PEAK_BYTES_PER_S else "bytes"),
               "kernel_ms": None, "library_ms": []}
        if has_entry:
            res.update(check(kind, m, k, nn, seed + 10 * i, device))
            res["kernel_ms"] = []
        x, w = operands(m, k, nn, seed + 10 * i + 5, False, device)
        for _ in range(repeats):
            if has_entry:
                res["kernel_ms"].append(time_ms(lambda: FM.mm_product(x, w, kind,
                                                                      torch.bfloat16), iters))
            res["library_ms"].append(time_ms(lambda: torch.matmul(x, w), iters))
        res["kernel_device_ms"] = (device_ms(lambda: FM.mm_product(x, w, kind, torch.bfloat16),
                                             iters) if has_entry else None)
        res["library_device_ms"] = device_ms(lambda: torch.matmul(x, w), iters)
        best = min(res["kernel_ms"]) if has_entry else None
        res["kernel_tflops"] = 2.0 * m * k * nn / (best * 1e-3) / 1e12 if best else None
        res["library_tflops"] = 2.0 * m * k * nn / (min(res["library_ms"]) * 1e-3) / 1e12
        out[name] = res
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mlp", default="4096,1024,4096", help="tokens a rank, d_model, d_ff")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_time: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    res = measure(shapes([int(v) for v in args.mlp.split(",")], args.ranks), args.iters,
                  args.repeats, args.seed, torch.device("cuda"))
    ok = all(r.get("ok", True) for r in res.values())
    print(LINE + json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                             "cases": res, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
