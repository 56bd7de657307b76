"""Time the flash kernels at the flagship attention shape on one card.

    python -m kungfu_tpu_torch.tools.flash_time [--iters 20] [--repeats 3]

Builds the kernels of the checkout it runs from, then times each kernel's
wrapper at B=8, H=16, L=2048, D=64, bf16, causal: the forward, dq and the
MHA dk/dv kernel (B3), and, where the checkout has it, the GQA dk/dv kernel
(B4) at Hkv=8.  Each reading is the mean of `--iters` back-to-back launches
(CUDA events); every kernel is read `--repeats` times, in turn.  Prints the
card's name and power limit, then one JSON line.  To compare two versions
of a kernel, run it from both checkouts in one call to the card, in the
order old, new, new, old.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    from ..ops import flash

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no reading")
    B, H, L, D, dtype = 8, 16, 2048, 64, torch.bfloat16
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(hkv):
        q, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(B, L, hkv, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        o, lse = flash.flash_fwd(q, k, v, scale, True)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, delta

    q, k, v, do, lse, delta = inputs(H)
    fns = {
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, scale, True),
        "flash_bwd_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True),
        "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True),
    }
    if hasattr(flash, "FLASH_BWD_DKV_GQA"):
        g = inputs(H // 2)
        fns["flash_bwd_dkv_gqa"] = lambda: flash.flash_bwd_dkv(*g, scale, True)
    ms = {name: [] for name in fns}
    for _ in range(args.repeats):
        for name, fn in fns.items():
            ms[name].append(round(time_ms(fn, args.iters), 4))
    print(json.dumps({"card": card, "shape": {"B": B, "H": H, "L": L, "D": D, "dtype": "bf16",
                                              "causal": True}, "ms": ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
