"""Time the flash kernels at the flagship attention shape on one card.

    python -m kungfu_tpu_torch.tools.flash_time [--iters 20] [--repeats 3] [--head-dim 64]

Builds the kernels of the checkout it runs from, then times each kernel's
wrapper at B=8, H=16, L=2048, D=64, bf16, causal (`--head-dim D` keeps the
width H * D = 1024: D=128 runs H=8): the forward, dq and the MHA dk/dv
kernel (B3), and, where the checkout has it, the GQA dk/dv kernel (B4) at
Hkv=H/2.  Beside them, as yardsticks the port never calls, it times
PyTorch's scaled_dot_product_attention on the same inputs: its forward,
its backward (dq, dk and dv in one call) and its GQA backward
(enable_gqa=True).  Each reading is the mean of `--iters` back-to-back
launches (CUDA events); every kernel is read `--repeats` times, in turn.
Before timing, each kernel's output is held against its plain version on
the same inputs (normwise relative error, worst 64-row block, against
utils.compare.REL_LIMIT; the forward's lse against LSE_ATOL), and the run
exits non-zero if one fails.  Prints the card's name and power limit, then
one JSON line with the readings, each kernel's bound (the larger of its
FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s), its best reading's
TFLOP/s and its check.  To compare two versions of a kernel, run it from
both checkouts in one call to the card, in the order old, new, new, old.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
PEAK_BYTES_PER_S = 3.35e12


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


def check_kernels(flash, scale, mha, gqa):
    """Each kernel's outputs against its plain version on the same inputs:
    {kernel: {"worst_block": x, "limit": y, "ok": bool}} (the forward's
    lse by its largest absolute error too)."""
    from ..utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

    out = {}
    for gqa_inputs, (q, k, v, do, lse, delta) in ((False, mha), (True, gqa)):
        tag = "_gqa" if gqa_inputs else ""
        limit = REL_LIMIT[q.dtype]
        o, lse_k = flash.flash_fwd(q, k, v, scale, True)
        o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, 0)
        lse_err = (lse_k - lse_ref).abs().max().item()
        worst = rel_errs(o, o_ref)[1]
        out["flash_fwd" + tag] = {"worst_block": round(worst, 6), "limit": limit,
                                  "lse_err": round(lse_err, 6),
                                  "ok": worst <= limit and lse_err <= LSE_ATOL}
        del o_ref, lse_ref
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)
        refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0)
        for name, w in (("flash_bwd_dq" + tag, rel_errs(dq, refs[0])[1]),
                        ("flash_bwd_dkv" + tag, max(rel_errs(dk, refs[1])[1],
                                                    rel_errs(dv, refs[2])[1]))):
            out[name] = {"worst_block": round(w, 6), "limit": limit, "ok": w <= limit}
        del refs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--head-dim", type=int, default=64)
    args = ap.parse_args(argv)
    from ..ops import flash

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no reading")
    B, L, D, dtype = 8, 2048, args.head_dim, torch.bfloat16
    H = 1024 // D
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(hkv):
        q, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(B, L, hkv, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        o, lse = flash.flash_fwd(q, k, v, scale, True)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, delta

    def sdpa_bwd(q, k, v, do, gqa):
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        qg, kg, vg = (x.requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=gqa)
        return lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)

    q, k, v, do, lse, delta = inputs(H)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fns = {
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, scale, True),
        "flash_bwd_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True),
        "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        "sdpa_bwd": sdpa_bwd(q, k, v, do, False),
    }
    g = inputs(H // 2)
    if hasattr(flash, "FLASH_BWD_DKV_GQA"):
        fns["flash_bwd_dkv_gqa"] = lambda: flash.flash_bwd_dkv(*g, scale, True)
    fns["sdpa_bwd_gqa"] = sdpa_bwd(*g[:4], True)
    checks = check_kernels(flash, scale, (q, k, v, do, lse, delta), g)
    ms = {name: [] for name in fns}
    for _ in range(args.repeats):
        for name, fn in fns.items():
            ms[name].append(round(time_ms(fn, args.iters), 4))

    pairs = B * H * L * (L + 1) // 2  # causal (query, key) pairs
    act, row = B * L * H * D * 2, B * H * L * 4
    work = {  # (FLOPs, bytes: each input read once, each output written once)
        "flash_fwd": (4 * D * pairs, 4 * act + row),
        "flash_bwd_dq": (6 * D * pairs, 5 * act + 2 * row),
        "flash_bwd_dkv": (8 * D * pairs, 6 * act + 2 * row),
        "flash_bwd_dkv_gqa": (8 * D * pairs, 4 * act + 2 * row),
    }
    bound = {n: round(max(f / PEAK_FLOPS, b / PEAK_BYTES_PER_S) * 1e3, 4)
             for n, (f, b) in work.items() if n in ms}
    tflops = {n: round(work[n][0] / min(ms[n]) / 1e9, 1) for n in bound}
    print(json.dumps({"card": card, "shape": {"B": B, "H": H, "L": L, "D": D, "dtype": "bf16",
                                              "causal": True, "Hkv_gqa": H // 2},
                      "ms": ms, "bound_ms": bound, "tflops": tflops, "check": checks}))
    return 0 if all(c["ok"] for c in checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
